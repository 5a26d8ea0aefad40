"""The port's fused scorer (``repro_torch.kernels.mtl_score``) against the
JAX reference, on the CPU: the plain version against the reference's
Pallas kernel in interpret mode, the quantized tables bitwise, the clamp
contract, and the wrapper's checks.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # chip_smoke.py

import jax.numpy as jnp  # noqa: E402

from repro.kernels import mtl_score as jmtl  # noqa: E402
from repro_torch.kernels.mtl_score import (dequantize_codes, ops,  # noqa: E402
                                           quantize_codes)
from repro_torch.kernels.mtl_score.ref import mtl_score_ref  # noqa: E402

# both sides accumulate the same f32 products; only the order differs
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, p, r, m, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((p, r)).astype(np.float32)
    C = rng.standard_normal((m, r)).astype(np.float32)
    ids = rng.integers(0, m, B).astype(np.int32)
    X = rng.standard_normal((B, p)).astype(np.float32)
    return U, C, ids, X


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_bytes(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("B,p,r,m,bb", [
    (64, 32, 4, 20, 32),       # block-aligned
    (50, 64, 4, 37, 16),       # ragged batch (padding path)
    (7, 16, 2, 5, 8),          # single padded block
    (128, 128, 8, 200, 128),   # one full block
])
@pytest.mark.parametrize("code_dtype", ["f32", "int8", "fp8"])
def test_plain_version_matches_jax_kernel(B, p, r, m, bb, code_dtype):
    U, Cf, ids, X = _inputs(B, p, r, m)
    Cj, Sj = jmtl.quantize_codes(Cf, code_dtype)
    want = jmtl.mtl_score(U, Cj, Sj, ids, X, bb=bb)       # interpret mode
    Ct, St = quantize_codes(_t(Cf), code_dtype)
    before = ops.mtl_score.launches
    got = ops.mtl_score(_t(U), Ct, St, _t(ids), _t(X))
    assert ops.mtl_score.launches == before              # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_inputs_match_jax_kernel():
    """bf16 X and U round the same way in both frameworks and are
    accumulated in f32 on both sides."""
    U, Cf, ids, X = _inputs(48, 64, 4, 30, seed=1)
    Cj, Sj = jmtl.quantize_codes(Cf, "f32")
    want = jmtl.mtl_score(jnp.asarray(U, jnp.bfloat16), Cj, Sj, ids,
                          jnp.asarray(X, jnp.bfloat16), bb=16)
    Ct, St = quantize_codes(_t(Cf), "f32")
    got = ops.mtl_score(_t(U).to(torch.bfloat16), Ct, St, _t(ids),
                        _t(X).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("code_dtype", ["f32", "int8", "fp8"])
def test_out_of_range_ids_clamp(code_dtype):
    """The port's contract: ids clamp to [0, m-1], as the reference
    kernel does — held against a clamp oracle and the reference kernel."""
    B, p, r, m = 16, 32, 3, 10
    U, Cf, _, X = _inputs(B, p, r, m, seed=2)
    ids = np.asarray([-3, 0, m - 1, m + 5] * 4, np.int32)
    Ct, St = quantize_codes(_t(Cf), code_dtype)
    got = ops.mtl_score(_t(U), Ct, St, _t(ids), _t(X)).numpy()
    table = dequantize_codes(Ct, St).numpy()
    oracle = np.sum((X @ U) * table[np.clip(ids, 0, m - 1)], axis=1)
    np.testing.assert_allclose(got, oracle, **TOL)
    Cj, Sj = jmtl.quantize_codes(Cf, code_dtype)
    want = jmtl.mtl_score(U, Cj, Sj, ids, X, bb=8)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("code_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_codes_bitwise_equal_to_jax(code_dtype, seed):
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((40, 5)) * 10.0 ** rng.uniform(-3, 3, (40, 1))
         ).astype(np.float32)
    C[[0, 7, 39]] = 0.0                                  # zero rows
    Cj, Sj = jmtl.quantize_codes(C, code_dtype)
    Ct, St = quantize_codes(_t(C), code_dtype)
    assert Ct.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[code_dtype]
    np.testing.assert_array_equal(Ct.view(torch.uint8).numpy(),
                                  _as_bytes(np.asarray(Cj)))
    np.testing.assert_array_equal(_as_bytes(St.numpy()),
                                  _as_bytes(np.asarray(Sj)))
    # zero rows round-trip exactly (scale pinned to 1.0)
    assert not dequantize_codes(Ct, St)[[0, 7, 39]].any()


@pytest.mark.parametrize("rows", [
    [[0.0, 1.1754943508222875e-38]],                     # float32 min normal
    [[-1.1754943508222875e-38, 3e-39], [1e4, -1e4]],     # subnormal entry
    [[127.0 * 1.1754943508222875e-38, 0.0]],             # scale = min normal
])
def test_quantize_int8_bound_at_smallest_magnitudes(rows):
    """The int8 round-trip bound ``|deq - C| <= S/2`` holds for rows whose
    scale ``amax / 127`` is subnormal: torch keeps the subnormal scale (no
    flush to zero) on the CPU and the card, so such a row does not
    dequantize to zeros or NaN."""
    C = np.asarray(rows, np.float32)
    Ct, St = quantize_codes(_t(C), "int8")
    assert bool((St > 0).all())
    err = (dequantize_codes(Ct, St) - _t(C)).abs()
    assert bool(torch.isfinite(err).all())
    assert bool((err <= 0.5 * St + 1e-4 * St).all())


def test_quantize_f32_identity_and_unknown_dtype():
    C = np.random.default_rng(4).standard_normal((8, 4)).astype(np.float32)
    Ct, St = quantize_codes(_t(C), "f32")
    np.testing.assert_array_equal(Ct.numpy(), C)
    assert St.dtype == torch.float32 and bool((St == 1.0).all())
    with pytest.raises(ValueError, match="code_dtype"):
        quantize_codes(_t(C), "int4")


def _valid(r=4, B=6, p=12, m=5):
    U, Cf, ids, X = _inputs(B, p, r, m, seed=5)
    C, S = quantize_codes(_t(Cf), "f32")
    return dict(U=_t(U), C=C, S=S, ids=_t(ids), X=_t(X))


@pytest.mark.parametrize("change,err", [
    (lambda a: _valid(r=9), ValueError),                              # r > 8
    (lambda a: {**a, "ids": a["ids"].long()}, TypeError),
    (lambda a: {**a, "X": a["X"].double()}, TypeError),
    (lambda a: {**a, "C": a["C"].double()}, TypeError),
    (lambda a: {**a, "X": torch.empty(12, 6).T}, ValueError),         # strided
    (lambda a: {**a, "X": a["X"][:5]}, ValueError),                   # B != len(ids)
    (lambda a: {**a, "S": a["S"][:, 0].contiguous()}, ValueError),    # S (m,)
    (lambda a: {k: v.to("meta") for k, v in a.items()}, ValueError),  # no such kernel
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    args = change(_valid())
    with pytest.raises(err):
        ops.mtl_score(args["U"], args["C"], args["S"], args["ids"], args["X"])


def test_plain_version_on_cpu_equals_ref():
    a = _valid()
    np.testing.assert_array_equal(
        ops.mtl_score(a["U"], a["C"], a["S"], a["ids"], a["X"]).numpy(),
        mtl_score_ref(a["U"], a["C"], a["S"], a["ids"], a["X"]).numpy())


# --- the kernel's plan and summation order (csrc/mtl_score.cu) -------------
import score_order  # noqa: E402
from repro_torch.kernels.mtl_score import kernel as skernel  # noqa: E402


@pytest.mark.parametrize("B,plan", [
    (64, (8, 1, 1, 64)),          # a tail wave: 8 warps a row
    (256, (8, 1, 1, 256)),        # the served wave: 256 CTAs
    (4096, (2, 4, 16, 256)),      # 4 rows a warp share U's loads
    (33, (8, 1, 1, 33)),
    (300, (4, 1, 2, 150)),        # 150 CTAs cover the SMs
    (100000, (1, 4, 32, 3125)),
])
def test_plan_at_phase_3_shapes(B, plan):
    """``kernel.plan`` on 132 SMs: 4 rows a warp with the fewest warps a
    row whose CTAs cover the SMs, else one row a warp and the fewest warps
    a row that do, or all 8 warps."""
    pl = skernel.plan(B, 132)
    assert tuple(pl) == plan
    assert pl.rows_per_cta == skernel.WARPS // pl.warps_per_row \
        * pl.rows_per_warp
    assert pl.ctas == -(-B // pl.rows_per_cta)
    assert pl.ctas >= 132 or pl.warps_per_row == skernel.WARPS


@pytest.mark.parametrize("p", [2048, 2047, 1001, 300, 100, 37, 5, 1, 5000])
@pytest.mark.parametrize("x_bytes", [4, 2])
@pytest.mark.parametrize("B", [64, 256, 4096])
def test_lane_elements_cover_each_row_once(p, x_bytes, B):
    """Brute force: at the plan for B on 132 SMs, the elements the
    row's lanes add (``kernel.lane_elements``, the kernel's cut) hold
    every index of the row once, for 16-byte aligned rows and for
    unaligned ones; with aligned rows lane g's whole chunks come first,
    the chunks g, g + n_lanes, ... each in element order."""
    pl = skernel.plan(B, 132)
    vec = 16 // x_bytes
    for aligned in (True, False):
        lanes = skernel.lane_elements(p, x_bytes, pl, aligned)
        assert len(lanes) == pl.warps_per_row * 32
        flat = sorted(j for elems in lanes for j in elems)
        assert flat == list(range(p))
    lanes = skernel.lane_elements(p, x_bytes, pl, True)
    n_lanes, n_vec = len(lanes), p // vec
    for g, elems in enumerate(lanes):
        chunks = list(range(g, n_vec, n_lanes))
        assert elems[:vec * len(chunks)] == [
            j for c in chunks for j in range(c * vec, c * vec + vec)]


@pytest.mark.parametrize("B,p,r,m,code_dtype,x_dtype", [
    (256, 2048, 4, 300, "f32", "f32"),      # the served wave
    (64, 2048, 4, 50, "int8", "f32"),
    (4096, 2048, 4, 100, "fp8", "f32"),
    (256, 2048, 4, 40, "f32", "bf16"),
    (77, 2047, 3, 50, "fp8", "bf16"),       # rows aligned or not
    (40, 1001, 4, 20, "int8", "bf16"),
    (300, 5, 4, 9, "int8", "bf16"),         # p inside one warp's copy
    (64, 100, 4, 9, "f32", "f32"),
] + [(100, 300, r, 9, ("f32", "int8", "fp8")[r % 3],
      "f32" if r % 2 else "bf16") for r in range(1, 9)])
def test_kernel_summation_order_matches_jax_kernel(B, p, r, m, code_dtype,
                                                    x_dtype):
    """The scoring kernel's arithmetic order (``score_order``: each lane's
    elements from ``kernel.lane_elements``, the warp's shuffle tree, the
    warps in order, the r-term dot), emulated in plain torch, against the
    reference's Pallas kernel in interpret mode at the scorer's 2e-5.  U
    is scaled by p^-1/2, as the served basis (orthonormal columns) and
    phase 3's inputs are, so that the projections are O(1) at every p."""
    U, Cf, ids, X = _inputs(B, p, r, m, seed=11)
    U = (U / np.sqrt(p)).astype(np.float32)
    ids[::5] = np.asarray([-4, m, m + 9, -1, 0] * B, np.int32)[:len(ids[::5])]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[x_dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[x_dtype]
    Ct, St = quantize_codes(_t(Cf), code_dtype)
    got = score_order.score(_t(U).to(tdt), Ct, St, _t(ids), _t(X).to(tdt))
    Cj, Sj = jmtl.quantize_codes(Cf, code_dtype)
    want = jmtl.mtl_score(jnp.asarray(U, jdt), Cj, Sj, ids,
                          jnp.asarray(X, jdt), bb=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


import chip_smoke  # noqa: E402


@pytest.mark.parametrize("case", chip_smoke.SCORE_EDGES, ids=lambda c: c[0])
def test_kernel_order_at_four_rows_a_warp_matches_jax_kernel(case):
    """Phase 3 launches each of its edge cases a second time at 4 rows a
    warp (``chip_smoke.score_rw4_plan``: 2 warps a row, 16 rows a CTA,
    the plan of waves of 528 rows or more): that plan covers the B rows
    in its CTAs, and the kernel's order at it (``score_order``) agrees
    with the reference's Pallas kernel in interpret mode at 2e-5."""
    name, B, p, m, r, code_dtype, tdt, bad = case
    pl = chip_smoke.score_rw4_plan(skernel, B)
    assert pl.rows_per_warp == 4 and pl.warps_per_row == 2
    assert pl.rows_per_cta == skernel.WARPS // 2 * 4
    assert (pl.ctas - 1) * pl.rows_per_cta < B <= pl.ctas * pl.rows_per_cta
    U, Cf, ids, X = _inputs(B, p, r, m, seed=13)
    U = (U / np.sqrt(p)).astype(np.float32)
    if bad:
        ids[::5] = np.asarray([-4, m, m + 9, -1, 0] * B,
                              np.int32)[:len(ids[::5])]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[tdt]
    Ct, St = quantize_codes(_t(Cf), code_dtype)
    got = score_order.score(_t(U).to(tdt), Ct, St, _t(ids), _t(X).to(tdt),
                            pl=pl)
    Cj, Sj = jmtl.quantize_codes(Cf, code_dtype)
    want = jmtl.mtl_score(jnp.asarray(U, jdt), Cj, Sj, ids,
                          jnp.asarray(X, jdt), bb=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


def test_four_rows_a_warp_cases_leave_a_warp_part_of_its_rows():
    """Some edge case's B is no multiple of 4, so at 4 rows a warp its
    last warp holds fewer rows than 4, and some case has rows that are
    not 16-byte aligned, as phase 3 needs at that plan."""
    assert any(c[1] % 4 for c in chip_smoke.SCORE_EDGES)
    assert any(c[2] * torch.finfo(c[6]).bits // 8 % 16
               for c in chip_smoke.SCORE_EDGES)
