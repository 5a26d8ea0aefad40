"""The port's attention with explicit positions
(``repro_torch.kernels.flash_attention``) against the reference's, on
the CPU.

Pass criteria: the port's plain version against the reference's oracle
(``repro.kernels.flash_attention.ref.attention_ref``) and its Pallas
kernel in interpret mode on the reference's own shape and mask grid
(``tests/test_kernels.py:26-67``) at the reference's tolerances (2e-5 in
f32, 3e-2 in bf16); against the reference's ``_sdpa_naive`` +
``_mask_bias`` on ring-buffer positions (wrapped and empty slots) at
2e-5; a row where no key counts gives 0.  The CUDA kernel itself is
held to the plain version on the card by ``chip_smoke.py`` (phase 10);
its check is shown here to pass the plain version and to fail an
attention that drops the window, drops the softcap or ignores ``k_pos``.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # chip_smoke.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models.attention import _mask_bias, _sdpa_naive  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as port_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import key_mask  # noqa: E402

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 3e-2}

# the reference's oracle and naive path, each compiled once per shape
j_oracle = jax.jit(attention_ref, static_argnames=("causal", "window",
                                                   "softcap", "scale"))


@functools.partial(jax.jit, static_argnames=("window", "softcap"))
def j_naive(q, k, v, q_pos, k_pos, *, window, softcap):
    """``_sdpa_naive`` with the causal ``_mask_bias``, scale hd**-0.5."""
    bias = _mask_bias(q_pos, k_pos, True, window)
    return _sdpa_naive(q, k, v, bias, q.shape[-1] ** -0.5, softcap)


def _qkv(B, Sq, Sk, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32))


def _port(arrays, dt):
    return [torch.from_numpy(a).to(T_DT[dt]) for a in arrays]


def _jax(arrays, dt):
    return [jnp.asarray(a, J_DT[dt]) for a in arrays]


def _bhsd(x, B, S, H, hd):
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


def _arange_pos(B, S):
    return torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (2, 256, 256, 4, 2, 64), (1, 200, 200, 4, 1, 128),
    (2, 128, 384, 2, 2, 64), (1, 130, 130, 8, 4, 32),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_reference_oracle_and_interpret_kernel(B, Sq, Sk, H,
                                                             Hkv, hd, dt):
    arrays = _qkv(B, Sq, Sk, H, Hkv, hd, seed=0)
    q, k, v = _port(arrays, dt)
    out = flash_attention(q, k, v, q_pos=_arange_pos(B, Sq),
                          k_pos=_arange_pos(B, Sk), causal=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    jq, jk, jv = _jax(arrays, dt)
    oracle = j_oracle(_bhsd(jq, B, Sq, H, hd), _bhsd(jk, B, Sk, Hkv, hd),
                      _bhsd(jv, B, Sk, Hkv, hd), causal=True)
    oracle = np.asarray(oracle, np.float32).reshape(
        B, H, Sq, hd).transpose(0, 2, 1, 3)
    kern = np.asarray(j_flash(jq, jk, jv, causal=True, interpret=True),
                      np.float32)
    np.testing.assert_allclose(_f32(out), oracle, atol=TOL[dt], rtol=TOL[dt])
    np.testing.assert_allclose(_f32(out), kern, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 64, None), (True, 64, 50.0),
    (False, None, None), (True, None, 30.0),
])
def test_plain_matches_reference_masks(causal, window, softcap):
    B, S, H, Hkv, hd = 2, 192, 4, 2, 64
    arrays = _qkv(B, S, S, H, Hkv, hd, seed=1)
    q, k, v = _port(arrays, "f32")
    pos = _arange_pos(B, S)
    out = flash_attention(q, k, v, q_pos=pos, k_pos=pos, causal=causal,
                          window=window, softcap=softcap)
    jq, jk, jv = _jax(arrays, "f32")
    kern = j_flash(jq, jk, jv, causal=causal, window=window, softcap=softcap,
                   bq=64, bk=64, interpret=True)
    oracle = j_oracle(_bhsd(jq, B, S, H, hd), _bhsd(jk, B, S, Hkv, hd),
                      _bhsd(jv, B, S, Hkv, hd), causal=causal, window=window,
                      softcap=softcap)
    oracle = np.asarray(oracle).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), oracle, atol=2e-5, rtol=2e-5)


def _ring(B, slots, q_positions, written):
    """Ring-buffer key positions: row b holds its last ``written[b]``
    positions up to ``q_positions[b]`` at slots ``pos % slots``, the
    other slots empty (-10**9)."""
    k_pos = np.full((B, slots), -10 ** 9, np.int32)
    for b in range(B):
        for p in range(q_positions[b] - written[b] + 1, q_positions[b] + 1):
            k_pos[b, p % slots] = p
    return k_pos


@pytest.mark.parametrize("window,softcap,Sq", [
    (None, None, 1), (64, 50.0, 1), (None, 50.0, 1), (64, None, 3),
])
def test_plain_matches_naive_sdpa_on_ring_positions(window, softcap, Sq):
    """Decode against a wrapped ring (and, at Sq=3, three queries against
    it) with empty slots: the reference's naive path at 2e-5."""
    B, slots, H, Hkv, hd = 3, 64, 4, 2, 64
    last = np.array([200, 131, 40])
    q_pos = np.stack([last - Sq + 1 + i for i in range(Sq)], 1).astype(np.int32)
    k_pos = _ring(B, slots, last, written=[64, 64, 30])
    arrays = _qkv(B, Sq, slots, H, Hkv, hd, seed=2)
    q, k, v = _port(arrays, "f32")
    out = flash_attention(q, k, v, q_pos=torch.from_numpy(q_pos),
                          k_pos=torch.from_numpy(k_pos), causal=True,
                          window=window, softcap=softcap, scale=hd ** -0.5)
    naive = j_naive(*_jax(arrays, "f32"), jnp.asarray(q_pos),
                    jnp.asarray(k_pos), window=window, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(naive), atol=2e-5,
                               rtol=2e-5)


def test_row_where_no_key_counts_is_zero():
    """Pinned difference: the port (as the reference's Pallas kernel and
    its oracle) gives 0 where no key counts; the reference's naive path
    gives a near-uniform mean of v there."""
    B, S, H, Hkv, hd = 2, 16, 2, 1, 32
    q, k, v = _port(_qkv(B, S, S, H, Hkv, hd, seed=3), "f32")
    q_pos = _arange_pos(B, S)
    k_pos = q_pos.clone()
    k_pos[1] = -10 ** 9                      # row 1: every slot empty
    out = flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=True)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert bool(out[0].abs().sum(-1).gt(0).all())
    naive = np.asarray(j_naive(*(jnp.asarray(t.numpy()) for t in
                                 (q, k, v, q_pos, k_pos)),
                               window=None, softcap=None))
    np.testing.assert_allclose(out[0].numpy(), naive[0], atol=2e-5, rtol=2e-5)
    mean_v = v[1].mean(0).numpy()            # (Hkv, hd)
    np.testing.assert_allclose(naive[1], np.broadcast_to(
        mean_v[None, :, None, :], (S, Hkv, H // Hkv, hd)).reshape(S, H, hd),
        atol=1e-5)


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    B, S, H, Hkv, hd = 1, 40, 4, 2, 64
    q, k, v = _port(_qkv(B, S, S, H, Hkv, hd, seed=4), "f32")
    pos = _arange_pos(B, S)
    n0 = ops.flash_attention.launches
    out = flash_attention(q, k, v, q_pos=pos, k_pos=pos, window=16,
                          softcap=50.0)
    assert ops.flash_attention.launches == n0
    assert torch.equal(out, port_ref(q, k, v, q_pos=pos, k_pos=pos,
                                     window=16, softcap=50.0))
    with pytest.raises(NotImplementedError, match="prefix"):
        flash_attention(q, k, v, q_pos=pos, k_pos=pos,
                        prefix_len=torch.tensor([4]))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q[:, :, :3], k, v, q_pos=pos, k_pos=pos)
    with pytest.raises(TypeError, match="integers"):
        flash_attention(q, k, v, q_pos=pos.float(), k_pos=pos)
    with pytest.raises(TypeError, match="share"):
        flash_attention(q, k.bfloat16(), v, q_pos=pos, k_pos=pos)


# the served prefill cases are checked here on their last rows (each
# row's attention is independent of the others'), where the window binds
TAIL_ROWS = 32


@pytest.mark.parametrize("case", chip_smoke.FA_CASES, ids=lambda c: c[0])
def test_card_check_passes_the_plain_version_and_fails_a_wrong_one(case):
    """``chip_smoke``'s attention check (``fa_error``/``fa_passes``
    against ``FA_TOL``) on each of its cases and on the same inputs as on
    the card, the served shapes included (prefill on its last ``TAIL_ROWS`` query rows): a
    float64 evaluation of the plain version passes; the plain version
    with each of ``fa_controls`` (the window dropped where it binds, the
    softcap dropped, ``k_pos`` replaced by ``0..Sk-1`` in ring cases)
    fails, in bf16 as in f32."""
    name, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap = case
    q, k, v, q_pos, k_pos = chip_smoke.fa_inputs(case, dev="cpu")
    if Sq > 400:
        q, q_pos = q[:, -TAIL_ROWS:], q_pos[:, -TAIL_ROWS:]
    kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
              softcap=softcap)
    ref = port_ref(q, k, v, **kw)
    ref_abs = port_ref(q, k, v.abs(), **kw)

    def passes(out):
        return chip_smoke.fa_passes(
            *chip_smoke.fa_error(out, ref, ref_abs, dtype), dtype)

    exact = port_ref(q.double(), k.double(), v.double(), **kw)
    assert passes(exact.to(q.dtype))
    wrong = {what: port_ref(q, k, v, **wrong_kw) for what, wrong_kw
             in chip_smoke.fa_controls(case, kw).items()}
    assert wrong, "the case exercises none of the checked features"
    if window is not None and Sq > 400:
        assert "window dropped" in wrong
    assert [w for w, out in wrong.items() if passes(out)] == []


# --- the tensor-core route (csrc/flash_attention_wgmma.cu) -----------------
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as port_ref_mod  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,dtype,route,rows", [
    (4, 5120, 5120, 8, 4, 256, BF16, "wgmma", 128),      # gemma2 prefill
    (4, 1, 5152, 8, 4, 256, BF16, "decode", 2),          # gemma2 decode
    (4, 1, 4096, 8, 4, 256, BF16, "decode", 2),          # local decode
    (4, 5120, 5120, 8, 4, 256, F32, "cuda_cores", 64),   # the f32 anchor
    (2, 1, 4612, 8, 4, 256, F32, "decode", 2),           # its decode steps
    (2, 31, 300, 4, 2, 128, BF16, "cuda_cores", 64),     # Sq·group = 62
    (2, 32, 300, 4, 2, 128, BF16, "wgmma", 128),         # Sq·group = 64
    (1, 300, 300, 16, 16, 256, BF16, "wgmma", 128),      # group 1
    (1, 300, 300, 18, 2, 128, BF16, "wgmma", 126),       # group 9
    (1, 300, 300, 24, 2, 128, BF16, "wgmma", 120),       # group 12
    (1, 6, 40, 24, 2, 64, BF16, "wgmma", 120),           # 72 rows, bq > Sq
    (1, 3, 40, 24, 2, 64, BF16, "cuda_cores", 64),       # 36 rows
    (1, 4, 300, 4, 2, 128, BF16, "decode", 8),           # Sq·group = 8
    (1, 3, 300, 6, 2, 128, BF16, "cuda_cores", 64),      # Sq·group = 9
    (1, 8, 300, 2, 2, 64, F32, "decode", 8),             # Sq·group = 8
    (1, 9, 300, 2, 2, 64, F32, "cuda_cores", 64),        # Sq·group = 9
    (1, 2, 300, 2, 2, 64, F32, "decode", 2),             # Sq·group = 2
    (1, 3, 300, 2, 2, 64, F32, "decode", 8),             # Sq·group = 3
    (3, 1, 256, 24, 2, 128, F32, "cuda_cores", 64),      # group 12 > 8
])
def test_plan_routes_bf16_prefill_to_the_tensor_cores(B, Sq, Sk, H, Hkv, hd,
                                                      dtype, route, rows):
    """``kernel.plan``'s three routes: bf16 calls with at least 64 query
    rows (Sq·group) go to the tensor cores with a row block of ``128 //
    group`` queries times the group (126 and 120 rows at group 9 and 12),
    one CTA per block, KV head and batch row, and every 64-key tile;
    calls of at most 8 rows (decode), f32 or bf16, go to the decode
    kernel, whose CTA takes all of them (2 or 8, the instantiation that
    holds them) and one run of key tiles; every other call (f32 prefill,
    bf16 of 9 to 63 rows) stays on the CUDA cores, 64 rows a CTA."""
    plan = kernel.plan(B, Sq, Sk, H, Hkv, hd, dtype, n_sm=132)
    assert plan.route == route == kernel.route(dtype, Sq, H, Hkv, hd)
    assert plan.rows == rows
    if route == "wgmma":
        group = H // Hkv
        assert plan.n_split == 1
        assert plan.ctas == -(-Sq // (128 // group)) * B * Hkv
        assert plan.tiles_per_split == -(-Sk // 64)
    if route == "decode":
        tile = kernel.decode_tile_keys(hd, dtype)
        assert plan.ctas == B * Hkv
        assert plan.tiles_per_split * tile <= kernel.DECODE_MAX_KEYS
        assert (plan.n_split - 1) * plan.tiles_per_split * tile < Sk \
            <= plan.n_split * plan.tiles_per_split * tile


@pytest.mark.parametrize("case", chip_smoke.FA_CASES, ids=lambda c: c[0])
def test_card_cases_are_meant_for_the_route_the_plan_takes(case):
    """Phase 10 checks each case's launches by route against
    ``chip_smoke.fa_route``; that expectation is the plan's route."""
    name, B, Sq, Sk, H, Hkv, hd, dtype, *_ = case
    assert chip_smoke.fa_route(case) == kernel.route(dtype, Sq, H, Hkv, hd)


def test_cpu_dispatch_counts_no_launch_by_route():
    q, k, v = _port(_qkv(1, 64, 64, 4, 2, 64, seed=5), "bf16")
    pos = _arange_pos(1, 64)
    before = dict(ops.flash_attention.launches_by_route)
    assert set(before) == {"wgmma", "decode", "cuda_cores"}
    flash_attention(q, k, v, q_pos=pos, k_pos=pos)
    assert ops.flash_attention.launches_by_route == before


def _tensor_core_emulation(q, k, v, kw, split_p=True, tile=64):
    """The tensor-core route's arithmetic in plain torch, returned in f32
    before the bf16 cast: bf16 q·k products (exact in f32) summed in f32,
    the scale, softcap and mask, an online softmax over tiles of ``tile``
    keys, and P·V with P as bf16 hi + lo (``split_p``) or as one bf16
    value, summed in f32."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale, softcap = hd ** -0.5, kw["softcap"]
    qf = q.float().reshape(B, Sq, Hkv, g, hd)
    ok = key_mask(kw["q_pos"], kw["k_pos"], True, kw["window"])
    m = torch.full((B, Hkv, g, Sq, 1), float("-inf"))
    l = torch.zeros(B, Hkv, g, Sq, 1)
    o = torch.zeros(B, Hkv, g, Sq, hd)
    for k0 in range(0, k.shape[1], tile):
        kt, vt = k[:, k0:k0 + tile].float(), v[:, k0:k0 + tile].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~ok[:, None, None, :, k0:k0 + tile], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        p_used = hi + (p - hi).bfloat16().float() if split_p else hi
        o = o * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p_used, vt)
        m = m_new
    out = torch.where(l > 0, o / l, torch.zeros_like(o))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("name", ["prefill global bf16", "prefill local bf16",
                                  "S=130 hd=256 group 2 bf16",
                                  "ring 96 queries hd=256 bf16"])
def test_split_p_keeps_the_f32_limit_and_a_single_bf16_p_does_not(name):
    """The route's P·V takes P as bf16 hi + lo (P to ~2^-17).  Emulated
    in plain torch on a phase-10 case's inputs (served prefill on its last
    ``TAIL_ROWS`` rows) and held, before the bf16 cast, to the float64
    plain version, it passes the f32 check (``FA_TOL[f32]`` of each row's
    max plus of its Σp·|v|); with a single bf16 P (2^-9) it fails that
    check."""
    case = next(c for c in chip_smoke.FA_CASES if c[0] == name)
    _, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap = case
    q, k, v, q_pos, k_pos = chip_smoke.fa_inputs(case, dev="cpu")
    if Sq > 400:
        q, q_pos = q[:, -TAIL_ROWS:], q_pos[:, -TAIL_ROWS:]
    kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
              softcap=softcap)
    exact = port_ref(q.double(), k.double(), v.double(), **kw)
    exact_abs = port_ref(q.double(), k.double(), v.double().abs(), **kw)

    def passes_f32(out):
        return chip_smoke.fa_passes(
            *chip_smoke.fa_error(out, exact, exact_abs, F32), F32)

    assert passes_f32(_tensor_core_emulation(q, k, v, kw))
    assert not passes_f32(_tensor_core_emulation(q, k, v, kw, split_p=False))


def _brute_summary(k_pos, tile):
    B, Sk = k_pos.shape
    out = []
    for b in range(B):
        row = []
        for t0 in range(0, Sk, tile):
            live = [int(x) for x in k_pos[b, t0:t0 + tile] if x >= 0]
            row.append((min(live), max(live), len(live)) if live else
                       (2 ** 31 - 1, -2 ** 31, 0))
        out.append(row)
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("name,bq,window", [
    ("prefill local bf16", 64, 4096),            # contiguous, the window binds
    ("S=300 hd=64 group 1 bf16", 128, 100),      # a ragged last tile
    ("S=257 hd=128 group 9 bf16", 14, None),     # causal only, ragged
    ("ring 96 queries hd=256 bf16", 64, 128),    # wrapped and empty slots
    ("ring 256 slots group 12", 1, 200),         # one query, wrapped slots
])
def test_tile_skip_rule_against_brute_force(name, bq, window):
    """The plain version of the route's pre-pass (``key_tile_summary``:
    min, max and count of each 64-slot tile's live key positions) equals
    a brute-force count, and its tile states hold against the mask itself
    on wrapped, empty and windowed positions: a skipped tile has no
    (query, key) pair that counts for its block, a whole tile has 64 live
    keys that count for every query of the block.  On contiguous
    positions both are exact, and the skip drops tiles."""
    case = next(c for c in chip_smoke.FA_CASES if c[0] == name)
    _, _, q_pos, k_pos = chip_smoke.fa_inputs(case, dev="cpu")[1:]
    tile = kernel.WGMMA_TILE_K
    summary = port_ref_mod.key_tile_summary(k_pos, tile)
    assert torch.equal(summary, _brute_summary(k_pos, tile))
    states = port_ref_mod.tile_states(q_pos, k_pos, bq, tile, True, window)
    ok = key_mask(q_pos, k_pos, True, window)
    B, Sq, Sk = ok.shape
    contiguous = case[8] == "prefill"
    for b in range(B):
        for qb in range(states.shape[1]):
            for t in range(states.shape[2]):
                block = ok[b, qb * bq:(qb + 1) * bq, t * tile:(t + 1) * tile]
                st = int(states[b, qb, t])
                if st == port_ref_mod.SKIP:
                    assert not block.any()
                if st == port_ref_mod.WHOLE:
                    assert block.shape[1] == tile and block.all()
                if contiguous:
                    assert (st == port_ref_mod.SKIP) == (not block.any())
                    assert (st == port_ref_mod.WHOLE) == (
                        block.shape[1] == tile and bool(block.all()))
    assert int((states == port_ref_mod.SKIP).sum()) > 0


# --- the decode route (csrc/flash_decode.cu) --------------------------------
import decode_order  # noqa: E402

FA_DECODE_CASES = [c for c in chip_smoke.FA_CASES
                   if chip_smoke.fa_route(c) == "decode"]


def _np32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,Sq,slots,H,Hkv,hd,dt,window,softcap", [
    (3, 1, 300, 4, 2, 64, "f32", 64, 50.0),      # the window empties splits
    (2, 1, 1000, 8, 4, 128, "bf16", None, 50.0),
    (2, 3, 256, 8, 4, 256, "f32", 128, None),    # 6 rows: the 8-row kernel
    (2, 1, 500, 16, 2, 64, "bf16", 200, 30.0),   # group 8
    (2, 1, 777, 8, 4, 128, "f32", None, None),   # 777 slots: a ragged tile
    (1, 2, 450, 12, 3, 128, "f32", 100, 30.0),   # 8 rows over 2 queries
])
def test_decode_order_matches_naive_sdpa_on_ring_positions(
        B, Sq, slots, H, Hkv, hd, dt, window, softcap):
    """The decode kernel's arithmetic order (``decode_order``: its key
    partition over splits, warps and lane groups, per-warp online softmax
    and the two fixed-order merges), emulated in plain torch on a wrapped
    ring with empty slots, against the reference's ``_sdpa_naive`` with
    ``_mask_bias``, at the reference's tolerances."""
    last = np.array([slots + 40 + 37 * b for b in range(B)])
    written = [slots if b % 2 == 0 else slots // 2 for b in range(B)]
    q_pos = np.stack([last - Sq + 1 + i for i in range(Sq)], 1).astype(np.int32)
    k_pos = _ring(B, slots, last, written)
    arrays = _qkv(B, Sq, slots, H, Hkv, hd, seed=7)
    q, k, v = _port(arrays, dt)
    got = decode_order.decode(q, k, v, torch.from_numpy(q_pos),
                              torch.from_numpy(k_pos), window=window,
                              softcap=softcap)
    assert got.dtype == q.dtype and got.shape == q.shape
    naive = j_naive(*_jax(arrays, dt), jnp.asarray(q_pos), jnp.asarray(k_pos),
                    window=window, softcap=softcap)
    np.testing.assert_allclose(_np32(got), _np32(naive), atol=TOL[dt],
                               rtol=TOL[dt])


@pytest.mark.parametrize("B,Sq,Sk,H,hd,dt", [
    (2, 8, 300, 4, 64, "f32"), (1, 2, 1100, 4, 128, "bf16"),
    (2, 1, 600, 2, 256, "f32"),
])
def test_decode_order_matches_reference_oracle_and_interpret_kernel(
        B, Sq, Sk, H, hd, dt):
    """Without the causal mask (so the reference's kernel, which takes the
    positions 0..S-1, computes the same function) the emulated decode
    order agrees with the reference's oracle and its Pallas kernel in
    interpret mode on every key of the cache."""
    arrays = _qkv(B, Sq, Sk, H, H, hd, seed=8)
    q, k, v = _port(arrays, dt)
    got = decode_order.decode(q, k, v, _arange_pos(B, Sq), _arange_pos(B, Sk),
                              causal=False)
    jq, jk, jv = _jax(arrays, dt)
    oracle = j_oracle(_bhsd(jq, B, Sq, H, hd), _bhsd(jk, B, Sk, H, hd),
                      _bhsd(jv, B, Sk, H, hd), causal=False)
    oracle = np.asarray(oracle, np.float32).reshape(
        B, H, Sq, hd).transpose(0, 2, 1, 3)
    kern = np.asarray(j_flash(jq, jk, jv, causal=False, interpret=True),
                      np.float32)
    np.testing.assert_allclose(_np32(got), oracle, atol=TOL[dt], rtol=TOL[dt])
    np.testing.assert_allclose(_np32(got), kern, atol=TOL[dt], rtol=TOL[dt])


def test_decode_order_with_empty_splits_warps_and_rows():
    """A ring where the window leaves whole splits and warps with no key
    that counts, and a batch row whose every slot is empty: the emulated
    order matches the reference's naive path where keys count and gives
    0 on the empty row, with no NaN from the merges of empty warps and
    splits."""
    B, Sq, slots, H, Hkv, hd, window = 3, 1, 2000, 4, 2, 64, 50
    last = np.array([2100, 2500, 2300])
    k_pos = _ring(B, slots, last, written=[2000, 2000, 0])
    q_pos = last[:, None].astype(np.int32)
    arrays = _qkv(B, Sq, slots, H, Hkv, hd, seed=9)
    q, k, v = _port(arrays, "f32")
    pl = kernel.plan(B, Sq, slots, H, Hkv, hd, q.dtype, n_sm=132)
    geo = decode_order.geometry(pl.rows, hd, q.dtype)
    keys = decode_order.key_partition(pl, geo)
    ok = key_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), True,
                  window).any(1)                              # (B, Sk)
    live = torch.zeros(B, keys.numel(), dtype=torch.bool)
    live[:, :slots] = ok
    by_split = live[:, keys.reshape(pl.n_split, -1)].any(-1)  # (B, splits)
    by_warp = live[:, keys.transpose(0, 2).reshape(
        kernel.DECODE_WARPS, -1)].any(-1)                     # (B, warps)
    assert pl.n_split > 1
    assert bool((~by_split[:2]).any()) and bool((~by_warp[:2]).any())
    assert not bool(by_split[2].any())
    got = decode_order.decode(q, k, v, torch.from_numpy(q_pos),
                              torch.from_numpy(k_pos), window=window)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    naive = j_naive(*_jax(arrays, "f32"), jnp.asarray(q_pos),
                    jnp.asarray(k_pos), window=window, softcap=None)
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(naive)[:2],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", [c for c in FA_DECODE_CASES
                                  if c[7] == BF16 or c[3] < 4096],
                         ids=lambda c: c[0])
def test_decode_order_passes_the_card_check_on_phase_10_cases(case):
    """On each phase-10 decode case (of the four at the served cache
    sizes, the two bf16 ones the wave runs), with the card's inputs, the
    emulated decode order passes ``chip_smoke``'s attention check against
    the plain version (``fa_error``/``fa_passes`` at ``FA_TOL``, per
    output row) and agrees with the reference's naive path at the
    reference's tolerance."""
    name, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap = case
    q, k, v, q_pos, k_pos = chip_smoke.fa_inputs(case, dev="cpu")
    kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
              softcap=softcap)
    got = decode_order.decode(q, k, v, q_pos, k_pos, window=window,
                              softcap=softcap)
    ref, ref_abs = port_ref(q, k, v, **kw), port_ref(q, k, v.abs(), **kw)
    assert chip_smoke.fa_passes(*chip_smoke.fa_error(got, ref, ref_abs, dtype),
                                dtype)
    dt = "bf16" if dtype == BF16 else "f32"
    naive = j_naive(*(jnp.asarray(_np32(t), J_DT[dt]) for t in (q, k, v)),
                    jnp.asarray(q_pos.numpy()), jnp.asarray(k_pos.numpy()),
                    window=window, softcap=softcap)
    np.testing.assert_allclose(_np32(got), _np32(naive), atol=TOL[dt],
                               rtol=TOL[dt])


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,dtype", [
    (4, 1, 5152, 8, 4, 256, BF16), (4, 1, 4096, 8, 4, 256, BF16),
    (2, 1, 4612, 8, 4, 256, F32), (2, 3, 256, 8, 4, 256, F32),
    (3, 1, 333, 4, 4, 64, F32), (2, 1, 500, 16, 2, 64, BF16),
    (1, 2, 700, 8, 2, 128, BF16), (64, 1, 8192, 16, 16, 128, BF16),
])
def test_decode_plan_covers_every_key_and_row_once(B, Sq, Sk, H, Hkv, hd,
                                                   dtype):
    """Brute force over the decode launch on 132 SMs: the (split, tile,
    warp, step, group) -> key map is one to one onto the split runs'
    slots, which hold every key of the cache once and no split past it;
    each key's lanes hold every head-dim element once; a CTA's rows hold
    each (query, head) of its KV group once."""
    pl = kernel.plan(B, Sq, Sk, H, Hkv, hd, dtype, n_sm=132)
    assert pl.route == "decode"
    geo = decode_order.geometry(pl.rows, hd, dtype)
    assert geo.tk == geo.kpw * kernel.DECODE_WARPS == \
        geo.ns * geo.kps * kernel.DECODE_WARPS
    assert geo.lpk * geo.kps == 32 and geo.lpk * geo.epl == hd
    keys = decode_order.key_partition(pl, geo).flatten()
    assert torch.equal(keys.sort().values, torch.arange(keys.numel()))
    n_keys = pl.n_split * pl.tiles_per_split * geo.tk
    assert keys.numel() == n_keys and n_keys - geo.tk * pl.tiles_per_split < Sk
    assert Sk <= n_keys and pl.tiles_per_split * geo.tk <= \
        kernel.DECODE_MAX_KEYS
    dims = decode_order.lane_dims(geo, hd).flatten()
    assert torch.equal(dims.sort().values, torch.arange(hd))
    group = H // Hkv
    assert Sq * group <= pl.rows
    pairs = {(r // group, r % group) for r in range(Sq * group)}
    assert pairs == {(i, g) for i in range(Sq) for g in range(group)}


def test_phase_10_decode_cases_reach_every_instantiation_and_an_empty_split():
    """Phase 10's decode cases, on 132 SMs, reach every (dtype, hd, rows)
    instantiation of the decode source, and some split of theirs holds no
    key that counts (``chip_smoke.fa_decode_shape``, which phase 10
    checks on the card)."""
    reached, empty = set(), 0
    for case in FA_DECODE_CASES:
        shape, n_empty = chip_smoke.fa_decode_shape(kernel, case, 132)
        reached.add(shape)
        empty += n_empty
    assert reached == {(d, hd, rows) for d in ("float32", "bfloat16")
                       for hd in kernel.HEAD_DIMS
                       for rows in kernel.DECODE_ROWS}
    assert empty > 0


def test_phase_10_cuda_core_split_cases_split_with_an_empty_split():
    """Phase 10's CUDA-core split cases (``chip_smoke.FA_SPLIT``), on 132
    SMs, take the CUDA-core route with their keys split over CTAs (the
    combine pass merges them), and some split of theirs holds no key that
    counts (``chip_smoke.fa_split``, which phase 10 checks on the card)."""
    cases = [c for c in chip_smoke.FA_CASES if c[0] in chip_smoke.FA_SPLIT]
    assert len(cases) == len(chip_smoke.FA_SPLIT)
    splits = [chip_smoke.fa_split(kernel, c, 132) for c in cases]
    for case, (n_split, _) in zip(cases, splits):
        name, B, Sq, Sk, H, Hkv, hd, dtype, *_ = case
        assert chip_smoke.fa_route(case) == "cuda_cores" == \
            kernel.plan(B, Sq, Sk, H, Hkv, hd, dtype, 132).route
        assert n_split > 1, name
    assert any(empty > 0 for _, empty in splits)
