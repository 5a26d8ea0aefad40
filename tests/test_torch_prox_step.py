"""The port's fused prox step (``repro_torch.kernels.prox_step``) against
the reference's, on the CPU.

Pass criteria: the port's plain version against the reference's oracle
and against its Pallas kernel in interpret mode at the reference's own
tolerances (``tests/test_kernels.py``: rtol 2e-5 / atol 6e-5 in f32,
rtol 3e-2 / atol 9e-2 in bf16) on the reference's four
``test_prox_step_shapes`` cases; the CPU dispatch runs the plain version
and counts no launch.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``; its check is shown here to
pass a correct step and to fail a wrong one on the same cases.  The step
is the gradient accumulator's second epilogue (one source with
``mtl_grad``): its launch plan is checked at the card check's cases, and
a plain emulation of the accumulator's summation order with the step
(``accumulator_order.py``) against the reference's Pallas kernel."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # chip_smoke.py

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from repro.kernels.prox_step import prox_step as j_prox_step  # noqa: E402
from repro.kernels.prox_step import prox_step_ref as j_prox_step_ref  # noqa: E402
from repro_torch.kernels.mtl_grad import kernel as gkernel  # noqa: E402
from repro_torch.kernels.prox_step import kernel as pkernel  # noqa: E402
from repro_torch.kernels.prox_step import ops, prox_step, prox_step_ref  # noqa: E402

import accumulator_order as order  # noqa: E402

ARGS = dict(eta=0.3, rho=1.7, inv_m=0.2, l2=1e-2)
TOL = {"f32": (2e-5, 6e-5), "bf16": (3e-2, 9e-2)}      # (rtol, atol)
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(L, n, p, loss, seed=10):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((L, n, p)).astype(np.float32)
    y = rng.standard_normal((L, n)).astype(np.float32)
    if loss == "logistic":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    W, Z, Q = (rng.standard_normal((L, p)).astype(np.float32)
               for _ in range(3))
    return X, y, W, Z, Q


def _both(arrays, dt):
    """The same values in both packages, rounded once to ``dt``."""
    j = [jnp.asarray(a, J_DT[dt]) for a in arrays]
    t = [torch.from_numpy(a).to(T_DT[dt]) for a in arrays]
    return j, t


@pytest.mark.parametrize("L,n,p,loss", [
    (4, 300, 27, "squared"), (8, 100, 57, "logistic"),
    (1, 64, 9, "squared"), (5, 200, 31, "logistic"),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_reference_oracle_and_interpret_kernel(L, n, p, loss,
                                                             dt):
    j, t = _both(_inputs(L, n, p, loss), dt)
    port = prox_step_ref(*t, *ARGS.values(), loss=loss).numpy()
    assert port.dtype == np.float32 and port.shape == (L, p)
    oracle = np.asarray(j_prox_step_ref(*j, *ARGS.values(), loss=loss),
                        np.float32)
    kern = np.asarray(j_prox_step(*j, loss=loss, br=128, interpret=True,
                                  **ARGS), np.float32)
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(port, oracle, rtol=rtol, atol=atol)
    np.testing.assert_allclose(port, kern, rtol=rtol, atol=atol)


@pytest.mark.parametrize("loss", ["squared", "logistic"])
@pytest.mark.parametrize("L,n,p", [(6, 96, 23), (1, 40, 5), (3, 1, 17)])
def test_proxgd_case_and_edges(loss, L, n, p):
    """rho=0, Z=W, Q=0 (the ProxGD local step, eta*m with inv_m=1/m), a
    single task and a single row, through the CPU dispatch."""
    X, y, W, _, _ = _inputs(L, n, p, loss, seed=11)
    Q = np.zeros_like(W)
    args = dict(eta=0.4 * 6, rho=0.0, inv_m=1 / 6, l2=1e-2)
    t = [torch.from_numpy(a) for a in (X, y, W, W, Q)]
    j = [jnp.asarray(a) for a in (X, y, W, W, Q)]
    port = prox_step(*t, loss=loss, **args).numpy()
    kern = np.asarray(j_prox_step(*j, loss=loss, br=128, interpret=True,
                                  **args))
    np.testing.assert_allclose(port, kern, rtol=2e-5, atol=6e-5)
    # the step is the plain descent w - eta (g/m) here; a unit step with
    # inv_m = 1 gives w - g, so g = w - that
    w_minus_g = np.asarray(j_prox_step_ref(*j, 1.0, 0.0, 1.0, 1e-2, loss=loss))
    g = W - w_minus_g
    np.testing.assert_allclose(port, W - 0.4 * 6 * (g / 6),
                               rtol=2e-5, atol=6e-5)


def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing():
    t = [torch.from_numpy(a) for a in _inputs(3, 50, 13, "squared")]
    before = prox_step.launches
    out = prox_step(*t, loss="squared", **ARGS)
    assert prox_step.launches == before
    assert torch.equal(out, prox_step_ref(*t, *ARGS.values(), loss="squared"))


def test_dispatch_rejects_what_the_kernel_does_not_take():
    X, y, W, Z, Q = (torch.from_numpy(a)
                     for a in _inputs(2, 8, 5, "squared"))
    with pytest.raises(ValueError, match="different devices"):
        prox_step(X, y, W.to("meta"), Z, Q, **ARGS)
    with pytest.raises(ValueError, match="shape mismatch"):
        prox_step(X, y, W[:, :4].contiguous(), Z, Q, **ARGS)
    with pytest.raises(ValueError, match="want X"):
        prox_step(X[0], y, W, Z, Q, **ARGS)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        prox_step(X.double(), y, W, Z, Q, **ARGS)
    with pytest.raises(TypeError, match="must be float32"):
        prox_step(X, y, W.double(), Z, Q, **ARGS)
    with pytest.raises(ValueError, match="contiguous"):
        prox_step(X.transpose(1, 2), y, W, Z, Q, **ARGS)
    with pytest.raises(ValueError, match="unknown loss"):
        prox_step(X, y, W, Z, Q, loss="hinge", **ARGS)
    assert ops.kernel.MAX_P == 16384


def _plain_f64(X, y, W, Z, Q, eta, rho, inv_m, l2, loss):
    """The step evaluated in float64: a correct kernel whose sums run in
    another order (and more exactly) than the plain version's."""
    X, y, W, Z, Q = (a.double() for a in (X, y, W, Z, Q))
    pred = torch.einsum("lnp,lp->ln", X, W)
    r = pred - y if loss == "squared" else -y * torch.sigmoid(-y * pred)
    g = torch.einsum("lnp,ln->lp", X, r) / X.shape[1] + l2 * W
    return (W - eta * (g * inv_m + Q + rho * (W - Z))).float()


# the card's check cases small enough for a unit test (all but FULLSP's)
CHECK_CASES = [c for c in chip_smoke.PROX_CASES if c[1] * c[2] * c[3] <= 4e6]


@pytest.mark.parametrize("case", CHECK_CASES, ids=[c[0] for c in CHECK_CASES])
def test_card_check_passes_a_right_step_and_fails_a_wrong_one(case):
    """``chip_smoke``'s prox_step check (``prox_error`` against
    ``PROX_RTOL``) with its own inputs and scalars: a float64 evaluation
    passes; the plain version with l2 dropped, with X read at bf16
    precision (f32 cases at unit W scale) or, in the ADMM form, without
    q or without rho fails."""
    name, L, n, p, loss, xdt, ws, admm = case
    gen = torch.Generator().manual_seed(0)
    X, y, W, Z, Q = chip_smoke.prox_inputs(gen, L, n, p, loss, xdt, ws, admm,
                                           dev="cpu")
    args = chip_smoke.PROX_ADMM if admm else chip_smoke.PROX_DESCENT
    ref = prox_step_ref(X, y, W, Z, Q, loss=loss, **args)

    def passes(out):
        err, scale, _ = chip_smoke.prox_error(out, ref, W)
        return err <= chip_smoke.PROX_RTOL * scale

    assert passes(_plain_f64(X, y, W, Z, Q, loss=loss, **args))
    wrong = {"l2 dropped": prox_step_ref(X, y, W, Z, Q, loss=loss,
                                         **dict(args, l2=0.0))}
    if xdt == torch.float32 and ws == 1.0:
        wrong["X at bf16"] = prox_step_ref(X.bfloat16(), y, W, Z, Q,
                                           loss=loss, **args)
    if admm:
        wrong["q dropped"] = prox_step_ref(X, y, W, Z, torch.zeros_like(Q),
                                           loss=loss, **args)
        wrong["rho dropped"] = prox_step_ref(X, y, W, Z, Q, loss=loss,
                                             **dict(args, rho=0.0))
    assert [k for k, out in wrong.items() if passes(out)] == []


def test_the_step_binds_the_accumulators_library():
    """One source and one library for both kernels: the step has no
    source of its own, and the card's build makes the library once."""
    assert pkernel.SOURCE == gkernel.SOURCE
    assert pkernel.SOURCES == {gkernel.LIBRARY: gkernel.SOURCE}
    assert not (ROOT / "src_torch/repro_torch/kernels/prox_step/csrc").exists()
    assert pkernel.MAX_P == gkernel.MAX_P


@pytest.mark.parametrize("case", chip_smoke.PROX_CASES,
                         ids=[c[0] for c in chip_smoke.PROX_CASES])
def test_card_check_cases_run_the_split_they_name(case):
    """At each of the card check's cases on an H100 (132 SMs), the plan
    fits a block, and a case named for the row split runs at S > 1: by
    the plan, or forced past the tiles (``PROX_SPLIT``)."""
    name, L, n, p, loss, xdt, ws, admm = case
    xb = torch.empty((), dtype=xdt).element_size()
    pl = gkernel.plan(L, n, p, xb, 132)
    assert pl.smem_bytes <= gkernel.MAX_SMEM and pl.stages >= 1
    split = chip_smoke.PROX_SPLIT.get(name, pl.split)
    if name.startswith("split"):
        assert split > 1
    if name in chip_smoke.PROX_SPLIT:
        assert split > -(-n // pl.tile_rows)               # ranks past the tiles
    if name.startswith("path D"):
        assert pl.split == 8                               # two CTAs an SM
    if name.startswith("FULLSP"):
        assert pl.split == 1


# (L, n, p, X dtype, split, tile rows)
STEP_ORDER_CASES = [
    (4, 300, 27, "f32", 4, 32),
    (2, 150, 24, "f32", 8, 32),
    (3, 200, 16, "bf16", 2, 32),
    (1, 64, 9, "f32", 8, 5),
]


@pytest.mark.parametrize("case", STEP_ORDER_CASES,
                         ids=[f"L{c[0]}n{c[1]}p{c[2]}{c[3]}S{c[4]}t{c[5]}"
                              for c in STEP_ORDER_CASES])
@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_kernel_summation_order_with_the_step_matches_jax_kernel(case, loss):
    """The accumulator's order (per rank, tiles in order in f32; partials
    in rank order) and the step against the reference's Pallas kernel in
    interpret mode, within 1e-5 of max(1, max|W_new|) (the card check's
    scale)."""
    L, n, p, dt, split, tile_rows = case
    arrays = _inputs(L, n, p, loss, seed=12)
    jx, tx = _both(arrays[:1], dt)                  # X in dt, the rest f32
    jr, tr = _both(arrays[1:], "f32")
    want = np.asarray(j_prox_step(*jx, *jr, loss=loss, br=128,
                                  interpret=True, **ARGS), np.float32)
    X, y, W, Z, Q = *tx, *tr
    total = order.accumulate(X, y, W, loss,
                             gkernel.row_ranges(n, tile_rows, split),
                             tile_rows)
    got = order.step_out(total, n, W, Z, Q, *ARGS.values()).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
