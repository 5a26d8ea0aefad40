"""The port's per-task gradients (``repro_torch.kernels.mtl_grad``) against
the JAX reference, on the CPU: the plain version against the reference's
Pallas kernel in interpret mode and its oracle, against autograd of the
mean loss, and the wrapper's checks.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``; here its
launch plan (``kernel.plan``: the row split, tiles, stages, shared
memory) is checked at phase 3's shapes, its row ranges by brute force,
and a plain emulation of its summation order (``accumulator_order.py``)
against the reference's Pallas kernel.

Tolerance: rel 1e-5 of the largest gradient entry (both sides sum the
same f32 products; only the order of the sums differs)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

from repro.kernels import mtl_grad as jgrad  # noqa: E402
from repro.kernels.mtl_grad.ref import task_gradients_ref as jref  # noqa: E402
from repro_torch.core import linear_model as lm  # noqa: E402
from repro_torch.core.losses import get_loss  # noqa: E402
from repro_torch.kernels.mtl_grad import kernel as gkernel  # noqa: E402
from repro_torch.kernels.mtl_grad import ops  # noqa: E402
from repro_torch.kernels.mtl_grad.ref import task_gradients_ref  # noqa: E402

import accumulator_order as order  # noqa: E402

RTOL = 1e-5


def _inputs(m, n, p, loss, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = rng.standard_normal((m, n)).astype(np.float32)
    if loss == "logistic":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    W = (rng.standard_normal((m, p)) / np.sqrt(p)).astype(np.float32)
    return X, y, W


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


SHAPES = [
    (3, 300, 37),      # n past one 256-row block, odd p
    (1, 64, 16),       # m = 1, one partial block
    (4, 513, 8),       # n = 2 blocks + 1 row
    (2, 1, 5),         # one row
]


@pytest.mark.parametrize("m,n,p", SHAPES)
@pytest.mark.parametrize("loss", ["squared", "logistic"])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_plain_version_matches_jax_kernel(m, n, p, loss, x_dtype):
    X, y, W = _inputs(m, n, p, loss)
    Xt = torch.from_numpy(X)
    if x_dtype == "bf16":
        Xt = Xt.to(torch.bfloat16)
        X = Xt.to(torch.float32).numpy()          # the same bf16 values
    Xj = jnp.asarray(X).astype(jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    want = np.asarray(jgrad.task_gradients(Xj, jnp.asarray(y), jnp.asarray(W),
                                           loss=loss))   # interpret mode
    oracle = np.asarray(jref(Xj, jnp.asarray(y), jnp.asarray(W), loss=loss))
    before = ops.task_gradients.launches
    got = ops.task_gradients(Xt, torch.from_numpy(y), torch.from_numpy(W),
                             loss=loss)
    assert ops.task_gradients.launches == before          # CPU: no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, p)
    _close(got.numpy(), want)
    _close(got.numpy(), oracle)


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_plain_version_matches_autograd(loss):
    """G[j] is the gradient of the mean loss of task j at w_j."""
    X, y, W = _inputs(3, 300, 37, loss, seed=1)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    Wt = torch.from_numpy(W).clone().requires_grad_(True)
    lo = get_loss(loss)
    total = sum(lm.task_loss(lo, Wt[j], Xt[j], yt[j]) for j in range(3))
    (want,) = torch.autograd.grad(total, Wt)
    got = ops.task_gradients(Xt, yt, torch.from_numpy(W), loss=loss)
    _close(got.numpy(), want.numpy())


def test_logistic_is_stable_at_large_margins():
    X, y, W = _inputs(2, 40, 6, "logistic", seed=2)
    W = W * 1e4                                      # |pred| in the thousands
    got = task_gradients_ref(torch.from_numpy(X), torch.from_numpy(y),
                             torch.from_numpy(W), loss="logistic")
    want = np.asarray(jref(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
                           loss="logistic"))
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), want)


def _good():
    X, y, W = _inputs(2, 10, 4, "squared")
    return torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(W)


@pytest.mark.parametrize("case,exc", [
    ("noncontiguous", ValueError),
    ("x_int", TypeError),
    ("y_f64", TypeError),
    ("shape", ValueError),
    ("loss", ValueError),
    ("meta", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    X, y, W = _good()
    kw = {"loss": "squared"}
    if case == "noncontiguous":
        W = torch.from_numpy(np.ascontiguousarray(W.numpy().T)).T
    elif case == "x_int":
        X = X.to(torch.int32)
    elif case == "y_f64":
        y = y.double()
    elif case == "shape":
        W = W[:, :3].contiguous()
    elif case == "loss":
        kw["loss"] = "hinge"
    elif case == "meta":          # neither CPU nor CUDA: raise, never fall back
        X, y, W = (t.to("meta") for t in (X, y, W))
    with pytest.raises(exc):
        ops.task_gradients(X, y, W, **kw)


N_SM = 132                      # an H100 SXM's SMs

# phase 3's shapes (chip_smoke's GRAD_MAIN, GRAD_EDGES and PROX_MAIN) and
# the split each takes: two CTAs an SM fill the card, so S=8 at m=32 (one
# CTA an SM, S=4, read FULL2D 1.5x slower: grad_ab.py --sweep on the
# H100), S=1 at m=768; past the tiles, the largest split that leaves each
# CTA two
PLAN_CASES = [
    ("FULLSP", 768, 64, 2048, 4, 1),
    ("FULLSP bf16", 768, 64, 2048, 2, 1),
    ("FULL", 32, 2000, 200, 4, 8),
    ("FULL2D", 32, 20000, 200, 4, 8),
    ("FULL2D bf16", 32, 20000, 200, 2, 8),
    ("path D step", 32, 500, 200, 4, 8),
    ("FULLSP-stochastic", 768, 32, 2048, 4, 1),
    ("ragged m=3 n=300 p=37", 3, 300, 37, 4, 1),
    ("m=1 n=1 p=5", 1, 1, 5, 4, 1),
    ("n=513 p=2047 bf16", 2, 513, 2047, 2, 8),
    ("n=33 p=4101", 2, 33, 4101, 4, 8),
    ("|pred|~1e3 m=4 n=257 p=130", 4, 257, 130, 4, 4),
    ("split ragged m=2 n=2001", 2, 2001, 200, 4, 8),
    ("split unaligned m=1 n=20000 p=37 bf16", 1, 20000, 37, 2, 8),
    ("p=16384 m=2 n=5", 2, 5, 16384, 4, 2),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_at_phase3_shapes(case):
    _, m, n, p, xb, split = case
    pl = gkernel.plan(m, n, p, xb, N_SM)
    assert pl.split == split and pl.split in gkernel.SPLITS
    assert pl.ctas == m * pl.split
    assert 1 <= pl.tile_rows <= min(n, gkernel.MAX_TILE_ROWS)
    assert pl.tile_rows <= 32 or pl.tile_rows % 32 == 0
    assert 1 <= pl.stages <= gkernel.STAGES
    assert pl.smem_bytes == gkernel.smem_bytes(p, pl.tile_rows, pl.stages, xb)
    assert pl.smem_bytes <= gkernel.MAX_SMEM
    tiles = -(-n // pl.tile_rows)
    assert pl.split == 1 or tiles >= 2 * pl.split         # two tiles a CTA
    # the smallest split that fills the card, if one does
    full = [s for s in gkernel.SPLITS
            if (s == 1 or tiles >= 2 * s)
            and m * s >= gkernel.FILL * gkernel.CTAS_PER_SM * N_SM]
    assert pl.split == (full[0] if full else max(
        s for s in gkernel.SPLITS if s == 1 or tiles >= 2 * s))


@pytest.mark.parametrize("x_bytes", [4, 2])
@pytest.mark.parametrize("p", [1, 5, 37, 130, 200, 2047, 2048, 4101, 8192,
                               gkernel.MAX_P])
def test_plan_fits_a_block_at_every_width(p, x_bytes):
    """Up to MAX_P, a plan's shared memory fits a Hopper block, with at
    least one stage of at least one row (the widest rows: one stage)."""
    for n in (1, 7, 64, 2001, 20000):
        pl = gkernel.plan(3, n, p, x_bytes, N_SM)
        assert pl.stages >= 1 and pl.tile_rows >= 1
        assert pl.smem_bytes <= gkernel.MAX_SMEM
        assert pl.tile_rows * p * x_bytes <= max(gkernel.STAGE_BYTES,
                                                 p * x_bytes)


@pytest.mark.parametrize("tile_rows", [1, 3, 32, 256])
@pytest.mark.parametrize("split", gkernel.SPLITS)
def test_row_ranges_cover_the_rows_once_in_order(split, tile_rows):
    """Brute force over n: the ranks' ranges are whole tiles, contiguous
    and in rank order, cover 0..n-1 once, stay inside the rows, differ by
    at most one tile, and leave a rank empty only when there are fewer
    tiles than ranks."""
    for n in list(range(1, 300)) + [2001, 20000]:
        ranges = gkernel.row_ranges(n, tile_rows, split)
        assert len(ranges) == split
        owner = np.full(n, -1)
        prev = 0
        for k, (a, b) in enumerate(ranges):
            assert a == prev and 0 <= a <= b <= n
            assert a % tile_rows == 0 and (b == n or b % tile_rows == 0)
            assert (owner[a:b] == -1).all()
            owner[a:b] = k
            prev = b
        assert prev == n and (owner >= 0).all()
        assert (np.diff(owner) >= 0).all()                 # in order
        tiles = [-(-(b - a) // tile_rows) for a, b in ranges]
        assert max(tiles) - min(tiles) <= 1
        assert min(tiles) > 0 or -(-n // tile_rows) < split


# (m, n, p, X dtype, split, tile rows): ragged last tiles, unaligned rows,
# more ranks than tiles (empty ranks), 16-byte rows, bf16
ORDER_CASES = [
    (2, 150, 37, "f32", 4, 32),
    (3, 70, 24, "f32", 8, 32),
    (2, 200, 16, "bf16", 2, 32),
    (2, 97, 200, "f32", 1, 32),
    (1, 300, 13, "bf16", 8, 7),
]


@pytest.mark.parametrize("case", ORDER_CASES,
                         ids=[f"m{c[0]}n{c[1]}p{c[2]}{c[3]}S{c[4]}t{c[5]}"
                              for c in ORDER_CASES])
@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_kernel_summation_order_matches_jax_kernel(case, loss):
    """The kernel's order (per rank, tiles in order in f32; the partials
    in rank order; then /n) against the reference's Pallas kernel in
    interpret mode."""
    m, n, p, x_dtype, split, tile_rows = case
    X, y, W = _inputs(m, n, p, loss, seed=5)
    Xt = torch.from_numpy(X)
    if x_dtype == "bf16":
        Xt = Xt.to(torch.bfloat16)
        X = Xt.to(torch.float32).numpy()
    Xj = jnp.asarray(X).astype(jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    want = np.asarray(jgrad.task_gradients(Xj, jnp.asarray(y), jnp.asarray(W),
                                           loss=loss))   # interpret mode
    total = order.accumulate(Xt, torch.from_numpy(y), torch.from_numpy(W),
                             loss, gkernel.row_ranges(n, tile_rows, split),
                             tile_rows)
    _close((total / n).numpy(), want)
