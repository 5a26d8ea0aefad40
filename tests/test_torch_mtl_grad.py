"""The port's per-task gradients (``repro_torch.kernels.mtl_grad``) against
the JAX reference, on the CPU: the plain version against the reference's
Pallas kernel in interpret mode and its oracle, against autograd of the
mean loss, and the wrapper's checks.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.

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
from repro_torch.kernels.mtl_grad import ops  # noqa: E402
from repro_torch.kernels.mtl_grad.ref import task_gradients_ref  # noqa: E402

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
