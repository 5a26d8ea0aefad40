"""The port's full-batch worker ops (``repro_torch.core.worker_ops``)
against the JAX reference on the same seeded inputs, on the CPU.

Each port implementation is held to its reference counterpart: ``gram``
to ``gram``, ``kernel`` (the ``mtl_grad`` plain version on the CPU) to
``pallas`` (interpret mode), ``torch`` to ``xla``.  Tolerance: 1e-5
absolute and relative, the reference's own worker-op bound
(``tests/test_kernels.py``).  The Gram cache is the reference's, handed
over as numpy, so each op is tested on the same bytes."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

from repro.core import worker_ops as jwo  # noqa: E402
from repro.core.losses import get_loss as jloss  # noqa: E402
from repro_torch.core import worker_ops as two  # noqa: E402
from repro_torch.core.losses import get_loss as tloss  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
M, N, P = 4, 60, 10
LOSSES = ["squared", "logistic"]
L2S = [0.0, 1e-3]


def _data(loss, gram, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, N, P)).astype(np.float32)
    y = rng.standard_normal((M, N)).astype(np.float32)
    if loss == "logistic":
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    W = (0.3 * rng.standard_normal((P, M))).astype(np.float32)
    jd = {"Xs": jnp.asarray(X), "ys": jnp.asarray(y)}
    td = {"Xs": torch.from_numpy(X), "ys": torch.from_numpy(y)}
    if gram:
        A, b = (np.array(a) for a in jwo.gram_stats(jd["Xs"], jd["ys"]))
        jd["gram_A"], jd["gram_b"] = jnp.asarray(A), jnp.asarray(b)
        td["gram_A"], td["gram_b"] = torch.from_numpy(A), torch.from_numpy(b)
    return jd, td, W


def _cases():
    """(loss, l2, gram): every loss on the raw path, the squared loss on
    the Gram path too."""
    return [(loss, l2, gram) for loss in LOSSES for l2 in L2S
            for gram in (False, True) if not gram or loss == "squared"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_gram_stats_match():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((M, N, P)).astype(np.float32)
    y = rng.standard_normal((M, N)).astype(np.float32)
    Aj, bj = jwo.gram_stats(jnp.asarray(X), jnp.asarray(y))
    At, bt = two.gram_stats(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(_np(At), _np(Aj), **TOL)
    np.testing.assert_allclose(_np(bt), _np(bj), **TOL)
    # the 2-D layout's Gram: a sum of per-shard partial Grams
    Aj, bj = jwo.gram_stats(jnp.asarray(X), jnp.asarray(y), data_shards=2)
    At, bt = two.gram_stats(torch.from_numpy(X), torch.from_numpy(y),
                            data_shards=2)
    np.testing.assert_allclose(_np(At), _np(Aj), **TOL)
    np.testing.assert_allclose(_np(bt), _np(bj), **TOL)


GRAD_IMPLS = [("gram", "gram"), ("kernel", "pallas"), ("torch", "xla")]
GRAD_CASES = [(impl, ref, loss, l2) for impl, ref in GRAD_IMPLS
              for loss in LOSSES for l2 in L2S
              if impl != "gram" or loss == "squared"]   # Gram: squared only


@pytest.mark.parametrize("impl,ref_impl,loss,l2", GRAD_CASES)
def test_grad_columns(impl, ref_impl, loss, l2):
    jd, td, W = _data(loss, gram=impl == "gram")
    want = jwo.grad_columns(jloss(loss), jnp.asarray(W), jd, l2, impl=ref_impl)
    got = two.grad_columns(tloss(loss), torch.from_numpy(W), td, l2, impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("loss", LOSSES)
def test_default_dispatch_on_the_cpu(loss):
    """A CPU tensor takes ``torch`` (the reference's CPU takes ``xla``);
    the Gram cache wins for the squared loss."""
    _, td, _ = _data(loss, gram=False)
    assert two._resolve_impl(tloss(loss), td, None) == "torch"
    if loss == "squared":
        _, tdg, _ = _data(loss, gram=True)
        assert two._resolve_impl(tloss(loss), tdg, None) == "gram"
    assert two._resolve_impl(tloss(loss), td, "kernel") == "kernel"
    with pytest.raises(ValueError, match="unknown gradient impl"):
        two.grad_columns(tloss(loss), torch.zeros(P, M), td, impl="pallas")


@pytest.mark.parametrize("loss,l2,gram", _cases())
def test_newton_columns(loss, l2, gram):
    jd, td, W = _data(loss, gram)
    want = jwo.newton_columns(jloss(loss), jnp.asarray(W), jd, l2, damping=1e-4)
    got = two.newton_columns(tloss(loss), torch.from_numpy(W), td, l2,
                             damping=1e-4)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("l2", [1e-3, 1e-2])
def test_ridge_columns(l2):
    jd, td, _ = _data("squared", gram=True)
    np.testing.assert_allclose(_np(two.ridge_columns(td, l2)),
                               _np(jwo.ridge_columns(jd, l2)), **TOL)


@pytest.mark.parametrize("loss,l2,gram", _cases())
def test_erm_columns(loss, l2, gram):
    l2 = max(l2, 1e-6)                   # Local's floor: an ERM needs one
    jd, td, _ = _data(loss, gram)
    want = jwo.erm_columns(jloss(loss), jd, l2)
    got = two.erm_columns(tloss(loss), td, l2)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("loss,l2,gram", _cases())
def test_prox_columns(loss, l2, gram):
    jd, td, W = _data(loss, gram)
    rng = np.random.default_rng(7)
    Z = (0.3 * rng.standard_normal((P, M))).astype(np.float32)
    Q = (0.01 * rng.standard_normal((P, M))).astype(np.float32)
    want = jwo.prox_columns(jloss(loss), jd, jnp.asarray(Z), jnp.asarray(Q),
                            jnp.asarray(W), 0.5, M, l2)
    got = two.prox_columns(tloss(loss), td, torch.from_numpy(Z),
                           torch.from_numpy(Q), torch.from_numpy(W), 0.5, M, l2)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("loss,l2,gram", _cases())
def test_projected_solves(loss, l2, gram):
    jd, td, _ = _data(loss, gram)
    rng = np.random.default_rng(8)
    U = np.linalg.qr(rng.standard_normal((P, 3)))[0].astype(np.float32)
    U = np.concatenate([U, np.zeros((P, 2), np.float32)], axis=1)  # masked
    Wj, Vj = jwo.projected_solves(jloss(loss), jnp.asarray(U), jd, l2)
    Wt, Vt = two.projected_solves(tloss(loss), torch.from_numpy(U), td, l2)
    np.testing.assert_allclose(_np(Wt), _np(Wj), **TOL)
    np.testing.assert_allclose(_np(Vt), _np(Vj), **TOL)
