"""The port's §5 simulation data (``repro_torch.data.synthetic``) against
the reference's ``repro.data.synthetic`` from the same key, on the CPU.

Pass criteria: Sigma and the classification labels exact (the labels'
coin flips are uniform draws, bitwise the reference's); ``Xs``, ``W*``
and regression ``ys`` within ``DATA_TOL * max(1, max|ref|)`` (the normal
draws differ by ~2.5e-7 relative, see ``test_torch_prng.py``; the
largest gap seen at these specs is 7.2e-7); the excess risks within
1e-5 relative."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax  # noqa: E402

from repro.data import synthetic as ref  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

DATA_TOL = 2e-6
RISK_RTOL = 1e-5
SPEC = dict(p=12, m=5, r=2, n=20)


def _close(port, want, tol=DATA_TOL):
    want = np.asarray(want)
    gap = float(np.abs(port.numpy() - want).max())
    assert gap <= tol * max(1.0, float(np.abs(want).max())), gap


def _both(task, chunks, seed=3, **kw):
    spec = dict(SPEC, task=task, **kw)
    a = ref.generate(jax.random.PRNGKey(seed), ref.SimSpec(**spec),
                     sample_chunks=chunks)
    b = synthetic.generate(prng.PRNGKey(seed, device="cpu"),
                           synthetic.SimSpec(**spec), sample_chunks=chunks,
                           device="cpu")
    return a, b


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_generate_matches_reference(task, chunks):
    (Xj, yj, Wj, Sj), (Xt, yt, Wt, St) = _both(task, chunks)
    for t in (Xt, yt, Wt, St):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert tuple(Xt.shape) == (5, 20, 12) and tuple(yt.shape) == (5, 20)
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    _close(Xt, Xj)
    _close(Wt, Wj)
    if task == "classification":
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    else:
        _close(yt, yj)


def test_correlated_setup_and_noise():
    """Fig 3's highly correlated features (c = 0.1) and another noise."""
    (Xj, yj, _, Sj), (Xt, yt, _, St) = _both("regression", 1, seed=11,
                                             corr_decay=0.1, noise=0.3)
    _close(St, Sj, 1e-6)
    _close(Xt, Xj)
    _close(yt, yj)


def test_chunked_draw_differs_from_one_key_draw():
    (_, _, _, _), (X1, _, _, _) = _both("regression", 1)
    (_, _, _, _), (X2, _, _, _) = _both("regression", 2)
    assert not torch.equal(X1, X2)
    with pytest.raises(ValueError, match="sample_chunks"):
        synthetic.generate(prng.PRNGKey(0, device="cpu"),
                           synthetic.SimSpec(**SPEC), sample_chunks=3,
                           device="cpu")


def test_excess_risks_match_reference():
    (_, _, Wj, Sj), (_, _, Wt, St) = _both("regression", 1)
    rng = np.random.default_rng(0)
    W = rng.standard_normal(Wt.shape).astype(np.float32) * 0.3
    want = float(ref.excess_risk_regression(W, Wj, Sj))
    got = float(synthetic.excess_risk_regression(torch.from_numpy(W), Wt, St))
    assert abs(got - want) <= RISK_RTOL * abs(want)
    want = float(ref.excess_risk_classification(jax.random.PRNGKey(9), W, Wj,
                                                Sj, n_test=4000))
    got = float(synthetic.excess_risk_classification(
        prng.PRNGKey(9, device="cpu"), torch.from_numpy(W), Wt, St,
        n_test=4000))
    assert abs(got - want) <= RISK_RTOL * abs(want)


def test_generate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is legitimate here")
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.generate(prng.PRNGKey(0, device="cpu"),
                           synthetic.SimSpec(**SPEC))
