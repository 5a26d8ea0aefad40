"""The port's Fig-4 surrogates (``repro_torch.data.realworld``) against
the JAX reference, on the CPU, at the published App. H shapes and the
keys ``benchmarks/fig4_real.py`` draws them from (``PRNGKey(300 + i)``).

Pass criteria:
* the specs, ``prng.permutation``, ``split_tasks``, ``take_tasks``, the
  seven surrogate keys and the label coins are bitwise the reference's;
* X (train and test) and the regression labels within 1e-5 of their
  largest magnitude (the normal draws agree to ~2.5e-7 relative);
* a classification label may differ only where its coin lands within
  ``TIE`` of ``sigmoid(margin)``, below the margins' rounding; the flips
  are counted and each is checked;
* ``test_metric`` within 1e-6 of max(1, |metric|), on the reference's
  arrays fed to both, and the rank AUC on tied scores exactly;
* two of fig4's methods, a few rounds each, on one regression and one
  classification surrogate (the reference's arrays fed to both
  packages): ``max|W_port - W_ref| <= 1e-4 * max(1, max|W_ref|)`` and
  equal ledgers.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # benchmarks/

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.fig4_real import METHODS  # noqa: E402
import repro.data.realworld as J  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
from repro.core.methods import get_solver as jget_solver  # noqa: E402
from repro_torch.core import prng  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.methods import MTLProblem  # noqa: E402
from repro_torch.data import realworld as T  # noqa: E402

DRAW_RTOL = 1e-5
METRIC_RTOL = 1e-6
W_RTOL = 1e-4          # DESIGN.md §3's solver bound
# a label coin within this of sigmoid(margin) may land on either side:
# the margins agree to ~1e-6 of their scale, and sigmoid' <= 1/4
TIE = 1e-5
FEW_ROUNDS = 4
# fig4's spectral and greedy sharing methods (the whole METHODS list
# runs on the card, in chip_smoke.py's phase 9d)
PARITY_METHODS = ("proxgd", "dgsp")
NAMES = list(J.REAL_SPECS)


@pytest.fixture(scope="module")
def draws():
    """Each surrogate from both packages, as numpy; the reference's
    drawn under one ``jit`` a spec (the eager draw compiles every op)."""
    gen = jax.jit(J.generate_surrogate, static_argnums=1)
    out = {}
    for i, name in enumerate(NAMES):
        ref = gen(jax.random.PRNGKey(300 + i), J.REAL_SPECS[name])
        port = T.generate_surrogate(prng.PRNGKey(300 + i, device="cpu"),
                                    T.REAL_SPECS[name], device="cpu")
        out[name] = ([np.asarray(a) for a in ref], [a.numpy() for a in port])
    return out


def test_specs_are_the_references():
    assert list(T.REAL_SPECS) == NAMES
    for name in NAMES:
        assert dataclasses.asdict(T.REAL_SPECS[name]) == \
            dataclasses.asdict(J.REAL_SPECS[name])


@pytest.mark.parametrize("n", [1, 2, 19, 1625, 1626])
def test_permutation_is_bitwise(n):
    """Up to n = 1625 one sort round, from 1626 two."""
    for seed in (0, 1, 300):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                 n))
        got = prng.permutation(prng.PRNGKey(seed, device="cpu"), n).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_split_and_take_tasks_are_the_references():
    for m, holdout, seed in ((72, 10, 0), (19, 4, 3), (180, 30, 7), (6, 1, 1)):
        want = J.split_tasks(m, holdout, seed=seed)
        got = T.split_tasks(m, holdout, seed=seed, device="cpu")
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())
    with pytest.raises(ValueError):
        T.split_tasks(5, 5, device="cpu")
    x = np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2)
    ids = T.split_tasks(5, 2, device="cpu")[1]
    (ref,) = J.take_tasks(jnp.asarray(ids.numpy()), jnp.asarray(x))
    (got,) = T.take_tasks(ids, torch.from_numpy(x))
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("i,name", list(enumerate(NAMES)))
def test_surrogate_keys_and_coins_are_bitwise(i, name):
    spec = T.REAL_SPECS[name]
    want = np.asarray(jax.random.split(jax.random.PRNGKey(300 + i), 7))
    keys = T.surrogate_keys(prng.PRNGKey(300 + i, device="cpu"))
    assert np.array_equal(keys.numpy().astype(np.uint32), want)
    if spec.task == "classification":
        for k, n in ((4, spec.n), (6, 3 * spec.n)):
            u = prng.uniform(keys[k], (spec.m, n)).numpy()
            ref = np.asarray(jax.random.uniform(jnp.asarray(want[k]),
                                                (spec.m, n)))
            assert np.array_equal(u, ref)


@pytest.mark.parametrize("name", NAMES)
def test_features_and_regression_labels(draws, name):
    ref, port = draws[name]
    spec = T.REAL_SPECS[name]
    parts = [0, 2] + ([1, 3] if spec.task == "regression" else [])
    for j in parts:
        assert port[j].shape == ref[j].shape and port[j].dtype == np.float32
        scale = float(np.abs(ref[j]).max())
        err = float(np.abs(port[j] - ref[j]).max())
        assert err <= DRAW_RTOL * scale, (j, err, scale)


def test_classification_labels_flip_only_at_near_ties(draws):
    """~58,000 labels over the three classification surrogates: each one
    that differs from the reference's must be a near-tie of its coin and
    ``sigmoid(margin)``."""
    labels, flips = 0, []
    for i, name in enumerate(NAMES):
        spec = T.REAL_SPECS[name]
        if spec.task != "classification":
            continue
        ref, port = draws[name]
        key = prng.PRNGKey(300 + i, device="cpu")
        keys = T.surrogate_keys(key)
        W = T.surrogate_predictor(key, spec)
        for X, y, yr, k in ((port[0], port[1], ref[1], 4),
                            (port[2], port[3], ref[3], 6)):
            assert set(np.unique(y)) <= {-1.0, 1.0}
            labels += y.size
            u = prng.uniform(keys[k], y.shape).numpy()
            pr = torch.sigmoid(torch.einsum(
                "mnp,pm->mn", torch.from_numpy(X), W)).numpy()
            for idx in zip(*np.nonzero(y != yr)):
                flips.append((name, idx, abs(float(u[idx] - pr[idx]))))
    assert labels == 58000
    assert all(gap <= TIE for _, _, gap in flips), flips
    print(f"{len(flips)} of {labels} labels flipped, all near-ties")


@pytest.mark.parametrize("name", NAMES)
def test_metric_is_the_references(draws, name):
    ref, _ = draws[name]
    spec = T.REAL_SPECS[name]
    rng = np.random.default_rng(sorted(NAMES).index(name))
    for W in (rng.standard_normal((spec.p, spec.m)).astype(np.float32),
              np.zeros((spec.p, spec.m), np.float32)):
        want = float(J.test_metric(spec.task, jnp.asarray(W),
                                   jnp.asarray(ref[2]), jnp.asarray(ref[3])))
        got = T.test_metric(spec.task, torch.from_numpy(W),
                            torch.from_numpy(ref[2].copy()),
                            torch.from_numpy(ref[3].copy()))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= METRIC_RTOL * max(1.0, abs(want))


def test_rank_auc_on_ties_and_single_class_rows():
    rng = np.random.default_rng(5)
    scores = rng.integers(0, 4, (6, 40)).astype(np.float32)
    labels = np.where(rng.random((6, 40)) < 0.5, 1.0, -1.0).astype(
        np.float32)
    labels[4] = 1.0                       # one class only: 0.5
    labels[5] = -1.0
    want = np.asarray(jax.vmap(J._auc)(jnp.asarray(scores),
                                       jnp.asarray(labels)))
    got = T._auc(torch.from_numpy(scores), torch.from_numpy(labels)).numpy()
    assert np.array_equal(got, want)
    assert got[4] == got[5] == 0.5


@pytest.mark.parametrize("name", ["school", "landmine"])
def test_fig4_methods_match_the_reference(draws, name):
    ref, _ = draws[name]
    spec = T.REAL_SPECS[name]
    loss = "squared" if spec.task == "regression" else "logistic"
    jp = JProblem.make(jnp.asarray(ref[0]), jnp.asarray(ref[1]), loss,
                       A=3.0, r=spec.r)
    tp = MTLProblem.make(ref[0].copy(), ref[1].copy(), loss, A=3.0,
                         r=spec.r, device="cpu")
    for method, kw in METHODS:
        if method not in PARITY_METHODS:
            continue
        kw = dict(kw, **({"rounds": FEW_ROUNDS} if "rounds" in kw else {}))
        rj = jget_solver(method)(jp, **kw)
        rt = repro_torch.solve(tp, method=method, device="cpu", **kw)
        Wj = np.asarray(rj.W)
        tol = W_RTOL * max(1.0, float(np.abs(Wj).max()))
        err = float(np.abs(rt.W.numpy() - Wj).max())
        assert err <= tol, (method, err, tol)
        assert rt.comm.ledger() == rj.comm.ledger(), method
