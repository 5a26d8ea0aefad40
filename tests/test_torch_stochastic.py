"""The port's stochastic worker path and AltMin against the JAX reference
on the same seeded data, on the simulated cluster on the CPU.

Pass criteria: ``batch_indices`` bitwise equal to the reference's (the
rows are the same draws); each stochastic solver's and AltMin's ``W``
within ``1e-4 * max(1, max|W_ref|)`` (DESIGN.md §3's solver bound) with
equal ``comm.ledger()``, ``comm.rounds`` and stochastic extras; the
degenerate ``B=n, L=1`` configuration bitwise equal to the port's own
full-batch solve; the ``torch`` local step bitwise the historical
two-step expression, and the ``kernel`` path on CPU tensors within 1e-5
of it."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import worker_ops as j_ops  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import prng, worker_ops  # noqa: E402
from repro_torch.core.losses import get_loss  # noqa: E402
from repro_torch.core.methods import MTLProblem  # noqa: E402
from repro_torch.core.methods.base import STOCHASTIC_SOLVERS  # noqa: E402
from repro_torch.data.synthetic import SimSpec, generate  # noqa: E402
from repro_torch.interop import problem_from_numpy  # noqa: E402

M, N, P, R = 12, 80, 16, 2
B, L = 16, 3
W_RTOL = 1e-4
HP = {
    "proxgd": {"lam": 0.02, "rounds": 4},
    "accproxgd": {"lam": 0.02, "rounds": 4},
    "admm": {"lam": 0.02, "rho": 0.5, "rounds": 4},
    "dgsp": {"rounds": 3},
    "dnsp": {"rounds": 3, "damping": 0.5, "l2": 1e-3},
}
PATHS = {"gram": ("squared", True), "raw": ("squared", False),
         "logistic": ("logistic", False)}


def _data(loss, seed=0):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((P, R)))[0]
    Wst = (U @ rng.standard_normal((R, M))).astype(np.float32)
    X = rng.standard_normal((M, N, P)).astype(np.float32)
    marg = np.einsum("mnp,pm->mn", X, Wst)
    if loss == "squared":
        y = marg + 0.5 * rng.standard_normal(marg.shape)
    else:
        y = np.where(rng.random(marg.shape) < 1 / (1 + np.exp(-marg)), 1.0, -1.0)
    return X, y.astype(np.float32)


_CACHE = {}


def _problems(path):
    if path not in _CACHE:
        loss, gram = PATHS[path]
        X, y = _data(loss)
        jp = JProblem.make(jnp.asarray(X), jnp.asarray(y), loss, gram=gram,
                           A=2.0, r=R)
        cache = {}
        if gram:
            cache = dict(gram_A=np.array(jp.gram_A), gram_b=np.array(jp.gram_b))
        tp = problem_from_numpy(X, y, loss, gram=gram, A=2.0, r=R,
                                device="cpu", **cache)
        _CACHE[path] = (jp, tp)
    return _CACHE[path]


def _assert_same_solve(rj, rt):
    Wj = np.asarray(rj.W)
    tol = W_RTOL * max(1.0, float(np.abs(Wj).max()))
    err = float(np.abs(rt.W.numpy() - Wj).max())
    assert err <= tol, f"max|W_port - W_ref| = {err} > {tol}"
    assert rt.comm.ledger() == rj.comm.ledger()
    assert rt.comm.rounds == rj.comm.rounds
    assert rt.rounds_axis == rj.rounds_axis


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
@pytest.mark.parametrize("n_local,batch", [(12, 4), (50, 16), (20000, 500)])
def test_batch_indices_bitwise_reference(seed, n_local, batch):
    ids = np.array([0, 1, 5, 11, 31], np.int32)
    for round_k in (0, 7):
        for step in (0, 3):
            got = worker_ops.batch_indices(seed, torch.from_numpy(ids),
                                           round_k, step, batch, n_local)
            want = j_ops.batch_indices(seed, jnp.asarray(ids), round_k, step,
                                       batch, n_local)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shard1 = worker_ops.batch_indices(seed, torch.from_numpy(ids), 2, 1,
                                      batch, n_local, shard=1)
    np.testing.assert_array_equal(
        shard1.numpy(), np.asarray(j_ops.batch_indices(
            seed, jnp.asarray(ids), 2, 1, batch, n_local, shard=1)))


def test_batch_indices_full_batch_is_natural_order():
    idx = worker_ops.batch_indices(7, torch.arange(3, dtype=torch.int32), 5,
                                   0, 8, 8)
    assert torch.equal(idx, torch.arange(8, dtype=torch.int32).expand(3, 8))


# ---------------------------------------------------------------------------
# the five stochastic solvers and AltMin against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("method", STOCHASTIC_SOLVERS)
def test_stochastic_solver_matches_reference(path, method):
    jp, tp = _problems(path)
    kw = dict(batch_size=B, local_steps=L, batch_seed=5, **HP[method])
    rj = repro.solve(jp, method=method, **kw)
    rt = repro_torch.solve(tp, method=method, device="cpu", **kw)
    _assert_same_solve(rj, rt)
    for key in ("batch_size", "local_steps"):
        assert rt.extras[key] == rj.extras[key]
    assert rt.extras.get("sv_exact_rounds") == rj.extras.get("sv_exact_rounds")


@pytest.mark.parametrize("kw", [{"rounds": 4}, {"rounds": 3, "u_grad_steps": 5}],
                         ids=["default", "u5"])
@pytest.mark.parametrize("path", list(PATHS))
def test_altmin_matches_reference(path, kw):
    jp, tp = _problems(path)
    rj = repro.solve(jp, method="altmin", **kw)
    rt = repro_torch.solve(tp, method="altmin", device="cpu", **kw)
    _assert_same_solve(rj, rt)


# ---------------------------------------------------------------------------
# degeneracy, determinism, accounting, progress
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", STOCHASTIC_SOLVERS)
def test_degenerate_config_is_bitwise_full_batch(method):
    _, tp = _problems("raw")
    full = repro_torch.solve(tp, method=method, device="cpu", **HP[method])
    degen = repro_torch.solve(tp, method=method, batch_size=N, local_steps=1,
                              device="cpu", **HP[method])
    assert torch.equal(full.W, degen.W)
    assert full.comm.ledger() == degen.comm.ledger()
    assert "batch_size" not in degen.extras


@pytest.mark.parametrize("method", ["proxgd", "dgsp"])
def test_same_seed_replays_another_seed_moves(method):
    _, tp = _problems("raw")
    kw = dict(batch_size=4, local_steps=2, device="cpu", **HP[method])
    a = repro_torch.solve(tp, method=method, batch_seed=0, **kw)
    b = repro_torch.solve(tp, method=method, batch_seed=0, **kw)
    c = repro_torch.solve(tp, method=method, batch_seed=1, **kw)
    assert torch.equal(a.W, b.W)
    assert not torch.equal(a.W, c.W)
    assert a.comm.ledger() == c.comm.ledger()


@pytest.mark.parametrize("method", STOCHASTIC_SOLVERS)
def test_stochastic_ledger_is_the_full_batch_ledger(method):
    """Local steps buy flops, never wire: the accounted quantities equal
    the full-batch solve's (the notes name the stochastic payloads)."""
    _, tp = _problems("raw")
    full = repro_torch.solve(tp, method=method, device="cpu", **HP[method])
    sgd = repro_torch.solve(tp, method=method, batch_size=4, local_steps=3,
                            device="cpu", **HP[method])
    assert [e[:4] for e in full.comm.ledger()] == \
        [e[:4] for e in sgd.comm.ledger()]
    assert sgd.extras["local_steps"] == 3


def test_stochastic_rounds_reduce_objective():
    """The reference's progress check on its own §5 problem (p=16, m=6,
    r=2, n=12 from PRNGKey(0)), generated by the port."""
    Xs, ys, *_ = generate(prng.PRNGKey(0, device="cpu"),
                          SimSpec(p=16, m=6, r=2, n=12), device="cpu")
    prob = MTLProblem.make(Xs, ys, r=2, device="cpu")
    res = repro_torch.solve(prob, method="proxgd", rounds=12, lam=0.02,
                            batch_size=8, local_steps=2, device="cpu")

    def objective(W):
        preds = torch.einsum("mnp,pm->mn", prob.Xs, W)
        return float(torch.mean((preds - prob.ys) ** 2))

    assert objective(res.W) < objective(res.iterates[0])



def test_logistic_stochastic_proxgd_ends_above_zero_risk():
    """The witness for the card's path D: stochastic logistic ProxGD at
    path D's configuration (``chip_smoke.D_SOLVES``: B=500, L=4, 10
    rounds, lam 0.01 on the reference's FULL2D draw, ``PRNGKey(3)``) with
    n cut from 20000 to 2000 lowers its objective from its start but ends
    above W=0's excess risk, in the reference and in the port alike: the
    constant-step noise floor, not a fault of the port."""
    import jax
    from repro.core.linear_model import global_loss as j_global_loss
    from repro.data.synthetic import SimSpec as JSpec
    from repro.data.synthetic import excess_risk_classification as j_risk
    from repro.data.synthetic import generate as j_generate
    from repro_torch.core.linear_model import global_loss
    from repro_torch.data.synthetic import excess_risk_classification

    spec = dict(p=200, m=32, r=5, n=2000, task="classification")
    kw = dict(method="proxgd", rounds=10, lam=0.01, batch_size=500,
              local_steps=4, batch_seed=0)
    jX, jy, jWs, jS = j_generate(jax.random.PRNGKey(3), JSpec(**spec))
    jprob = JProblem.make(jX, jy, "logistic", A=2.0, r=5)
    jres = repro.solve(jprob, **kw)
    Xs, ys, Ws, S = generate(prng.PRNGKey(3, device="cpu"), SimSpec(**spec),
                             device="cpu")
    prob = MTLProblem.make(Xs, ys, "logistic", A=2.0, r=5, device="cpu")
    res = repro_torch.solve(prob, device="cpu", **kw)
    W_ref = np.asarray(jres.W)
    assert np.abs(res.W.numpy() - W_ref).max() <= \
        W_RTOL * max(1.0, np.abs(W_ref).max())

    def j_obj(W):
        return float(j_global_loss(jprob.loss, W, jX, jy, jprob.l2)
                     + 0.01 * jnp.linalg.svd(W, compute_uv=False).sum())

    def obj(W):
        return float(global_loss(prob.loss, W, Xs, ys, prob.l2)
                     + 0.01 * torch.linalg.svdvals(W).sum())

    j_zero = float(j_risk(jax.random.PRNGKey(11), jnp.zeros_like(jres.W),
                          jWs, jS))
    j_sgd = float(j_risk(jax.random.PRNGKey(11), jres.W, jWs, jS))
    key = prng.PRNGKey(11, device="cpu")
    zero = float(excess_risk_classification(key, torch.zeros_like(res.W),
                                            Ws, S))
    sgd = float(excess_risk_classification(key, res.W, Ws, S))
    assert j_obj(jres.W) < j_obj(jres.iterates[0]) and j_sgd > j_zero
    assert obj(res.W) < obj(res.iterates[0]) and sgd > zero
    # each risk is log 2 less a mean of 640000 f32 terms near it: the
    # port's W=0 risk is within 1e-6 of the same draw evaluated in
    # float64, the reference's within 2e-5 (not 1e-5 relative)
    kx, ky = prng.split(key)
    Sd = S.double()
    X64 = prng.normal(kx, (20000, 200)).double() @ torch.linalg.cholesky(
        Sd + 1e-9 * torch.eye(200, dtype=torch.float64)).T
    marg = X64 @ Ws.double()
    y64 = torch.where(prng.uniform(ky, tuple(marg.shape)).double()
                      < torch.sigmoid(marg), 1.0, -1.0).double()
    zero64 = float(np.log(2.0) - torch.nn.functional.softplus(
        -y64 * marg).mean())
    assert zero == pytest.approx(zero64, abs=1e-6)
    assert j_zero == pytest.approx(zero64, abs=2e-5)
    assert sgd == pytest.approx(j_sgd, abs=2e-5)


# ---------------------------------------------------------------------------
# the fused local step's two paths
# ---------------------------------------------------------------------------
def _step_setup(loss_name, m=6, n=96, p=23, seed=12):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((m, n, p)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((p, m)).astype(np.float32))
    Z = torch.from_numpy(rng.standard_normal((p, m)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    if loss_name == "logistic":
        y = torch.where(y >= 0, 1.0, -1.0)
    data = {"Xs": X, "ys": y, "task_ids": torch.arange(m, dtype=torch.int32)}
    return get_loss(loss_name), W, Z, data


def test_torch_step_is_bitwise_the_historical_expression():
    m = 6
    loss, W, Z, data = _step_setup("squared")
    kw = dict(seed=0, round_k=0, local_step=0, batch_size=32)
    got = worker_ops.minibatch_prox_step_columns(
        loss, W, data, 1e-2, eta=0.3 * m, m=m, impl="torch", **kw)
    G = worker_ops.minibatch_grad_columns(loss, W, data, 1e-2, **kw) / m
    assert torch.equal(got, W - 0.3 * m * G)
    Q = Z * 0.5
    got = worker_ops.minibatch_prox_step_columns(
        loss, W, data, 1e-2, eta=0.7, m=m, Z_cols=Z, Q_cols=Q, rho=1.3,
        impl="torch", **kw)
    g = worker_ops.minibatch_grad_columns(loss, W, data, 1e-2, **kw)
    assert torch.equal(got, W - 0.7 * (g / m + Q + 1.3 * (W - Z)))


@pytest.mark.parametrize("loss_name", ["squared", "logistic"])
@pytest.mark.parametrize("admm", [False, True], ids=["descent", "admm"])
def test_kernel_step_on_cpu_agrees_with_torch(loss_name, admm):
    m = 6
    loss, W, Z, data = _step_setup(loss_name)
    kw = dict(seed=3, round_k=1, local_step=2, batch_size=32, eta=0.4, m=m)
    extra = dict(Z_cols=Z, Q_cols=0.5 * Z, rho=1.3) if admm else {}
    ref = worker_ops.minibatch_prox_step_columns(loss, W, data, 1e-2,
                                                 impl="torch", **kw, **extra)
    got = worker_ops.minibatch_prox_step_columns(loss, W, data, 1e-2,
                                                 impl="kernel", **kw, **extra)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol
