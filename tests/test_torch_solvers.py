"""The port's ten full-batch solvers behind ``repro_torch.solve`` against
the JAX reference on the same seeded data, on the CPU.

Pass criteria, per solver and path (squared Gram, squared raw, logistic):
``max|W_port - W_ref| <= 1e-4 * max(1, max|W_ref|)`` (DESIGN.md §3's
solver bound), ``comm.ledger()`` and ``rounds_axis`` equal, and the lazy
spectral engine's ``sv_exact_rounds`` equal (same branch every round).
The problem has n > p, so every per-task solve is well conditioned, and
m > r + 8, so the lazy engine engages.  The Fig-1 case runs both
packages at the paper's base spec on the draw ``chip_smoke.py`` uses and
holds each to the reference's claims."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # chip_smoke.py and benchmarks/

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import repro  # noqa: E402
from benchmarks.fig1_regression import METHODS, check_claims  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
from repro.data.synthetic import excess_risk_regression  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.methods import MTLProblem, solver_names  # noqa: E402
from repro_torch.interop import problem_from_numpy, sv_carry_from_numpy  # noqa: E402

M, N, P, R = 12, 80, 16, 2      # n = 5p: no task is separable
W_RTOL = 1e-4


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
    return X, y.astype(np.float32), U.astype(np.float32)


PATHS = {"gram": ("squared", True), "raw": ("squared", False),
         "logistic": ("logistic", False)}


def _problems(path):
    loss, gram = PATHS[path]
    X, y, U = _data(loss)
    jp = JProblem.make(jnp.asarray(X), jnp.asarray(y), loss, gram=gram,
                       A=2.0, r=R)
    cache = {}
    if gram:
        cache = dict(gram_A=np.array(jp.gram_A), gram_b=np.array(jp.gram_b))
    tp = problem_from_numpy(X, y, loss, gram=gram, A=2.0, r=R, device="cpu",
                            **cache)
    return jp, tp, U


SOLVERS = [
    ("local", {}),
    ("centralize", {"lam": 0.02, "iters": 60}),
    ("bestrep", {}),
    ("svd_trunc", {}),
    ("proxgd", {"lam": 0.02, "rounds": 10}),
    ("accproxgd", {"lam": 0.02, "rounds": 10, "record_every": 3}),
    ("admm", {"lam": 0.02, "rho": 0.5, "rounds": 10}),
    ("dfw", {"rounds": 10, "record_every": 2}),
    ("dgsp", {"rounds": 6}),
    ("dnsp", {"rounds": 6, "damping": 0.5, "l2": 1e-3}),
]


def _assert_same_solve(rj, rt):
    Wj = np.asarray(rj.W)
    tol = W_RTOL * max(1.0, float(np.abs(Wj).max()))
    err = float(np.abs(rt.W.numpy() - Wj).max())
    assert err <= tol, f"max|W_port - W_ref| = {err} > {tol}"
    assert rt.comm.ledger() == rj.comm.ledger()
    assert rt.comm.rounds == rj.comm.rounds
    assert rt.rounds_axis == rj.rounds_axis
    assert rt.extras.get("sv_exact_rounds") == rj.extras.get("sv_exact_rounds")


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("method,kw", SOLVERS, ids=[s for s, _ in SOLVERS])
def test_solver_matches_reference(path, method, kw):
    jp, tp, U = _problems(path)
    extra = {"U_star": U} if method == "bestrep" else {}
    rj = repro.solve(jp, method=method, **kw, **extra)
    rt = repro_torch.solve(tp, method=method, device="cpu", **kw, **extra)
    _assert_same_solve(rj, rt)
    assert rt.extras["loss"] == PATHS[path][0]
    assert rt.extras["backend"] == "sim" and rt.extras["data_shards"] == 1
    assert rt.extras["collective_floats_per_chip"] == 0


def test_lazy_engine_engages_on_this_problem():
    """The prox family above runs the lazy master: one cold exact round,
    the rest accepted lazily (else the sv_exact_rounds check is void)."""
    _, tp, _ = _problems("gram")
    res = repro_torch.solve(tp, method="proxgd", lam=0.02, rounds=10,
                            device="cpu")
    assert res.extras["sv_engine"] == "lazy"
    assert 1 <= res.extras["sv_exact_rounds"] < 10


@pytest.mark.parametrize("method", ["proxgd", "admm", "centralize", "svd_trunc"])
def test_exact_engine_matches_reference(method):
    jp, tp, _ = _problems("raw")
    kw = dict(SOLVERS)[method]
    rj = repro.solve(jp, method=method, sv_engine="exact", **kw)
    rt = repro_torch.solve(tp, method=method, sv_engine="exact", device="cpu",
                           **kw)
    _assert_same_solve(rj, rt)


def test_warm_sv_carry_crosses_from_the_reference():
    """A reference solve's final W and spectral carry, handed over as
    numpy, warm-start the port's next solve as they warm the reference's."""
    jp, tp, _ = _problems("gram")
    kw = dict(lam=0.02, rounds=4)
    first = repro.solve(jp, method="proxgd", keep_sv_carry=True, **kw)
    carry = {k: np.array(v) for k, v in first.extras["sv_carry"].items()}
    W0 = np.array(first.W)
    rj = repro.solve(jp, method="proxgd", init_W=jnp.asarray(W0),
                     sv_carry=first.extras["sv_carry"], **kw)
    rt = repro_torch.solve(tp, method="proxgd", init_W=W0,
                           sv_carry=sv_carry_from_numpy(carry, device="cpu"),
                           device="cpu", **kw)
    _assert_same_solve(rj, rt)
    assert rt.extras["sv_exact_rounds"] >= int(carry["exact_rounds"])


def test_registry_and_what_is_not_ported(tmp_path):
    assert solver_names() == sorted(repro.core.solver_names())
    jp, tp, _ = _problems("gram")
    # the mesh backend: on a group of this process alone it is the sim,
    # bit for bit, with the collective floats of its one rank
    import mesh_worlds
    kw = dict(method="proxgd", lam=0.02, rounds=4, device="cpu")
    sim = repro_torch.solve(tp, **kw)
    with mesh_worlds.one_rank_group(tmp_path):
        mesh = repro_torch.solve(tp, backend="mesh", **kw)
    assert torch.equal(mesh.W, sim.W)
    assert mesh.comm.ledger() == sim.comm.ledger()
    assert mesh.extras["backend"] == "mesh"
    assert mesh.extras["collective_floats_per_chip"] == \
        sim.comm.floats_by_direction("worker->master") * M
    # the data axis: the sim's 2-D emulation against the reference's
    rj = repro.solve(jp, method="proxgd", lam=0.02, rounds=4, data_shards=2)
    rt = repro_torch.solve(tp, data_shards=2, **kw)
    _assert_same_solve(rj, rt)
    assert rt.extras["data_shards"] == 2
    assert rt.extras["data_collective_floats_per_chip"] == 0
    # recovery: a checkpointed solve writes its store and equals the
    # plain solve bitwise
    store = tmp_path / "ckpt"
    seg = repro_torch.solve(tp, ckpt_dir=str(store), checkpoint_every=3,
                            **kw)
    assert torch.equal(seg.W, sim.W)
    assert seg.comm.ledger() == sim.comm.ledger()
    assert sorted(p.name for p in store.iterdir()) == [
        "MANIFEST.json", "problem.npz", "step_00000003.npz",
        "step_00000004.npz"]
    assert seg.extras["checkpoint"]["segments_run"] == 2
    # device round metrics: per-round arrays in extras["metrics"]
    bare = repro_torch.solve(tp, method="dgsp", rounds=4, device="cpu")
    inst = repro_torch.solve(tp, method="dgsp", rounds=4, metrics=True,
                             device="cpu")
    assert torch.equal(inst.W, bare.W)
    assert inst.extras["metrics"]["round"].tolist() == [1, 2, 3, 4]
    assert inst.extras["metrics"]["grad_norm"].shape == (4,)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        repro_torch.solve(tp, method="dgsp", verify="static", device="cpu")
    with pytest.raises(ValueError, match="full-batch only"):
        repro_torch.solve(tp, method="dfw", batch_size=N, device="cpu")


def test_full_batch_stochastic_config_runs_the_exact_body():
    """batch_size == n with local_steps == 1 IS the full-batch solver."""
    _, tp, _ = _problems("raw")
    a = repro_torch.solve(tp, method="dgsp", rounds=3, device="cpu")
    b = repro_torch.solve(tp, method="dgsp", rounds=3, batch_size=N,
                          local_steps=1, device="cpu")
    assert torch.equal(a.W, b.W) and a.comm.ledger() == b.comm.ledger()


def test_problem_and_solve_stay_on_the_asked_device():
    _, tp, _ = _problems("gram")
    assert tp.device.type == "cpu" and tp.gram_A.device.type == "cpu"
    with pytest.raises(ValueError, match="lies on"):
        repro_torch.solve(tp, method="local", device="meta")
    X, y, _ = _data("squared")
    p2 = MTLProblem.make(X, y, "squared", device="cpu")
    np.testing.assert_allclose(p2.gram_A.numpy(), tp.gram_A.numpy(),
                               atol=1e-5, rtol=1e-5)
    assert p2.nuclear_radius == float(np.float32(np.sqrt(np.float32(5 * M))))


def test_factorize_serves_on_the_solve_device():
    _, tp, _ = _problems("gram")
    res = repro_torch.solve(tp, method="dgsp", rounds=4, device="cpu")
    model = res.factorize(R)
    assert model.device.type == "cpu" and model.loss == "squared"
    assert model.rank == R and model.m == M and model.p == P


def test_fig1_claims_hold_in_both_packages():
    """The paper's base spec (p=100, m=30, r=5, n=50) on chip_smoke's
    seeded draw: the reference's ten methods pass the reference's
    ``check_claims``, and the port's pass ``chip_smoke.check_claims`` (a
    copy of it)."""
    assert METHODS == chip_smoke.FIG1_METHODS
    Xs, ys, Wst, Sig = (t.numpy() for t in chip_smoke.sim_data(
        **chip_smoke.FIG1, seed=chip_smoke.FIG1_SEED, device="cpu"))
    jp = JProblem.make(jnp.asarray(Xs), jnp.asarray(ys), "squared", A=2.0, r=5)
    from repro.serve.mtl import FactoredModel as JFactored
    jcurves = {}
    for name, kw in METHODS:
        extra = {"U_star": JFactored.from_W(jnp.asarray(Wst), 5).U} \
            if name == "bestrep" else {}
        res = repro.solve(jp, method=name, **kw, **extra)
        jcurves[name] = [(rnd, float(excess_risk_regression(
            W, jnp.asarray(Wst), jnp.asarray(Sig))))
            for rnd, W in zip(res.rounds_axis, res.iterates)]
    check_claims(jcurves, "reference")

    tp = problem_from_numpy(Xs, ys, "squared", A=2.0, r=5, device="cpu",
                            gram_A=np.array(jp.gram_A),
                            gram_b=np.array(jp.gram_b))
    from repro_torch.serve.mtl import FactoredModel
    U_star = FactoredModel.from_W(Wst, 5, device="cpu").U
    tcurves = chip_smoke.fig1_curves(
        lambda prob, **kw: repro_torch.solve(prob, device="cpu", **kw), tp,
        torch.from_numpy(Wst), torch.from_numpy(Sig), U_star)
    chip_smoke.check_claims(tcurves, "port")
    assert {k: [r for r, _ in v] for k, v in tcurves.items()} == \
        {k: [r for r, _ in v] for k, v in jcurves.items()}
