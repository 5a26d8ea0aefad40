"""Preemption-safe solves in the port (``repro_torch.runtime.recovery``),
within the port and against the JAX reference, on the CPU.

Within the port (bitwise): a solve checkpointed every 4 of its 11 rounds,
a resume from its first segment after the later ones were deleted (the
stale-manifest rollback), and a resume of the finished store all equal
the uninterrupted solve: ``W``, every iterate, ``comm.ledger()`` and both
collective-float counters.  On the sim's 1-D and 2-D layouts, for the
reference's ProxGD (its spectral carry rides in the state) and for
solvers with worker-sharded state, Newton steps, a host-int spectral
carry and stochastic rounds.  Config drift is refused, and a corrupt
newest segment falls back one segment (tests/test_recovery.py:58-110).
The mesh layouts run in the gloo worlds of ``tests/mesh_worlds.py``
(``test_torch_mesh*.py``).

Against the reference: ``segment_bounds``, ``template_hash`` and
``solve_fingerprint`` give its strings on the same inputs; a store the
port writes carries the reference's fingerprint for the same call; and a
resumed port solve equals the reference's uninterrupted solve within the
solver bound ``1e-4 * max(1, max|W|)`` (DESIGN.md §3), with equal
ledgers.  The problem is the reference's ``SimSpec(p=16, m=8, r=3,
n=32)`` draw, which the port's threefry reproduces
(``repro_torch.faults.demo_problem``).
"""
import json
import os
import pathlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.faults import demo_problem as ref_problem  # noqa: E402
from repro.runtime import recovery as jrec  # noqa: E402
from repro.runtime.base import make_runtime as ref_runtime  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.faults import corrupt_npz, demo_problem  # noqa: E402
from repro_torch.runtime import recovery as trec  # noqa: E402
from repro_torch.runtime.base import make_runtime  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

W_RTOL = 1e-4
KW = dict(method="proxgd", lam=0.05, rounds=11, record_every=3)
# solvers beside ProxGD: sharded worker state (DGSP, ADMM), Newton steps
# (DNSP), a carry leaf with transposed strides (AltMin's U), momentum
# (AccProxGD), and the stochastic rounds (seeded draws, local steps)
MORE = {"altmin": dict(method="altmin", rounds=7),
        "dgsp": dict(method="dgsp", rounds=7),
        "dnsp": dict(method="dnsp", rounds=7, damping=0.5, l2=1e-3),
        "admm": dict(method="admm", lam=0.05, rounds=7),
        "accproxgd-sgd": dict(method="accproxgd", lam=0.05, rounds=7,
                              batch_size=8, local_steps=2)}


def _prob():
    return demo_problem("cpu")


def _assert_identical(base, other):
    assert torch.equal(base.W, other.W)
    assert base.comm.ledger() == other.comm.ledger()
    assert base.rounds_axis == other.rounds_axis
    assert len(base.iterates) == len(other.iterates)
    for a, b in zip(base.iterates, other.iterates):
        assert torch.equal(a, b)
    for key in ("collective_floats_per_chip",
                "data_collective_floats_per_chip"):
        assert base.extras[key] == other.extras[key], key


def _kill_after_first_segment(d):
    for s in checkpoint.available_steps(d)[1:]:
        os.remove(os.path.join(d, f"step_{s:08d}.npz"))


@pytest.mark.parametrize("data_shards", [1, 2], ids=["1d", "2d"])
def test_sim_segmented_and_resumed_bitidentical(tmp_path, data_shards):
    base = repro_torch.solve(_prob(), data_shards=data_shards, device="cpu",
                             **KW)
    d = str(tmp_path / "store")
    seg = repro_torch.solve(_prob(), data_shards=data_shards,
                            checkpoint_every=4, ckpt_dir=d, device="cpu", **KW)
    _assert_identical(base, seg)
    assert seg.extras["checkpoint"]["segments_run"] == 3
    assert checkpoint.available_steps(d) == [4, 8, 11]

    # a mid-solve kill: only the first segment survives
    _kill_after_first_segment(d)
    with pytest.warns(UserWarning, match="rolling back"):
        res = repro_torch.resume(d, device="cpu")
    _assert_identical(base, res)
    assert res.extras["checkpoint"]["resumed_from"] == 4
    assert res.extras["checkpoint"]["rolled_back_from"] == 11
    assert res.extras["checkpoint"]["segments_run"] == 2

    # resuming a FINISHED store runs no round and gives the same result
    done = repro_torch.resume(d, device="cpu")
    _assert_identical(base, done)
    assert done.extras["checkpoint"]["segments_run"] == 0
    assert done.extras["checkpoint"]["resumed_from"] == 11


@pytest.mark.parametrize("data_shards", [1, 2], ids=["1d", "2d"])
@pytest.mark.parametrize("name", sorted(MORE))
def test_sim_resume_bitidentical_across_solvers(tmp_path, name, data_shards):
    kw = MORE[name]
    base = repro_torch.solve(_prob(), data_shards=data_shards, device="cpu",
                             **kw)
    d = str(tmp_path / "store")
    seg = repro_torch.solve(_prob(), data_shards=data_shards,
                            checkpoint_every=3, ckpt_dir=d, device="cpu", **kw)
    _assert_identical(base, seg)
    _kill_after_first_segment(d)
    with pytest.warns(UserWarning, match="rolling back"):
        res = repro_torch.resume(d, device="cpu")
    _assert_identical(base, res)
    assert res.extras["checkpoint"]["resumed_from"] == 3
    for key in ("sv_exact_rounds", "U", "mask"):
        if key in base.extras:
            a, b = base.extras[key], res.extras[key]
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) \
                else a == b, key


def test_resume_rejects_config_drift(tmp_path):
    d = str(tmp_path / "store")
    repro_torch.solve(_prob(), checkpoint_every=4, ckpt_dir=d, device="cpu",
                      **KW)
    with pytest.raises(checkpoint.CheckpointError, match="DIFFERENT"):
        repro_torch.solve(_prob(), checkpoint_every=4, ckpt_dir=d,
                          method="dgsp", rounds=11, record_every=3,
                          device="cpu")


def test_corrupt_segment_falls_back_one_segment(tmp_path):
    base = repro_torch.solve(_prob(), device="cpu", **KW)
    d = str(tmp_path / "store")
    repro_torch.solve(_prob(), checkpoint_every=4, ckpt_dir=d, device="cpu",
                      **KW)
    corrupt_npz(os.path.join(d, "step_00000011.npz"), seed=0)
    with pytest.warns(UserWarning, match="skipping corrupt"):
        res = repro_torch.resume(d, device="cpu")
    _assert_identical(base, res)
    assert res.extras["checkpoint"]["resumed_from"] == 8
    assert res.extras["checkpoint"]["skipped_corrupt"] == [11]


def _lazy_prob():
    """A problem on which the lazy spectral engine engages (K = r + 8 <
    min(p, m)), so its carry holds the basis and two host ints."""
    from repro_torch.core import prng
    from repro_torch.core.methods import MTLProblem
    from repro_torch.data.synthetic import SimSpec, generate
    Xs, ys, _, _ = generate(prng.PRNGKey(1, device="cpu"),
                            SimSpec(p=24, m=16, r=3, n=30), device="cpu")
    return MTLProblem.make(Xs, ys, "squared", A=2.0, r=3, device="cpu")


def test_the_same_solve_call_picks_up_the_store(tmp_path):
    """Re-issuing the killed ``solve`` call resumes instead of starting
    over; a store keeps ``ckpt_keep`` segments; the lazy engine's carry
    (basis, spectrum, tail block and its two host ints) comes back in
    full, with its strides."""
    kw = dict(KW, sv_engine="lazy")
    base = repro_torch.solve(_lazy_prob(), device="cpu", **kw)
    assert base.extras["sv_exact_rounds"] >= 1 and base.extras[
        "sv_engine"] == "lazy"
    d = str(tmp_path / "store")
    repro_torch.solve(_lazy_prob(), checkpoint_every=2, ckpt_dir=d,
                      ckpt_keep=2, device="cpu", **kw)
    assert checkpoint.available_steps(d) == [10, 11]
    os.remove(os.path.join(d, "step_00000011.npz"))
    with pytest.warns(UserWarning, match="rolling back"):
        again = repro_torch.solve(_lazy_prob(), checkpoint_every=2,
                                  ckpt_dir=d, ckpt_keep=2, device="cpu", **kw)
    _assert_identical(base, again)
    assert again.extras["sv_exact_rounds"] == base.extras["sv_exact_rounds"]
    assert again.extras["checkpoint"]["resumed_from"] == 10
    _, tree = checkpoint.load_checkpoint(d, 11)
    meta = json.loads(tree["meta_json"].numpy().tobytes())
    kinds = [leaf["kind"] for leaf in meta["carry_layout"]]
    # W, then the engine's T, V, exact_rounds, s, warm
    assert kinds == ["tensor", "tensor", "tensor", "int", "tensor", "int"]
    with pytest.raises(ValueError, match="needs ckpt_dir"):
        repro_torch.solve(_prob(), checkpoint_every=2, device="cpu", **KW)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounds,every", [(11, 4), (11, 3), (10, 10),
                                          (7, 25), (1, 1)])
def test_segment_bounds_are_the_references(rounds, every):
    assert trec.segment_bounds(rounds, every) == \
        jrec.segment_bounds(rounds, every)
    with pytest.raises(ValueError):
        trec.segment_bounds(rounds, 0)


@pytest.mark.parametrize("data_shards", [1, 2], ids=["1d", "2d"])
@pytest.mark.parametrize("method,kw", [
    ("proxgd", dict(lam=0.05, rounds=3)), ("dgsp", dict(rounds=3)),
    ("admm", dict(lam=0.05, rounds=3)), ("altmin", dict(rounds=2)),
    ("proxgd", dict(lam=0.05, rounds=3, batch_size=8, local_steps=2))],
    ids=["proxgd", "dgsp", "admm", "altmin", "proxgd-sgd"])
def test_template_hash_is_the_references(method, kw, data_shards):
    """The per-round template each package records on the sim hashes to
    the same string (no event of these templates is recorded inside a
    loop, so even ``repeats`` agree)."""
    rj = ref_runtime("sim", ref_problem(), data_shards=data_shards)
    rt = make_runtime("sim", _prob(), data_shards=data_shards)
    repro.solve(rj.prob, method=method, runtime=rj, **kw)
    repro_torch.solve(rt.prob, method=method, runtime=rt, device="cpu", **kw)
    assert rt._template and [e.note for e in rt._template] == \
        [e.note for e in rj._template]
    assert trec.template_hash(rt._template, rt._data_template) == \
        jrec.template_hash(rj._template, rj._data_template)


def test_solve_fingerprint_and_store_are_the_references(tmp_path):
    """The same call writes a store with the same fingerprint in both
    packages (the reference's digest of the problem's bytes and of the
    config, array hyper-parameters by their digest)."""
    jp = ref_problem()
    X, y = np.asarray(jp.Xs), np.asarray(jp.ys)
    from repro_torch.core.methods import MTLProblem
    tp = MTLProblem.make(X, y, "squared", A=2.0, r=3, device="cpu")
    W0 = np.linspace(-1, 1, 16 * 8, dtype=np.float32).reshape(16, 8)
    cfg = {"method": "proxgd", "backend": "sim", "axis": "tasks",
           "data_axis": "data", "data_shards": 1, "checkpoint_every": 4,
           "ckpt_keep": 3, "hp": dict(KW, init_W=W0)}
    want = jrec.solve_fingerprint(jp, cfg)
    assert trec.solve_fingerprint(tp, cfg) == want
    cfg["hp"]["init_W"] = torch.from_numpy(W0)     # the port's own arrays
    assert trec.solve_fingerprint(tp, cfg) == want
    kw = dict(KW, lam=0.05)
    kw.pop("method")
    repro.solve(jp, method="proxgd", checkpoint_every=4,
                ckpt_dir=str(tmp_path / "ref"), **kw)
    repro_torch.solve(tp, method="proxgd", checkpoint_every=4,
                      ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    man = {k: json.loads((tmp_path / k / "MANIFEST.json").read_text())
           for k in ("ref", "port")}
    assert man["port"]["fingerprint"] == man["ref"]["fingerprint"]
    for key in ("problem", "config", "hp", "latest"):
        assert man["port"][key] == man["ref"][key], key
    assert checkpoint.available_steps(str(tmp_path / "port")) == \
        checkpoint.available_steps(str(tmp_path / "ref"))


@pytest.mark.parametrize("data_shards", [1, 2], ids=["1d", "2d"])
def test_resumed_solve_matches_the_reference(tmp_path, data_shards):
    rj = repro.solve(ref_problem(), data_shards=data_shards, **KW)
    d = str(tmp_path / "store")
    repro_torch.solve(_prob(), data_shards=data_shards, checkpoint_every=4,
                      ckpt_dir=d, device="cpu", **KW)
    _kill_after_first_segment(d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the rollback warning
        res = repro_torch.resume(d, device="cpu")
    Wj = np.asarray(rj.W)
    err = float(np.abs(res.W.numpy() - Wj).max())
    assert err <= W_RTOL * max(1.0, float(np.abs(Wj).max())), err
    assert res.comm.ledger() == rj.comm.ledger()
    assert res.rounds_axis == rj.rounds_axis
    for a, b in zip(res.iterates, rj.iterates):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=W_RTOL * max(1.0, float(np.abs(Wj).max())))
    assert res.extras.get("sv_exact_rounds") == \
        rj.extras.get("sv_exact_rounds")


def test_the_reference_reads_the_ports_store_and_problem(tmp_path):
    """The reference's ``load_store`` rebuilds the problem from a store
    the port wrote, and the reference's checkpoint reader verifies the
    port's segment files."""
    d = str(tmp_path / "store")
    tp = _prob()
    repro_torch.solve(tp, checkpoint_every=4, ckpt_dir=d, device="cpu", **KW)
    jp, man, hp = jrec.load_store(d)
    np.testing.assert_array_equal(np.asarray(jp.Xs), tp.Xs.numpy())
    assert man["config"]["method"] == "proxgd" and hp == {
        k: v for k, v in KW.items() if k != "method"}
    from repro.train import checkpoint as jck
    step, tree = jck.load_checkpoint(d)
    assert step == 11 and "meta_json" in tree
    assert jnp.asarray(tree["carry"][0]).shape == (16, 8)
