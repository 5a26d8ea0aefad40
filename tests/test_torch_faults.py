"""The port's fault harness (``repro_torch.faults``): real process deaths
of CPU solves, each recovered by ONE resume to a result bit-identical to
the uninterrupted solve (tests/test_recovery.py:211-250).

Every child is a subprocess of ``python -m repro_torch.faults`` with one
intra-op thread and a time limit of at most 120 s; the fault plan reaches
it only through its own environment (``REPRO_TORCH_FAULT_PLAN``), never
through this process's; every store lies under ``tmp_path``.  The
multi-process case starts two gloo ranks on a ``file://`` store, kills
the last after its second durable segment, kills the other at once, and
resumes with a fresh launch.  Last, the harness must have left no plan in
this process's environment and no armed hook in either package.
"""
import json
import os
import pathlib
import shutil
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import repro.faults as jfaults  # noqa: E402
import repro.train.checkpoint as jck  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402


def _env():
    """This process's environment, less the variable pytest itself
    rewrites for every test."""
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


ENV_BEFORE = _env()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    work = tmp_path_factory.mktemp("faults")
    return {r["kind"]: r for r in faults.run_cases(
        [{"kind": k} for k in faults.KINDS], str(work), device="cpu")}


@pytest.mark.parametrize("kind", faults.KINDS)
def test_fault_kind_recovered_exactly_once(reports, kind):
    """Each planned fault kills a real subprocess solve; ONE resume
    reproduces the uninterrupted baseline bit for bit (W, iterates,
    ledger, both collective-float counters, rounds)."""
    report = reports[kind]
    assert report["killed"] and report["exit_code"] == -9, report
    assert report["bit_identical"] and report["recovered"], report
    # segments end at 3, 6, 9, 11: the kinds die after segment 2 (sigkill),
    # inside the write of segment 2 (crash_rename), or after segment 3 with
    # segment 3 then damaged (corrupt, stale_manifest)
    want = {"sigkill": 6, "crash_rename": 3, "corrupt": 6,
            "stale_manifest": 6}[kind]
    assert report["resumed_from"] == want
    assert report["rounds"] == faults.SOLVE_KW["rounds"]


def test_crash_rename_leaves_no_partial_step(reports):
    """The crash_rename fault dies between the npz write and the rename:
    the store shows the orphan tmp file and NO truncated step; the resume
    completed the store."""
    store = reports["crash_rename"]["store"]
    names = os.listdir(store)
    assert any(n.endswith(".tmp") for n in names), names
    steps = checkpoint.available_steps(store)
    assert steps and steps[-1] == 11
    for s in steps:
        checkpoint.load_checkpoint(store, s)          # every step verifies


def test_multiprocess_kill_one_rank_and_resume(tmp_path):
    report = faults.run_multiprocess_case(str(tmp_path), nprocs=2,
                                          device="cpu")
    assert report["killed"] and report["exit_codes"][-1] == -9, report
    assert report["bit_identical"] and report["recovered"], report
    assert report["resumed_from"] == 6
    assert not list(tmp_path.glob("*.rendezvous.tmp*"))


def _set_latest(store, step):
    """Point the store's MANIFEST at ``step``, atomically, as rank 0
    does after a durable save."""
    tmp = store / "MANIFEST.json.tmp"
    tmp.write_text(json.dumps({"latest": step}))
    os.replace(tmp, store / "MANIFEST.json")


def test_a_rank_that_does_not_write_dies_only_after_the_segment_lands(
        tmp_path):
    """The hook's wait, in process: a non-writer returns once the
    MANIFEST names the step (written by a thread ~0.3 s later), raises
    when the bound passes first, and the writer never waits."""
    _set_latest(tmp_path, 3)
    writer = threading.Timer(0.3, _set_latest, (tmp_path, 6))
    t0 = time.monotonic()
    writer.start()
    try:
        faults._wait_durable(str(tmp_path), 6, writer=False, timeout=10.0)
    finally:
        writer.join(timeout=10.0)
    assert not writer.is_alive()
    assert 0.25 <= time.monotonic() - t0 < 10.0
    with pytest.raises(RuntimeError, match="segment 9 never became durable"):
        faults._wait_durable(str(tmp_path), 9, writer=False, timeout=0.3)
    t0 = time.monotonic()
    faults._wait_durable(str(tmp_path / "nowhere"), 9, writer=True,
                         timeout=0.0)
    assert time.monotonic() - t0 < 0.1


def test_plans_and_damage_are_the_references(tmp_path):
    for kind in faults.KINDS:
        plan, ref = faults.FaultPlan(kind), jfaults.FaultPlan(kind)
        assert plan.event == ref.event and plan.to_env() == ref.to_env()
        assert faults.AFTER[kind] == {"sigkill": 2, "crash_rename": 2,
                                      "corrupt": 3, "stale_manifest": 3}[kind]
    assert faults.PLAN_ENV == "REPRO_TORCH_FAULT_PLAN" != jfaults._PLAN_ENV
    assert (faults.SOLVE_KW, faults.CHECKPOINT_EVERY) == \
        (jfaults.SOLVE_KW, jfaults.CHECKPOINT_EVERY)
    src = tmp_path / "a.npz"
    np.savez(src, x=np.arange(4096, dtype=np.float32))
    for mode in ("flip", "truncate"):
        a, b = tmp_path / f"port_{mode}", tmp_path / f"ref_{mode}"
        shutil.copy(src, a)
        shutil.copy(src, b)
        faults.corrupt_npz(str(a), seed=3, mode=mode)
        jfaults.corrupt_npz(str(b), seed=3, mode=mode)
        assert a.read_bytes() == b.read_bytes() != src.read_bytes()
    with pytest.raises(ValueError, match="unknown corruption mode"):
        faults.corrupt_npz(str(src), mode="melt")


def test_harness_arguments_are_checked(tmp_path):
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.run_case("meteor", workdir=str(tmp_path))
    with pytest.raises(TypeError):
        faults.run_case("sigkill")                # no workdir
    with pytest.raises(ValueError, match="at most"):
        faults.run_case("sigkill", workdir=str(tmp_path), timeout=600)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.arm(faults.FaultPlan("meteor"))


def test_arm_in_this_process():
    """A plan on an event that never fires changes nothing here."""
    faults.arm(faults.FaultPlan("sigkill", at_event="never fires"))
    try:
        assert checkpoint._fault_hook is not None
        checkpoint._fire("segment_saved", step=1)
        checkpoint._fire("pre_rename", step=1)
    finally:
        checkpoint._fault_hook = None


def test_no_plan_left_behind(reports):
    """After the cases: this process's environment is as it was, holds no
    plan of either package, and neither checkpoint hook is armed."""
    assert all(r["recovered"] for r in reports.values())
    assert _env() == ENV_BEFORE
    assert faults.PLAN_ENV not in os.environ
    assert jfaults._PLAN_ENV not in os.environ
    assert checkpoint._fault_hook is None and jck._fault_hook is None
