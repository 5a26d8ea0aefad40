"""Preemption-safe solves and the multi-process bring-up of the mesh.

Port of ``repro.runtime.recovery``.  A solver's round loop is a pure
carry, ``state_{k+1} = body(k, state_k, data)``, with the data and the
per-round communication template the same in every round.  So a killed
solve can be resumed EXACTLY: persist the whole carry (solver state, the
spectral engine's carry, the snapshot histories, the ledger cursor and
the template) at segment boundaries and run the remaining rounds from
the same round indices.  The resumed solve's final ``W``, CommLog ledger
and collective-float counters are bit-identical to an uninterrupted
solve's on both backends and every layout.

The carry is everything a round reads besides the data: the state dict
the solver hands to ``run_rounds``.  The spectral master keeps its lazy
state there in full (``ShrinkEngine``'s basis ``V``, Ritz spectrum
``s``, tail block ``T`` and its two host ints ``warm`` and
``exact_rounds``); ``leading_sv`` starts each call from a probe made
from its input and keeps no state between rounds.  Each tensor is
restored with the strides it had when it was saved, so the kernels and
BLAS calls of the remaining rounds see the same layouts.

Layout of a solve store (one directory per solve), the reference's::

    ckpt_dir/
      MANIFEST.json        solve config + problem/config fingerprint +
                           "latest" segment pointer (atomic rewrite)
      problem.npz          the MTLProblem's arrays (so ``resume`` is a
                           one-argument front door)
      step_XXXXXXXX.npz    one checkpoint per completed segment
                           (``train.checkpoint``: atomic, content-hashed,
                           corrupt files detected and skipped)

:func:`resume` rebuilds the problem, restarts from the newest INTACT
segment (corrupt or rolled-back newer steps are skipped with a warning,
the stale-manifest case), replays the ledger of the completed rounds
from the STORED template, then checks the template of the first round it
runs against the stored hash, so a config drift cannot produce a
wrong-but-plausible ledger.

Checkpoints are written by rank 0 only (:func:`is_primary`); every rank
computes the same carry, the replicated master makes it so.

Multi-process bring-up: :func:`init_cluster` starts the
``torch.distributed`` group the mesh runs on.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import socket
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..obs.tracing import emit_event as obs_event, trace_span
from ..train import checkpoint as ckpt_store
from ..train.checkpoint import CheckpointError
from .base import _DataEvent, _WireEvent

# Segment length when ``ckpt_dir`` is given without ``checkpoint_every``:
# a preemption loses little work, and the per-segment host sync and npz
# write stay a small share of a solve.
DEFAULT_SEGMENT = 25

MANIFEST = "MANIFEST.json"
PROBLEM_NPZ = "problem.npz"

# (world group, its collective timeout) as ``init_cluster`` started it:
# the mesh builders give every subgroup the same timeout
_STARTED: Optional[tuple] = None


# ----------------------------------------------------------------------
# small utilities
# ----------------------------------------------------------------------
def is_primary() -> bool:
    """True on the process that owns the checkpoint writes: rank 0 of
    the process group, or the only process when there is none."""
    return (not dist.is_available() or not dist.is_initialized()
            or dist.get_rank() == 0)


def _write_json_atomic(path: str, obj: Dict[str, Any]) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(value) -> List[Any]:
    """The leaves of a state entry (a tensor, a host number, or a dict
    of them), dict keys in sorted order, as ``jax.tree.flatten`` orders
    a dict."""
    if isinstance(value, dict):
        return [leaf for k in sorted(value) for leaf in _leaves(value[k])]
    return [value]


def _rebuild(like, leaves):
    """``like``'s structure with the leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def template_hash(template: List[_WireEvent],
                  data_template: List[_DataEvent]) -> str:
    """sha256 over the per-round communication template, the solve's
    protocol fingerprint.  A resumed solve records its template anew and
    must reproduce the stored hash, proving the ledger continuation
    extends the SAME protocol the killed solve was running."""
    blob = json.dumps(
        [[dataclasses.asdict(e) for e in template],
         [dataclasses.asdict(e) for e in data_template]],
        sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def segment_bounds(rounds: int, every: int) -> List[Tuple[int, int]]:
    """The (start, end) round ranges of each checkpointed segment."""
    if every < 1:
        raise ValueError(f"checkpoint_every={every} must be >= 1")
    return [(s, min(s + every, rounds)) for s in range(0, rounds, every)]


# ----------------------------------------------------------------------
# manifest + problem persistence (the `resume` front door's food)
# ----------------------------------------------------------------------
def solve_fingerprint(prob, config: Dict[str, Any]) -> str:
    """sha256 binding a store to ONE (problem, solve-config) pair, so a
    different problem or method cannot silently resume from a stale
    store directory (the reference's digest, byte for byte)."""
    h = hashlib.sha256()
    for arr in (prob.Xs, prob.ys):
        a = np.ascontiguousarray(_numpy(arr))
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(json.dumps({"loss": prob.loss.name, "A": prob.A,
                         "r": prob.r, "l2": prob.l2,
                         "gram": prob.gram_A is not None},
                        sort_keys=True).encode())
    h.update(_config_json(config).encode())
    return h.hexdigest()


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _config_json(config: Dict[str, Any]) -> str:
    """Canonical JSON of the solve config; array hyper-parameters are
    replaced by a content digest (their values live in problem.npz)."""
    def enc(v):
        if _is_array(v):
            a = np.ascontiguousarray(_numpy(v))
            return {"__array_digest__":
                    hashlib.sha256(a.tobytes()).hexdigest()}
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v

    def walk(o):
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [walk(v) for v in o]
        return enc(o)
    return json.dumps(walk(config), sort_keys=True)


def write_store(ckpt_dir: str, prob, config: Dict[str, Any]) -> None:
    """Create (or validate) a solve store's MANIFEST.json + problem.npz.

    An existing manifest must fingerprint-match the requested solve:
    resuming a DIFFERENT problem or config from a stale directory is an
    error, not a silent wrong answer.
    """
    fp = solve_fingerprint(prob, config)
    man_path = os.path.join(ckpt_dir, MANIFEST)
    if os.path.exists(man_path):
        man = _read_json(man_path)
        if man.get("fingerprint") != fp:
            raise CheckpointError(
                f"{ckpt_dir} already holds a solve store for a DIFFERENT "
                f"problem/config (fingerprint {man.get('fingerprint', '?')[:12]}"
                f"… vs requested {fp[:12]}…) — refusing to mix stores; "
                f"use a fresh ckpt_dir or resume(ckpt_dir) with no "
                f"overrides")
        return
    if not is_primary():
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {"Xs": _numpy(prob.Xs), "ys": _numpy(prob.ys)}
    hp_meta = {}
    for k, v in config.get("hp", {}).items():
        if _is_array(v):
            arrays[f"hp_{k}"] = _numpy(v)
            hp_meta[k] = {"__hp_array__": f"hp_{k}"}
        elif isinstance(v, np.integer):
            hp_meta[k] = int(v)
        elif isinstance(v, np.floating):
            hp_meta[k] = float(v)
        else:
            hp_meta[k] = v
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(ckpt_dir, PROBLEM_NPZ))
    man = {
        "version": 1,
        "fingerprint": fp,
        "latest": None,               # newest completed segment's step
        "problem": {"loss": prob.loss.name, "A": prob.A, "r": prob.r,
                    "l2": prob.l2, "gram": prob.gram_A is not None},
        "config": {k: v for k, v in config.items() if k != "hp"},
        "hp": hp_meta,
    }
    _write_json_atomic(man_path, man)


def load_store(ckpt_dir: str, device: DeviceLike = None):
    """Rebuild ``(problem, manifest, hp)`` from a solve store, the
    problem and the array hyper-parameters on ``device`` (default: the
    card)."""
    man_path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(man_path):
        raise FileNotFoundError(f"no {MANIFEST} in {ckpt_dir} — not a "
                                f"solve store (repro_torch.solve(..., "
                                f"ckpt_dir=) creates one)")
    man = _read_json(man_path)
    with np.load(os.path.join(ckpt_dir, PROBLEM_NPZ)) as data:
        arrays = {k: data[k] for k in data.files}
    from ..core.methods.base import MTLProblem
    dev = resolve_device(device)
    pm = man["problem"]
    prob = MTLProblem.make(arrays["Xs"], arrays["ys"],
                           loss_name=pm["loss"], gram=pm["gram"],
                           A=pm["A"], r=pm["r"], l2=pm["l2"], device=dev)
    hp = {}
    for k, v in man.get("hp", {}).items():
        if isinstance(v, dict) and "__hp_array__" in v:
            hp[k] = torch.from_numpy(arrays[v["__hp_array__"]]).to(dev)
        else:
            hp[k] = v
    return prob, man, hp


def _touch_manifest_latest(ckpt_dir: str, step: int) -> None:
    man_path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(man_path):
        return
    man = _read_json(man_path)
    man["latest"] = int(step)
    _write_json_atomic(man_path, man)


# ----------------------------------------------------------------------
# the segmented driver
# ----------------------------------------------------------------------
def _layout(leaf) -> Dict[str, Any]:
    """How to restore one carry leaf: a host int or float, or a tensor
    with these strides."""
    if isinstance(leaf, torch.Tensor):
        return {"kind": "tensor", "stride": list(leaf.stride())}
    if isinstance(leaf, (bool, int)):
        return {"kind": "int"}
    return {"kind": "float"}


def _restore(like, saved: torch.Tensor, layout: Dict[str, Any]):
    """One carry leaf from its saved tensor, checked against the
    solver-built leaf ``like`` and laid out with the saved strides."""
    if layout["kind"] != "tensor":
        if isinstance(like, torch.Tensor):
            raise CheckpointError("checkpoint carry holds a host number "
                                  "where the solver state holds a tensor")
        return int(saved) if layout["kind"] == "int" else float(saved)
    if not isinstance(like, torch.Tensor) or \
            tuple(like.shape) != tuple(saved.shape) or \
            like.dtype != saved.dtype:
        got = (f"{tuple(like.shape)}/{like.dtype}"
               if isinstance(like, torch.Tensor) else type(like).__name__)
        raise CheckpointError(
            f"checkpoint carry leaf {tuple(saved.shape)}/{saved.dtype} "
            f"does not match solver state {got} — config drift")
    return torch.empty_strided(saved.shape, layout["stride"],
                               dtype=saved.dtype,
                               device=like.device).copy_(saved)


class SolveCheckpointer:
    """Drives ONE solve's round loop in checkpointed segments.

    Attached to a runtime as ``rt._ckpt`` by ``repro_torch.solve(...,
    ckpt_dir=)``; ``run_rounds`` hands its whole drive here.  The drive
    keeps the uninterrupted driver's semantics exactly: the same round
    indices into the body, the same template accounting, the same
    snapshot cadence, plus a persisted carry at every segment boundary
    and a bit-identical restart from the newest intact one.
    """

    def __init__(self, ckpt_dir: str, every: int = DEFAULT_SEGMENT,
                 keep: Optional[int] = 3):
        if every < 1:
            raise ValueError(f"checkpoint_every={every} must be >= 1")
        self.ckpt_dir = ckpt_dir
        self.every = int(every)
        self.keep = keep
        self._resume: Optional[Dict[str, Any]] = None
        self.info: Dict[str, Any] = {"dir": ckpt_dir, "every": self.every,
                                     "resumed_from": 0, "segments_run": 0,
                                     "skipped_corrupt": [],
                                     "rolled_back_from": None}

    # -- resume state ---------------------------------------------------
    def load_resume(self) -> bool:
        """Pick up the newest intact segment, if any.  Corrupt newer
        steps are skipped (warned); a manifest whose ``latest`` pointer
        outruns the intact steps on disk (the stale-manifest crash)
        rolls back to what verifies."""
        if not ckpt_store.available_steps(self.ckpt_dir):
            return False
        step, tree, skipped = ckpt_store.load_latest_intact(self.ckpt_dir)
        self.info["skipped_corrupt"] = skipped
        man_path = os.path.join(self.ckpt_dir, MANIFEST)
        if os.path.exists(man_path):
            latest = _read_json(man_path).get("latest")
            if latest is not None and latest != step:
                warnings.warn(
                    f"solve store manifest points at step {latest} but the "
                    f"newest INTACT checkpoint is step {step} — rolling "
                    f"back (stale manifest after a partial failure)")
                self.info["rolled_back_from"] = latest
                obs_event("recovery.rollback", ckpt_dir=self.ckpt_dir,
                          manifest_step=int(latest), restored_step=int(step))
        meta = json.loads(_numpy(tree["meta_json"]).tobytes())
        self._resume = {"step": step, "meta": meta, "tree": tree}
        self.info["resumed_from"] = meta["rounds_done"]
        obs_event("recovery.segment_restored", ckpt_dir=self.ckpt_dir,
                  step=int(step), rounds_done=int(meta["rounds_done"]),
                  skipped_corrupt=list(skipped))
        return True

    # -- persistence ----------------------------------------------------
    def _persist(self, rt, end: int, rounds: int, state, local, hist,
                 records, count_rounds: bool, tmpl_hash: str) -> None:
        """Save the carry after round ``end``: ``state`` is the global
        state (gathered on every rank), ``local`` this rank's."""
        final = end == rounds
        if is_primary():
            with trace_span("ckpt.save", step=int(end), final=bool(final),
                            ckpt_dir=self.ckpt_dir):
                leaves = [leaf for k in sorted(state)
                          for leaf in _leaves(state[k])]
                layout = [_layout(leaf) for k in sorted(local)
                          for leaf in _leaves(local[k])]
                tree: Dict[str, Any] = {"carry": [_numpy(x) for x in leaves]}
                # per-spec snapshot histories: the snap rounds plus one
                # stacked array per leaf of the recorded value
                for i, _ in enumerate(records):
                    if not hist[i]:
                        continue
                    tree[f"snap_rounds_{i}"] = np.asarray(
                        [t for t, _ in hist[i]], np.int64)
                    flat = [_leaves(v) for _, v in hist[i]]
                    for j in range(len(flat[0])):
                        tree[f"snaps_{i}_{j}"] = np.stack(
                            [_numpy(fs[j]) for fs in flat])
                meta = {
                    "version": 1,
                    "rounds": int(rounds),
                    "rounds_done": int(end),
                    "count_rounds": bool(count_rounds),
                    "record": [{"every": r.every, "key": r.key}
                               for r in records] or None,
                    "template": [dataclasses.asdict(e)
                                 for e in rt._template],
                    "data_template": [dataclasses.asdict(e)
                                      for e in rt._data_template],
                    "template_hash": tmpl_hash,
                    "carry_layout": layout,
                }
                tree["meta_json"] = np.frombuffer(
                    json.dumps(meta, sort_keys=True).encode(),
                    np.uint8).copy()
                ckpt_store.save_checkpoint(self.ckpt_dir, end, tree,
                                           keep=self.keep)
                _touch_manifest_latest(self.ckpt_dir, end)
        # the fault hook fires on EVERY process (a preemption does not
        # politely pick the writer) once this process's part is done:
        # on rank 0 after the store write is durable, on the others at
        # once, without waiting for rank 0 (faults._wait_durable makes a
        # planned death there wait for the segment)
        ckpt_store._fire("segment_saved", step=end, ckpt_dir=self.ckpt_dir,
                         final=final)

    def _restored(self, rt, state, sharded, records, hist):
        """The stored carry as this rank's local state, and the stored
        snapshot histories appended to ``hist``; checks the store
        against the solver-built ``state``."""
        meta, tree = self._resume["meta"], self._resume["tree"]
        loaded = tree.get("carry", [])
        n_want = sum(len(_leaves(v)) for v in state.values())
        if len(loaded) != n_want:
            raise CheckpointError(
                f"checkpoint carry has {len(loaded)} leaves; the solver "
                f"built {n_want} — config drift")
        dev = rt.prob.device
        moved = iter([x.to(dev) for x in loaded])
        local = rt._local_state({k: _rebuild(state[k], moved)
                                 for k in sorted(state)}, sharded)
        like = rt._local_state(state, sharded)
        layouts = iter(meta["carry_layout"])
        out = {}
        for k in sorted(local):
            fixed = [_restore(a, b, next(layouts))
                     for a, b in zip(_leaves(like[k]), _leaves(local[k]))]
            out[k] = _rebuild(local[k], iter(fixed))
        for i, r in enumerate(records):
            ts = tree.get(f"snap_rounds_{i}")
            if ts is None:
                continue
            n_leaves = len(_leaves(state[r.key]))
            bufs = [tree[f"snaps_{i}_{j}"].to(dev) for j in range(n_leaves)]
            for si, t in enumerate(ts.tolist()):
                hist[i].append((int(t), _rebuild(
                    state[r.key], iter([b[si] for b in bufs]))))
        return out

    # -- the drive ------------------------------------------------------
    def drive(self, rt, rounds: int, body, state, sharded, records,
              count_rounds: bool):
        # the data first: its once-a-solve Gram-cache accounting must not
        # depend on how many segments run (a resume with no rounds left
        # still charges setup, as any solve does)
        data = rt._round_data()
        snap_sets = [set(r.snap_rounds(rounds)) for r in records]
        # per-spec snapshot histories: hist[i] = [(round t, value)]
        hist: List[List[Tuple[int, Any]]] = [[] for _ in records]
        start, stored_hash = 0, None

        if self._resume is not None:
            meta = self._resume["meta"]
            if meta["rounds"] != rounds:
                raise CheckpointError(
                    f"checkpoint in {self.ckpt_dir} was written by a "
                    f"{meta['rounds']}-round solve; this solve runs "
                    f"{rounds} rounds — config drift, refusing to resume")
            want_rec = [{"every": r.every, "key": r.key}
                        for r in records] or None
            if meta["record"] != want_rec:
                raise CheckpointError(
                    f"checkpoint snapshot cadence {meta['record']} does "
                    f"not match this solve's {want_rec} — config drift")
            start = meta["rounds_done"]
            stored_hash = meta["template_hash"]
            local = self._restored(rt, state, sharded, records, hist)
            # ledger catch-up: replay the completed rounds from the
            # STORED template, event for event the uninterrupted ledger
            rt._template = [_WireEvent(**d) for d in meta["template"]]
            rt._data_template = [_DataEvent(**d)
                                 for d in meta["data_template"]]
            for _ in range(start):
                rt._replay_round(count_rounds)
        else:
            local = rt._local_state(state, sharded)

        ends = {e for _, e in segment_bounds(rounds, self.every)}
        fresh_hash = stored_hash
        for t in range(start, rounds):
            local = rt._run_body(body, t, local, data, first=t == start)
            if t == start:
                fresh_hash = template_hash(rt._template, rt._data_template)
                if stored_hash is not None and fresh_hash != stored_hash:
                    raise CheckpointError(
                        f"resumed solve recorded a DIFFERENT per-round "
                        f"communication template (hash {fresh_hash[:12]}… "
                        f"vs stored {stored_hash[:12]}…) — the protocol "
                        f"changed between the killed solve and this "
                        f"resume; the ledger continuation would be "
                        f"meaningless")
            rt._replay_round(count_rounds)
            for i, r in enumerate(records):
                if t in snap_sets[i]:
                    hist[i].append((t, rt._global_entry(
                        local[r.key], r.key in sharded)))
            if t + 1 in ends:
                glob = {k: rt._global_entry(v, k in sharded)
                        for k, v in local.items()}
                self._persist(rt, t + 1, rounds, glob, local, hist, records,
                              count_rounds, fresh_hash)
                self.info["segments_run"] += 1

        for i, r in enumerate(records):
            for t, v in sorted(hist[i], key=lambda kv: kv[0]):
                r.sink.record(t + 1, v)
        return {k: rt._global_entry(v, k in sharded)
                for k, v in local.items()}


# ----------------------------------------------------------------------
# multi-process bring-up
# ----------------------------------------------------------------------
def world_timeout() -> datetime.timedelta:
    """The collective timeout ``init_cluster`` gave the current world
    group; raises if the group was started some other way."""
    if _STARTED is None or _STARTED[0] is not dist.group.WORLD:
        raise RuntimeError("the torch.distributed process group was not "
                           "started by init_cluster, so its timeout is "
                           "unknown: start it with init_cluster")
    return _STARTED[1]


def _coordinator_up(address: str, timeout_s: float) -> bool:
    """Whether the TCP coordinator at ``host:port`` accepts connections."""
    host, _, port = address.rpartition(":")
    try:
        with socket.create_connection((host, int(port)), timeout=timeout_s):
            return True
    except OSError:
        return False


def init_cluster(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, *,
                 timeout_s: float = 60.0, backoff_s: float = 0.5,
                 retries: int = 5, device: DeviceLike = None) -> None:
    """``torch.distributed.init_process_group`` for one rank of the mesh
    runtime, with coordinator retry and exponential backoff.

    ``device`` picks the backend and is the card by default (raising
    without one): NCCL for ``cuda`` (the rank's card becomes the current
    device), gloo for ``cpu``.  ``coordinator_address`` is ``host:port``
    of process 0, or a ``file://`` path that every rank can reach (a
    file store, which opens no port).  The coordinator may come up later
    than its workers under a real launcher, so a worker waits for the
    TCP coordinator to accept connections, retrying ``retries`` times
    with waits of ``backoff_s * 2**attempt``, before it joins.
    ``timeout_s`` bounds the join and every later collective of the
    group and of the mesh subgroups built on it (:func:`world_timeout`).

    Arguments default to the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment
    variables, so one script serves every rank.
    """
    coordinator_address = coordinator_address or \
        os.environ.get("REPRO_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("REPRO_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("REPRO_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_cluster needs coordinator_address, "
                         "num_processes and process_id (arguments or "
                         "REPRO_* environment)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_cluster runs on 'cuda' or 'cpu', not "
                         f"{dev.type!r}")
    tcp = "://" not in coordinator_address
    init_method = (f"tcp://{coordinator_address}" if tcp
                   else coordinator_address)
    global _STARTED
    timeout = datetime.timedelta(seconds=timeout_s)
    last = None
    for attempt in range(retries + 1):
        if not tcp or process_id == 0 or \
                _coordinator_up(coordinator_address, backoff_s):
            try:
                dist.init_process_group(
                    backend, init_method=init_method,
                    world_size=num_processes, rank=process_id,
                    timeout=timeout)
                _STARTED = (dist.group.WORLD, timeout)
                return
            except Exception as e:        # coordinator gone, or busy
                last = e
        else:
            last = ConnectionRefusedError(
                f"no coordinator at {coordinator_address} yet")
        if attempt == retries:
            break
        time.sleep(backoff_s * (2 ** attempt))
    raise RuntimeError(
        f"could not join the torch.distributed cluster at "
        f"{coordinator_address} as process {process_id}/{num_processes} "
        f"after {retries + 1} attempts: {last}") from last


# ----------------------------------------------------------------------
# the resume front door
# ----------------------------------------------------------------------
def resume(ckpt_dir: str, *, mesh=None, device: DeviceLike = None):
    """Restart a checkpointed solve from its store directory.

    Rebuilds the problem and solve configuration from ``MANIFEST.json``
    and ``problem.npz`` on ``device`` (default: the card), restores the
    newest intact segment and runs the remaining rounds, returning the
    :class:`MTLResult` (final ``W``, iterates, CommLog ledger, collective
    floats) the uninterrupted ``repro_torch.solve`` call would have
    returned, bit-identically.  A store whose solve already finished
    loads its final segment and replays the ledger without running a
    round.

    ``mesh`` supplies the ``DeviceMesh`` for a mesh-backend resume (the
    store records the backend and ``data_shards``; a mesh is a
    per-process object and is not stored).
    """
    prob, man, hp = load_store(ckpt_dir, device)
    cfg = man["config"]
    from ..api import solve
    return solve(prob, method=cfg["method"], backend=cfg["backend"],
                 mesh=mesh, axis=cfg.get("axis", "tasks"),
                 data_shards=cfg.get("data_shards", 1),
                 data_axis=cfg.get("data_axis", "data"),
                 checkpoint_every=cfg.get("checkpoint_every",
                                          DEFAULT_SEGMENT),
                 ckpt_dir=ckpt_dir, ckpt_keep=cfg.get("ckpt_keep", 3),
                 device=prob.device, **hp)
