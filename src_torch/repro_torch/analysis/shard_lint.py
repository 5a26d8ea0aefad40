"""Sharding, aliasing and carry lints over a captured solve.

The reference lints a jaxpr; the port looks at the tensors of a real
round loop, as :class:`~repro_torch.analysis.verify.StaticCapture` hands
them over.

* SHRD001 — a REPLICATED state leaf of a mesh solve at least as large as
  the largest sharded operand (the worker-data leaves, split over the
  task axis, and the state entries ``run_rounds(..., sharded=)`` names).
  Every rank holds, and every round reads, the whole leaf: the memory
  and bandwidth the mesh exists to save are gone.  In a healthy solve
  the largest operands are the sharded data, and the replicated master
  state is far smaller.
* SHRD002 — torch has no buffer donation, so the reference's hazard (a
  donated buffer read again) has an eager counterpart instead: a tensor
  that was handed out and then written in place.  The round's input
  state is the previous round's output, and the solver's recorder keeps
  those tensors as its iterates (``MTLResult.record`` stores them
  without a copy), as a caller keeps the initial state it passed.  A
  round body that writes into one of them rewrites history.  It is
  caught through ``Tensor._version``, which every in-place op bumps:
  the versions of the input leaves are taken before the round and
  compared after it.
* SHRD003 — carry drift between a round's input and output state:
  another dtype, shape, device or strides, a Python scalar that became
  a tensor, or entries that appear or vanish.  The reference's scan
  driver refuses a drifting carry, and its eager driver recompiles every
  round; in the port a drifting carry changes what the next round
  computes on (a transposed iterate takes another matmul order) and
  what a checkpoint restores.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .report import Finding


def flat_leaves(value, path: str = "") -> List[Tuple[str, object]]:
    """``(path, leaf)`` of every leaf of a state entry or dict of them,
    keys in sorted order."""
    if isinstance(value, dict):
        return [pl for k in sorted(value)
                for pl in flat_leaves(value[k], f"{path}[{k!r}]")]
    return [(path, value)]


def leaf_signature(leaf) -> Tuple:
    """What a leaf must keep from one round to the next."""
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype),
                str(leaf.device), tuple(leaf.stride()))
    return ("python", type(leaf).__name__)


# ---------------------------------------------------------------------------
# what the capture records, round by round
# ---------------------------------------------------------------------------
def versions(state) -> List[Tuple[str, torch.Tensor, int]]:
    """The tensor leaves of ``state`` with their version counters."""
    return [(path, leaf, leaf._version) for path, leaf in flat_leaves(state)
            if isinstance(leaf, torch.Tensor)]


def written_in_place(k: int, before) -> List[Tuple[str, str]]:
    """``(path, message)`` of the leaves of ``before`` (from
    :func:`versions`) that round ``k`` wrote in place."""
    return [(path, f"round {k + 1} wrote state leaf {path} "
            f"({tuple(leaf.shape)} {leaf.dtype}) in place after it was "
            f"handed out (version {v} -> {leaf._version}): the previous "
            f"round's state and the recorded iterates share it; write a "
            f"new tensor instead")
            for path, leaf, v in before if leaf._version != v]


def drift(k: int, state_in, state_out) -> List[Tuple[str, str]]:
    """``(path, message)`` of each leaf in which round ``k``'s output
    state differs from its input: structure, dtype, shape, device,
    strides or leaf type."""
    a, b = dict(flat_leaves(state_in)), dict(flat_leaves(state_out))
    out = []
    for path in sorted(set(a) | set(b)):
        if path not in b or path not in a:
            out.append((path, f"round {k + 1} "
                                f"{'drops' if path in a else 'adds'} state "
                                f"leaf {path}: the state structure changes "
                                f"across rounds"))
            continue
        sa, sb = leaf_signature(a[path]), leaf_signature(b[path])
        if sa != sb:
            out.append((path, f"state leaf {path} drifts across round "
                                f"{k + 1}: in {sa} -> out {sb}; return it "
                                f"as it came in"))
    return out


# ---------------------------------------------------------------------------
# the lints
# ---------------------------------------------------------------------------
def replication_lint(leaves: Dict[str, Tuple[int, bool]], backend: str,
                     where: str) -> List[Finding]:
    """SHRD001 over ``{name: (global numel, sharded)}`` of a mesh solve."""
    if backend != "mesh":
        return []
    sharded = [size for size, sh in leaves.values() if sh]
    if not sharded:
        return []
    threshold = max(sharded)
    return [Finding(
        "SHRD001",
        f"replicated leaf {name} of {size} elements is as large as the "
        f"largest sharded operand ({threshold}): every rank holds the "
        f"whole array; shard it (run_rounds(..., sharded=)) or drop it "
        f"from the round state", where)
        for name, (size, sh) in leaves.items()
        if not sh and size >= threshold]


def lint_program(trace) -> List[Finding]:
    """All program-level lints for one captured solve."""
    where = f"{trace.method}/{trace.layout}/{trace.driver}"
    findings = replication_lint(trace.leaves, trace.backend, where)
    findings += [Finding("SHRD002", msg, where) for msg in trace.aliased]
    findings += [Finding("SHRD003", msg, where) for msg in trace.drift]
    return findings
