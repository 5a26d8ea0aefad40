"""The c10d collectives an eager solve issues, recorded as they run.

The port's counterpart of the reference's ``jaxpr_walk``.  The reference
traces a round program to a jaxpr and walks its equations; the port has
no jaxpr.  Its data path is eager ``torch.distributed`` calls
(``dist.all_reduce`` and the flat all-gather in ``runtime/mesh.py``), and
every one of them goes through the dispatcher as a ``c10d`` op
(``c10d.allreduce_``, ``c10d._allgather_base_``).  So the capture is a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that sees every
op a solve issues, on real tensors, and keeps the ``c10d`` ones: the op,
its process group mapped to the mesh axis it serves, the floats this
rank feeds it, and the phase of the solve it ran in (a round index, the
setup of the round data, or the output gathers that hand the global
state back).

torch.fx and torch.export were the other candidates.  Neither follows an
eager solve: the lazy spectral master reads scalars back to the host and
branches on them (``core/spectral.py``), so a symbolic or fake-tensor
trace stops at the first such read.  Recording a real run has the
opposite limit: it sees the rounds it ran, with the values they had,
and nothing else (``repro_torch.analysis.verify`` states how many).

The mode is thread-local: ops a solver issues on threads of its own
(the sim's 2-D emulation runs a thread a shard) are not seen.  None of
those threads issues a c10d op; the sim moves no bytes.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# c10d op -> (the runtime's name for the collective, the argument that
# holds the tensors this rank feeds it).  Any other c10d op is recorded
# under its own name, fed by its first argument.
_OPS = {
    "allreduce_": ("psum", 0),
    "_allgather_base_": ("all_gather", 1),
}

#: the phases of a solve that are not round bodies
SETUP, OUTPUT, OUTSIDE = "setup", "output", "outside"


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return 0


def _group_of(args):
    for a in args:
        if (isinstance(a, torch.ScriptObject)
                and a._type().qualified_name().endswith("ProcessGroup")):
            import torch.distributed as dist
            return dist.ProcessGroup.unbox(a)
    return None


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One c10d collective a solve issued."""
    op: str              # the c10d op, e.g. "c10d.allreduce_"
    kind: str            # the runtime's name: "psum", "all_gather", ...
    axis: str            # the mesh axis of its group ("tasks", "data"),
                         # else "world" or "group <name>"
    floats: int          # elements this rank fed it
    phase: object        # round index (int), SETUP, OUTPUT or OUTSIDE

    @property
    def where(self) -> str:
        if isinstance(self.phase, int):
            return f"round {self.phase + 1}"
        return {SETUP: "the round data's setup", OUTPUT: "the output gathers",
                OUTSIDE: "no round body"}[self.phase]

    def describe(self) -> str:
        return (f"{self.op} ({self.kind}) of {self.floats} floats over axis "
                f"{self.axis!r} in {self.where}")


class CollectiveRecorder(TorchDispatchMode):
    """Records every c10d op issued while the mode is active, in the
    phase last set on :attr:`phase`; passes every op through unchanged."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch's default wraps ``__torch_dispatch__`` in dynamo's
        # ``disable``, whose first call imports ``torch._dynamo``, which
        # writes TORCHINDUCTOR_CACHE_DIR into ``os.environ``.  The
        # recorder only ever runs eagerly, so it needs no such wrapper
        # and leaves the process's environment as it found it.
        return False

    def __init__(self):
        super().__init__()
        self.calls: List[CollectiveCall] = []
        self.phase: object = OUTSIDE
        self._axes: Dict[int, Tuple[object, str]] = {}

    def name_group(self, group, axis: str) -> None:
        """Report ``group``'s ops as ops over ``axis``."""
        if group is not None:
            self._axes[id(group)] = (group, axis)

    def _axis(self, group) -> str:
        if group is None:
            return "world"
        if id(group) in self._axes:
            return self._axes[id(group)][1]
        import torch.distributed as dist
        if group is dist.group.WORLD:
            return "world"
        return f"group {group.group_name}"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            name = func.name().split("::", 1)[-1]
            kind, at = _OPS.get(name, (name, 0))
            fed = args[at] if at < len(args) else None
            self.calls.append(CollectiveCall(
                op=f"c10d.{name}", kind=kind,
                axis=self._axis(_group_of(args)), floats=_numel(fed),
                phase=self.phase))
        return func(*args, **kwargs)


@dataclasses.dataclass
class WalkResult:
    """The recorded calls of one solve, by phase, and the structural
    issues they show (COMM003)."""
    calls: List[CollectiveCall]
    rounds: Dict[int, List[CollectiveCall]]
    issues: List[str]

    def tally(self) -> Counter:
        """Multiset ``{(axis, kind, floats): calls}`` over the rounds."""
        return Counter((c.axis, c.kind, c.floats)
                       for calls in self.rounds.values() for c in calls)

    def phase_calls(self, phase) -> List[CollectiveCall]:
        return [c for c in self.calls if c.phase == phase]


def _signature(calls) -> Counter:
    return Counter((c.op, c.axis, c.floats) for c in calls)


def walk(calls: List[CollectiveCall], rounds: List[int]) -> WalkResult:
    """Group ``calls`` by the ``rounds`` that ran and find what no
    replayed template can account for: a collective outside every round
    body and setup or output phase, and a round whose collectives differ
    from the first round's (the eager counterpart of a collective under a
    ``while`` loop, whose trip count the template cannot know)."""
    by_round = {k: [c for c in calls if c.phase == k] for k in rounds}
    issues = [f"{c.describe()}: a collective outside the round bodies is "
              f"never charged by the replayed template"
              for c in calls if c.phase == OUTSIDE]
    if rounds:
        first = _signature(by_round[rounds[0]])
        for k in rounds[1:]:
            sig = _signature(by_round[k])
            for key in sorted(set(first) | set(sig)):
                if first[key] != sig[key]:
                    op, axis, floats = key
                    issues.append(
                        f"round {k + 1} issues {op}[{floats} floats] over "
                        f"axis {axis!r} {sig[key]}x but round "
                        f"{rounds[0] + 1} issues it {first[key]}x: the "
                        f"first round's replayed template would mis-charge "
                        f"round {k + 1}")
    return WalkResult(calls=list(calls), rounds=by_round, issues=issues)
