"""Communication ledger — the paper's unit of account (Table 1).

Port of ``repro.core.comm``, copied whole: pure Python, no tensors.  The
paper counts *p-dimensional real vectors communicated per machine*.
Every solver records its traffic through a CommLog, and two solves agree
on communication iff their :meth:`CommLog.ledger` lists compare equal —
across packages too, since the tuples and note strings are the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class CommEvent:
    round: int
    direction: str      # "worker->master" | "master->worker" | "broadcast"
    vectors: int        # number of vectors sent (per machine)
    dim: int            # dimension of each vector
    note: str = ""

    @property
    def floats(self) -> int:
        return self.vectors * self.dim


@dataclasses.dataclass
class CommLog:
    m: int                                  # number of machines
    events: List[CommEvent] = dataclasses.field(default_factory=list)
    rounds: int = 0

    def begin_round(self) -> int:
        self.rounds += 1
        return self.rounds

    def send(self, direction: str, vectors: int, dim: int, note: str = "") -> None:
        self.events.append(CommEvent(self.rounds, direction, vectors, dim, note))

    # ---- summaries -------------------------------------------------------
    def ledger(self) -> List[tuple]:
        """The full event log as plain comparable tuples — the
        bit-identity currency of the parity tests: two solves agree on
        communication iff their ledgers compare equal."""
        return [(e.round, e.direction, e.vectors, e.dim, e.note)
                for e in self.events]

    def floats_per_machine(self) -> int:
        return sum(e.floats for e in self.events)

    def floats_by_direction(self, direction: str) -> int:
        """Ledger floats per machine in one direction."""
        return sum(e.floats for e in self.events if e.direction == direction)

    def vectors_per_machine(self) -> int:
        return sum(e.vectors for e in self.events)

    def total_floats(self) -> int:
        return self.m * self.floats_per_machine()

    def per_round_vectors(self) -> float:
        return self.vectors_per_machine() / max(self.rounds, 1)

    def summary(self) -> Dict[str, float]:
        return {
            "rounds": self.rounds,
            "vectors_per_machine": self.vectors_per_machine(),
            "floats_per_machine": self.floats_per_machine(),
            "vectors_per_round": self.per_round_vectors(),
        }


# Theoretical per-round vector counts from Table 1 (per machine).
TABLE1_VECTORS_PER_ROUND = {
    "local": 0,
    "centralize": None,   # ships the data once: n vectors of dim p per machine
    "svd_trunc": 2,       # one-shot: send w_hat, receive truncated column
    "proxgd": 2,
    "accproxgd": 2,
    "admm": 3,
    "dfw": 2,
    "dgsp": 2,
    "dnsp": 2,
    "bestrep": 0,
    "altmin": None,
}
