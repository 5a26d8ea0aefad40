"""Findings and the per-solver analysis report (text + JSON).

The port's copy of ``repro.analysis.report``: the same codes, fields and
``to_dict``, so a report of either package reads the same.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


@dataclasses.dataclass
class Finding:
    """One verification failure or lint hit.

    Codes
    -----
    COMM001  c10d collective not charged in the CommLog template
    COMM002  charged template event with no matching c10d collective
    COMM003  structural: collective outside a round body, or a round
             whose collectives differ from the first round's
    COMM004  ledger totals disagree with measured counters
    COMM005  charged per-round vectors disagree with Table 1
    COMM006  ledger differs across layouts/drivers (not layout-invariant)
    SHRD001  replicated state leaf as large as the largest sharded leaf
    SHRD002  handed-out tensor written in place (torch's donation hazard)
    SHRD003  round state drift (dtype/shape/device/strides/type)
    LINT1xx  AST repo lints (see repro_torch.analysis.lint)
    """
    code: str
    message: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code}{loc}: {self.message}"


@dataclasses.dataclass
class CaseReport:
    """One (solver, layout, driver) cell of the verification matrix."""
    method: str
    layout: str                  # "sim" | "mesh" | "mesh2d"
    driver: str                  # "scan" | "eager"
    rounds: int = 0
    charged_floats_per_machine: int = 0
    charged_vectors_per_round: float = 0.0
    measured_task_floats_per_chip: int = 0
    measured_data_floats_per_chip: int = 0
    collective_eqns: int = 0     # c10d collectives one round issues
    findings: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        d["findings"] = [str(f) for f in self.findings]
        return d


@dataclasses.dataclass
class AnalysisReport:
    cases: List[CaseReport] = dataclasses.field(default_factory=list)
    cross_findings: List[Finding] = dataclasses.field(default_factory=list)
    lint_findings: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (all(c.ok for c in self.cases) and not self.cross_findings
                and not self.lint_findings)

    def all_findings(self) -> List[Finding]:
        out = [f for c in self.cases for f in c.findings]
        out.extend(self.cross_findings)
        out.extend(self.lint_findings)
        return out

    def to_dict(self) -> Dict:
        return {"ok": self.ok,
                "cases": [c.to_dict() for c in self.cases],
                "cross_findings": [str(f) for f in self.cross_findings],
                "lint_findings": [str(f) for f in self.lint_findings]}

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(s)
        return s

    def render(self) -> str:
        """The human table ``python -m repro_torch.analysis`` prints."""
        lines = ["solver       layout  driver  rounds  chg_fl/mach  "
                 "vec/rnd  meas_task  meas_data  ops  status"]
        for c in self.cases:
            lines.append(
                f"{c.method:<12} {c.layout:<7} {c.driver:<7} "
                f"{c.rounds:>6}  {c.charged_floats_per_machine:>11} "
                f"{c.charged_vectors_per_round:>8.1f} "
                f"{c.measured_task_floats_per_chip:>10} "
                f"{c.measured_data_floats_per_chip:>10} "
                f"{c.collective_eqns:>4}  "
                f"{'OK' if c.ok else 'FAIL'}")
            for f in c.findings:
                lines.append(f"    !! {f}")
        for f in self.cross_findings:
            lines.append(f"CROSS !! {f}")
        for f in self.lint_findings:
            lines.append(f"LINT  !! {f}")
        n_bad = len(self.all_findings())
        lines.append(f"{'PASS' if self.ok else 'FAIL'}: "
                     f"{len(self.cases)} cases verified, "
                     f"{n_bad} finding(s)")
        return "\n".join(lines)
