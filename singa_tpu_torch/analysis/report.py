"""Shardlint's report types (counterpart of singa_tpu/analysis/report.py).

A lint run gives one `Report` per linted step: the rule violations
(none: clean), the observed collective census (a clean report still
says what the step's communication is) and, where the model declares a
schedule, the expected-against-found schedule of rule R2. `to_json`
has the reference's keys (`target`, `ok`, `violations`, `collectives`,
`schedule`, `hlo`, `notes`); `hlo` is the text's collective census
beside the emitter's declared one where the subject is module text (the
native training step, R7), else None.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["RULES", "Violation", "Report"]

#: rule id -> its contract, for the rules the port has. R3 (shard taint
#: over a jaxpr) and R6 (the module's census against the jaxpr's) read
#: objects PyTorch does not make; R7 reads module text, which only the
#: native training step has
RULES = {
    "R1": "axis-liveness: every declared or recorded axis exists on the "
          "mesh and no axis carries two incompatible parallelism roles",
    "R2": "schedule-conformance: each block's recorded forward "
          "collectives equal the stack's declared_schedule, on every "
          "rank, and a declared whole-step census holds",
    "R4": "ring-completeness: every ppermute's sends over the ranks of "
          "its group form one single cycle covering the full axis extent",
    "R5": "in-place state: every parameter, buffer, optimizer slot and "
          "the device step counter keeps its address, dtype and shape "
          "across the captured step and a replay (across two calls of "
          "the step where nothing is captured)",
    "R7": "raw-hlo-surface: every collective in the module text carries "
          "replica groups that partition the module's num_replicas x "
          "num_partitions world, and the text's collective census equals "
          "the one its emitter declares",
}


@dataclasses.dataclass
class Violation:
    rule: str        # "R1", "R2", "R4", "R5" or "R7"
    message: str
    subject: str = ""  # the axis, tensor or stack the finding is about

    def __str__(self) -> str:
        where = f" {self.subject}:" if self.subject else ""
        return f"[{self.rule}]{where} {self.message}"

    def to_json(self) -> Dict:
        return {"rule": self.rule, "subject": self.subject,
                "message": self.message}


@dataclasses.dataclass
class Report:
    target: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    #: observed census: "op@axis" -> recorded calls in the step (every
    #: rank's, merged; see `trace.StepTrace.census`)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: R2's evidence where a schedule was declared: {"expected": {...},
    #: "found": {...}} with "op@axis" keys
    schedule: Optional[Dict] = None
    #: R7's evidence: {"census": the text's, "expected": the emitter's
    #: declared census or None}; None without module text
    hlo: Optional[Dict] = None
    #: non-fatal analyzer notes
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        head = f"{'OK  ' if self.ok else 'FAIL'} {self.target}"
        lines = [head] + [f"  {v}" for v in self.violations]
        if not self.ok and self.schedule is not None:
            lines.append(f"  schedule expected={self.schedule['expected']}"
                         f" found={self.schedule['found']}")
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {
            "target": self.target,
            "ok": self.ok,
            "violations": [v.to_json() for v in self.violations],
            "collectives": dict(self.collectives),
            "schedule": self.schedule,
            "hlo": self.hlo,
            "notes": list(self.notes),
        }
