"""Shardlint on the port: the collective and sharding checks of a
training step (counterpart of singa_tpu/analysis/__init__.py).

The reference traces a compiled step to a closed jaxpr and checks seven
rules. A PyTorch step has no jaxpr and no compiled module, so here the
step's `torch.distributed` calls are recorded as they are issued
(`trace.CollectiveRecorder`, hooks at the port's choke functions) and
four rules read the records and the state's storage:

- **R1 axis-liveness**: declared and recorded axes exist on the mesh;
  no axis serves two incompatible parallelism roles.
- **R2 schedule-conformance**: each block's forward collectives equal
  the stack's (or engine's) `declared_schedule`, on every rank.
- **R4 ring-completeness**: every ppermute is one single cycle over the
  axis's full extent.
- **R5 in-place state**: every state tensor keeps its storage, dtype
  and shape across the capture and a replay.

- **R7 raw-HLO surface** (on StableHLO module text, which only the
  native training step makes: `hlo.trace_native_module`): every
  collective's replica groups partition the module's device world, and
  the text's census equals the one its emitter declares.

R3 (a shard-taint analysis over the jaxpr) and R6 (the module's census
against the jaxpr's) read objects PyTorch does not make and are not
ported (`rules._NOT_PORTED`); R7 on a PyTorch step, which has no module
text, raises too.

    >>> from singa_tpu_torch import analysis
    >>> report = analysis.lint_step(model, x, y)   # the library call
    >>> report.ok, report.summary()

`python -m singa_tpu_torch.analysis` lints the strategies registry
(`analysis/cases.py`), on the card at world 1 or over N gloo ranks on
the CPU, and writes the reference's JSON report; `--hlo` adds the
native-DP module (`cases.iter_hlo_cases`) under R7.
"""

from __future__ import annotations

from typing import Optional

from singa_tpu_torch.analysis.report import RULES, Report, Violation
from singa_tpu_torch.analysis.rules import (DEFAULT_RULES, HLO_RULES,
                                            run_rules, select_rules)
from singa_tpu_torch.analysis.trace import StepTrace, trace_step

__all__ = ["lint_step", "run_rules", "trace_step", "Report",
           "Violation", "RULES", "DEFAULT_RULES", "HLO_RULES", "StepTrace"]


def lint_step(model, *args, train: bool = True, rules=None,
              target: Optional[str] = None) -> Report:
    """Record `model`'s training (or eval) step on these inputs and run
    the rules. The model must be compiled with its optimizer set; the
    step's state (parameters, buffers, optimizer slots, the step
    counter, the random streams) is put back afterwards, so training
    goes on bitwise where it was. Static step arguments pass through
    positionally, as to `train_one_batch`."""
    select_rules(rules)  # refuse R3, R6 and R7 before the step runs
    trace = trace_step(model, *args, train=train, target=target)
    return run_rules(trace, rules=rules, target=target)
