"""Resilience (counterpart of singa_tpu/resilience), only what the
serving frontend and replica router use:

- ``counters``: the process fault-counter facade (`bump`, `snapshot`,
  `reset`) over the port's metric registry;
- ``watchdog.HEARTBEAT_ENV`` / ``touch_heartbeat``: the babysitter
  liveness file the serve loop touches every scheduler turn;
- ``PreemptionGuard``: SIGTERM sets a flag that the serve loop reads
  between steps.

The rest of the reference package (checkpointing, the sentinel, retry,
the watchdog thread, the supervisor, the babysitter and the fleet) is
ROADMAP queue 1 item 17.
"""

from singa_tpu_torch.resilience import counters  # noqa: F401
from singa_tpu_torch.resilience.checkpoint import PreemptionGuard  # noqa: F401
from singa_tpu_torch.resilience.watchdog import (  # noqa: F401
    HEARTBEAT_ENV, touch_heartbeat)

__all__ = ["counters", "PreemptionGuard", "HEARTBEAT_ENV",
           "touch_heartbeat"]
