"""Resilient training (counterpart of singa_tpu/resilience):

- ``checkpoint``: atomic sharded checkpoints through the storage
  drivers: per-shard files (a rank writes only the shards it owns),
  crc-chunked integrity, the manifest-then-LATEST commit, the two-phase
  commit over ranks (`TornSaveError` names the ranks that wrote no
  receipt), async saves (`AsyncSaveHandle`, `wait_pending`), bitwise
  resume (parameters, slots, the loss-scale state, the generators, the
  data cursor), elastic restore into the current layout, `prune`, and
  the SIGTERM-draining ``PreemptionGuard``;
- ``sentinel``: `GradSentinel`, the NaN/Inf guard with dynamic loss
  scaling; a non-finite step is a branch-free no-op on the device;
- ``faults``: deterministic injectors (a non-finite gradient at step k,
  a checkpoint bit flip, a kill at a commit phase, transient calls, the
  supervisor's step hooks);
- ``counters``: the process fault-counter facade (`bump`, `snapshot`,
  `reset`) over the port's metric registry;
- ``watchdog.HEARTBEAT_ENV`` / ``touch_heartbeat``: the babysitter
  liveness file the serve loop touches every scheduler turn.

Not ported yet (ROADMAP queue 1 item 17): `retry`, the `Watchdog`
thread, `anomaly`, the `supervisor`, the `babysitter` (`babysit`) and
the `fleet`.
"""

from singa_tpu_torch.resilience import counters  # noqa: F401
from singa_tpu_torch.resilience import faults  # noqa: F401
from singa_tpu_torch.resilience.checkpoint import (  # noqa: F401
    AsyncSaveHandle,
    CheckpointError,
    CorruptCheckpointError,
    PreemptionGuard,
    TornSaveError,
    latest_step_dir,
    prune,
    read_manifest,
    restore,
    save,
    wait_pending,
)
from singa_tpu_torch.resilience.sentinel import GradSentinel  # noqa: F401
from singa_tpu_torch.resilience.watchdog import (  # noqa: F401
    HEARTBEAT_ENV, touch_heartbeat)

__all__ = [
    "save", "restore", "latest_step_dir", "read_manifest", "prune",
    "CheckpointError", "CorruptCheckpointError", "TornSaveError",
    "PreemptionGuard", "AsyncSaveHandle", "wait_pending",
    "GradSentinel", "counters", "faults", "HEARTBEAT_ENV",
    "touch_heartbeat",
]
