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
- ``retry``: the bounded transient retry (deterministic error classes
  and out-of-memory errors fail fast) and the exponential restart
  backoff the supervisor and the babysitter share;
- ``watchdog``: the per-step deadline (`Watchdog`, `StepHangError`) and
  the babysitter heartbeat (``HEARTBEAT_ENV``, `touch_heartbeat`);
- ``anomaly``: `SpikeDetector`, the median/MAD loss-spike detector;
- ``supervisor``: `Supervisor`, crash and hang restarts and loss-spike
  rollback around the checkpoint, and the mesh policy (`choose_mesh`,
  `default_mesh_fn`);
- ``babysitter``: `Babysitter`, the out-of-process healer of hangs the
  watchdog cannot unwind (a wait inside one CUDA or NCCL call, a frozen
  process): a stale heartbeat gets the process tree SIGKILLed and
  respawned; ``python -m singa_tpu_torch.resilience.babysit --
  <trainer cmd>``;
- ``fleet``: the babysitter fleet, one `FleetAgent` per host over a
  shared rendezvous directory: a `FileLease`-elected leader turns a lost
  host or a dead trainer into a job-level epoch bump, shrinks the roster
  past the grace window, re-admits returned hosts and brokers each
  epoch's coordinator address; ``python -m
  singa_tpu_torch.resilience.babysit --fleet DIR --fleet-rank I
  --fleet-world N -- <trainer cmd>``.
"""

from singa_tpu_torch.resilience import counters  # noqa: F401
from singa_tpu_torch.resilience import faults  # noqa: F401
from singa_tpu_torch.resilience.anomaly import SpikeDetector  # noqa: F401
from singa_tpu_torch.resilience.babysitter import Babysitter  # noqa: F401
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
from singa_tpu_torch.resilience.fleet import (  # noqa: F401
    FileLease,
    FleetAgent,
)
from singa_tpu_torch.resilience.retry import retry_transient  # noqa: F401
from singa_tpu_torch.resilience.sentinel import GradSentinel  # noqa: F401
from singa_tpu_torch.resilience.supervisor import (  # noqa: F401
    Supervisor,
    choose_mesh,
    default_mesh_fn,
)
from singa_tpu_torch.resilience.watchdog import (  # noqa: F401
    HEARTBEAT_ENV,
    StepHangError,
    Watchdog,
    touch_heartbeat,
)

__all__ = [
    "save", "restore", "latest_step_dir", "read_manifest", "prune",
    "CheckpointError", "CorruptCheckpointError", "TornSaveError",
    "PreemptionGuard", "AsyncSaveHandle", "wait_pending",
    "GradSentinel", "retry_transient", "counters",
    "faults", "Watchdog", "StepHangError", "SpikeDetector",
    "Supervisor", "choose_mesh", "default_mesh_fn", "Babysitter",
    "FleetAgent", "FileLease", "HEARTBEAT_ENV", "touch_heartbeat",
]
