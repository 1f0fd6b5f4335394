"""Deterministic fault injectors (counterpart of
singa_tpu/resilience/faults.py): the harness the resilience tests drive.

Every injector is deterministic by construction (a fixed step index, a
fixed byte offset, a fixed call number; no wall clock, no RNG), so a
failing resilience test replays identically and the bitwise-resume
oracle stays exact:

- `nonfinite_grad_at(step)`: a gradient poisoner wired into
  `GradSentinel.fault_plan`: at sentinel step `step` every gradient is
  multiplied by NaN (or Inf) on the device, inside the (captured)
  update, so the skip under test is the real one.
- `flip_byte` / `flip_checkpoint_byte`: storage bit-rot on a committed
  checkpoint shard, through the owning storage driver; restore must
  refuse it with the file and offset named.
- `simulate_preemption`: a real SIGTERM to this process, for the
  `PreemptionGuard` drain path.
- `TransientCalls`: raise a transient-classed error on chosen call
  numbers (deterministic-classed errors too, for the fast-fail side).
- the step hooks a supervisor calls with (step, batch), each firing on
  a fixed step a bounded number of times: `crash_at(k)` raises,
  `stall_at(k)` hangs the step in an interruptible host sleep,
  `poison_batch_at(k)` scales the batch's first operand to a huge
  magnitude, `hard_hang_at(k)` SIGSTOPs the process, and
  `stale_host_at(k, rank=r)` does so only on the host whose
  `SINGA_FLEET_RANK` is r; `lease_clock_skew(offset_s)` is a skewed
  wall clock. `resilience.Supervisor` calls the step hooks and
  `resilience.Babysitter` heals a `hard_hang_at`; `resilience.fleet`
  heals a `stale_host_at` by an epoch bump, and its elections are
  immune to a `lease_clock_skew`.
- `kill_at_phase(phase)`: hard-exit at a named boundary of the
  checkpoint commit ("snapshot", "shard_writes", "receipts",
  "manifest"), via `checkpoint._phase_hook`.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional, Sequence, Tuple

__all__ = ["nonfinite_grad_at", "NonFiniteGradAt", "flip_byte",
           "flip_checkpoint_byte", "simulate_preemption",
           "TransientCalls", "crash_at", "CrashAt", "stall_at",
           "StallAt", "poison_batch_at", "PoisonBatchAt",
           "hard_hang_at", "HardHangAt", "kill_at_phase",
           "KillAtPhase", "stale_host_at", "StaleHostAt",
           "lease_clock_skew"]

class NonFiniteGradAt:
    """GradSentinel fault plan: multiply every gradient by `value`
    (default NaN) on the step where the sentinel's always-advancing
    `seen_steps` counter equals `step` (0-based), identity elsewhere.
    Traced into the compiled update — one executable serves faulted and
    clean steps."""

    def __init__(self, step: int, value: float = float("nan")):
        self.step = int(step)
        self.value = float(value)

    def factor(self, seen_steps):
        import torch

        one = torch.ones((), dtype=torch.float32, device=seen_steps.device)
        return torch.where(seen_steps == self.step, one * self.value, one)


def nonfinite_grad_at(step: int, value: float = float("nan")
                      ) -> NonFiniteGradAt:
    """The non-finite-gradient-at-step-k injector (see NonFiniteGradAt);
    pass as ``GradSentinel(fault_plan=...)``."""
    return NonFiniteGradAt(step, value)


def flip_byte(path: str, offset: int, bit: int = 0) -> None:
    """XOR one bit of the byte at `offset` in `path` — a deterministic
    storage bit-flip, routed through the owning `singa_tpu_torch.storage`
    driver so rot can be injected into object-store checkpoints too."""
    from singa_tpu_torch import storage

    drv = storage.get_driver(path)
    data = drv.read(path)
    if data is None or not 0 <= offset < len(data):
        raise ValueError(
            f"flip_byte: offset {offset} is outside {path} "
            f"({0 if data is None else len(data)} bytes)")
    flipped = bytearray(data)
    flipped[offset] ^= 1 << bit
    drv.put_atomic(path, bytes(flipped))


def flip_checkpoint_byte(directory: str, *, leaf: Optional[str] = None,
                         byte_offset: int = 0,
                         bit: int = 0) -> Tuple[str, int]:
    """Flip one bit inside a COMMITTED checkpoint's shard data (the
    first shard of `leaf`, or of the first parameter leaf), leaving the
    manifest intact — exactly the corruption the crc chunks must catch.
    Returns (file_path, byte_offset) for the refusal assertion."""
    import json

    from singa_tpu_torch import storage
    from singa_tpu_torch.resilience import checkpoint as ckpt

    step_dir = ckpt.latest_step_dir(directory)
    manifest = json.loads(storage.get_driver(step_dir).read(
        os.path.join(step_dir, ckpt.MANIFEST)).decode())
    chosen = None
    for lf in manifest["leaves"]:
        if leaf is None and lf["name"].startswith("param/") \
                and lf["shards"][0]["nbytes"] > byte_offset:
            chosen = lf
            break
        if leaf is not None and lf["name"] == leaf:
            chosen = lf
            break
    if chosen is None:
        raise ValueError(
            f"flip_checkpoint_byte: no matching leaf in {step_dir} "
            f"(leaf={leaf!r})")
    path = os.path.join(step_dir, chosen["shards"][0]["file"])
    flip_byte(path, byte_offset, bit=bit)
    return path, byte_offset


def simulate_preemption(pid: Optional[int] = None,
                        sig: int = signal.SIGTERM) -> None:
    """Deliver a real preemption signal (default SIGTERM to this
    process) — the `PreemptionGuard` under test handles the genuine
    article, not a mocked flag."""
    os.kill(os.getpid() if pid is None else pid, sig)


class _StepHook:
    """Base for Supervisor fault hooks: fire on data-cursor `step`, at
    most `times` times across the whole supervised run (the hook object
    outlives restarts, so a healed run does NOT re-trip the same
    injection forever — `trips` records how often it fired)."""

    def __init__(self, step: int, times: int = 1):
        self.step = int(step)
        self.times = int(times)
        self.trips = 0

    def _should_fire(self, step: int) -> bool:
        if int(step) == self.step and self.trips < self.times:
            self.trips += 1
            return True
        return False


class CrashAt(_StepHook):
    """Raise a transient-classed RuntimeError when the supervised run
    reaches step `step` — the plain process-crash injection the
    restart/restore path must absorb."""

    def __call__(self, step: int, batch):
        if self._should_fire(step):
            raise RuntimeError(
                f"injected crash at step {step} (trip {self.trips})")
        return None


def crash_at(step: int, times: int = 1) -> CrashAt:
    """The crash-at-step-k injector; pass as
    ``Supervisor(fault_hook=...)``."""
    return CrashAt(step, times=times)


class StallAt(_StepHook):
    """Hang the supervised step at `step`: sleep for up to `seconds`
    in short interruptible slices. Deterministic in WHICH step hangs;
    the watchdog's deadline (not this duration) decides when the hang
    is converted to a `StepHangError` — set `seconds` well past the
    deadline so the detection is the watchdog's doing."""

    def __init__(self, step: int, seconds: float = 3600.0,
                 times: int = 1, poll_s: float = 0.02):
        super().__init__(step, times=times)
        self.seconds = float(seconds)
        self.poll_s = float(poll_s)

    def __call__(self, step: int, batch):
        if self._should_fire(step):
            t0 = time.monotonic()
            while time.monotonic() - t0 < self.seconds:
                time.sleep(self.poll_s)  # interrupt_main lands here
        return None


def stall_at(step: int, seconds: float = 3600.0,
             times: int = 1) -> StallAt:
    """The hung-step injector (see StallAt); pass as
    ``Supervisor(fault_hook=...)`` with a `step_timeout_s` deadline."""
    return StallAt(step, seconds=seconds, times=times)


class PoisonBatchAt(_StepHook):
    """Replace the batch at `step` with a poisoned copy: the FIRST
    element's values scaled by `factor` (a corrupt record's
    huge-magnitude float garbage). The step's loss spikes immediately
    and — if trained on — the update poisons the weights, which is
    exactly what the supervisor's rollback+skip must undo."""

    def __init__(self, step: int, factor: float = 1e4, times: int = 1):
        super().__init__(step, times=times)
        self.factor = float(factor)

    def __call__(self, step: int, batch):
        if not self._should_fire(step):
            return None
        import torch

        x, *rest = batch
        return (torch.as_tensor(x) * self.factor, *rest)


def poison_batch_at(step: int, factor: float = 1e4,
                    times: int = 1) -> PoisonBatchAt:
    """The poisoned-batch injector (see PoisonBatchAt); drives the
    loss-spike rollback oracle."""
    return PoisonBatchAt(step, factor=factor, times=times)


class HardHangAt(_StepHook):
    """Freeze THIS process with SIGSTOP at step `step` — the hang class
    nothing in-process can heal: SIGSTOP is uncatchable, no bytecode
    ever runs again, so the watchdog's `interrupt_main` is inert and
    `on_hang` can only fire from a thread that is itself frozen. Only
    an out-of-process babysitter (stale heartbeat -> SIGKILL the
    process tree -> respawn) has jurisdiction. `times` bounds the trips
    WITHIN one process; across respawns the hook object does not
    survive, so callers gate on ``counters`` "restarts_external"
    (seeded from the babysitter's env) to keep the injection
    one-shot."""

    def __call__(self, step: int, batch):
        if self._should_fire(step):
            os.kill(os.getpid(), signal.SIGSTOP)
        return None


def hard_hang_at(step: int, times: int = 1) -> HardHangAt:
    """The hard-hang injector (see HardHangAt), for a babysitter's
    kill-resume oracle."""
    return HardHangAt(step, times=times)


class StaleHostAt(HardHangAt):
    """The FLEET host-loss injector: SIGSTOP this process at
    step `step` — but only on the host whose ``SINGA_FLEET_RANK`` (read
    at fire time, so the same hook object serves every rank's trainer)
    equals `rank`. One host of the multi-process job freezes; its
    agent's trainer heartbeat goes stale, the LEADER converts that into
    an epoch bump, and every host SIGKILLs + respawns — the whole-job
    restart no single-host babysitter can perform. Like HardHangAt,
    the hook object does not survive the respawn; callers keep the
    injection one-shot by gating on the ``counters`` "fleet_epochs"
    value the agent's env seeds (inject only at epoch 0)."""

    def __init__(self, step: int, rank: int = 0, times: int = 1):
        super().__init__(step, times=times)
        self.rank = int(rank)

    def __call__(self, step: int, batch):
        from singa_tpu_torch.resilience.fleet import RANK_ENV

        if int(os.environ.get(RANK_ENV, "-1")) != self.rank:
            return None
        return super().__call__(step, batch)


def stale_host_at(step: int, rank: int = 0,
                  times: int = 1) -> StaleHostAt:
    """The stale-host injector (see StaleHostAt), for a fleet's
    host-loss oracle."""
    return StaleHostAt(step, rank=rank, times=times)


def lease_clock_skew(offset_s: float, base=time.time):
    """A wall clock skewed by `offset_s` seconds — pass as
    `FleetAgent(time_fn=)` / `FileLease(time_fn=)` to inject
    lease-clock skew. The election must be IMMUNE: lease and heartbeat
    staleness are judged by observed change against the observer's own
    monotonic clock, never by comparing embedded wall-clock stamps, so
    a skewed host can neither steal a healthy leader's lease nor have
    its liveness misjudged."""
    offset = float(offset_s)

    def skewed() -> float:
        return base() + offset

    return skewed


class KillAtPhase:
    """`checkpoint._phase_hook` injector: hard-exit (`os._exit`, no
    cleanup, no atexit — the closest deterministic stand-in for a
    SIGKILL mid-save) when the two-phase commit reaches `phase` on this
    process. Phases, in commit order: "snapshot" (device->host copies
    taken, NOTHING written to storage yet), "shard_writes" (own shard
    files written, receipt NOT yet), "receipts" (process 0 saw every
    receipt, manifest NOT yet), "manifest" (manifest durable, LATEST
    not yet swung). For an async save every phase after "snapshot"
    fires on the background commit thread, so the exit kills the
    process mid-background-write (the async kill-anywhere oracle).
    Install via ``checkpoint._phase_hook = kill_at_phase(p)``
    in the doomed process."""

    def __init__(self, phase: str, exit_code: int = 42):
        self.phase = str(phase)
        self.exit_code = int(exit_code)

    def __call__(self, phase: str) -> None:
        if phase == self.phase:
            os._exit(self.exit_code)


def kill_at_phase(phase: str, exit_code: int = 42) -> KillAtPhase:
    """The commit-boundary killer (see KillAtPhase); drives the
    kill-anywhere commit oracles."""
    return KillAtPhase(phase, exit_code=exit_code)


class TransientCalls:
    """Wrap `fn`; raise on the call numbers in `fail_calls` (1-based),
    pass through otherwise. Default exception is transient-classed (a
    RuntimeError `retry_transient` retries); pass `exc_factory` to
    inject deterministic-classed errors instead and prove the fast-fail
    side."""

    def __init__(self, fn: Callable, fail_calls: Sequence[int] = (1,),
                 exc_factory: Optional[Callable[[int], Exception]] = None):
        self.fn = fn
        self.fail_calls = frozenset(int(i) for i in fail_calls)
        self.exc_factory = exc_factory or (
            lambda i: RuntimeError(
                f"injected transient: response body closed (call {i})"))
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls in self.fail_calls:
            raise self.exc_factory(self.calls)
        return self.fn(*args, **kwargs)
