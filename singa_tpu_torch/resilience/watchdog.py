"""Per-step hang watchdog and the babysitter heartbeat (counterpart of
singa_tpu/resilience/watchdog.py).

A hung collective (a peer gone from the group, a deadlocked transfer)
does not crash; it waits forever, the worst failure for a supervised
run: no exception, no log line, no restart. The watchdog turns it into
an error that names the step:

- `arm(step)` starts a one-shot `threading.Timer` just before the step;
  `disarm()` cancels it when the step completes. A healthy run pays one
  timer start and cancel per step.
- On expiry the timer thread records (step, elapsed), bumps the
  ``hangs`` counter, writes a ``watchdog.hang`` trace event, runs the
  optional `on_hang` callback (diagnostics from a thread that is not
  stuck) and interrupts the main thread; `guard(step)` turns that
  interrupt into a `StepHangError` naming the step and the elapsed
  time, which the `Supervisor` restores and restarts from.

What the interrupt can reach: `_thread.interrupt_main` raises
`KeyboardInterrupt` at the main thread's next bytecode boundary. A stall
that yields to the interpreter (the injected `faults.stall_at`, a wedged
Python data loader, a host loop polling the card) is converted at once.
A wait inside one CUDA or NCCL call never returns to the interpreter: a
CUDA Graph replay, a `.item()` or `torch.cuda.synchronize()` behind a
stuck kernel, a collective whose peer is gone. Nor does a process
frozen by SIGSTOP. None of these can be unwound from inside the
process; they are the out-of-process babysitter's
(`resilience.babysitter`). `Watchdog(heartbeat_path=)` touches a
heartbeat file at construction and on every arm and disarm; the
babysitter watches its mtime from another process and SIGKILLs and
respawns the process tree when it goes stale. `heartbeat_path` defaults
to ``SINGA_HEARTBEAT_FILE``, which the babysitter sets on every spawn,
so a trainer that arms a Watchdog per step heartbeats under a
babysitter with no other wiring. The ``hangs`` counter moves either
way, so a hang is never invisible.
"""

from __future__ import annotations

import _thread
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import counters

__all__ = ["Watchdog", "StepHangError", "HEARTBEAT_ENV",
           "touch_heartbeat"]

#: env var naming the heartbeat file (a babysitter sets it on every
#: spawn; `Watchdog(heartbeat_path=None)` picks it up)
HEARTBEAT_ENV = "SINGA_HEARTBEAT_FILE"


def touch_heartbeat(path) -> None:
    """Touch a heartbeat file (mtime = now); no-op on a falsy path.
    Never raises: a full disk or a removed directory must not crash the
    process the heartbeat exists to protect. `Watchdog` beats through
    it per step, the serving `Frontend` once per scheduler turn, and the
    spool server for the router's own heartbeat file."""
    if not path:
        return
    try:
        with open(path, "ab"):
            pass
        os.utime(path, None)
    except OSError:
        pass


class StepHangError(RuntimeError):
    """A training step blew its deadline; names the step and how long it
    had been hanging when the watchdog fired."""

    def __init__(self, step: int, elapsed_s: float, timeout_s: float):
        super().__init__(
            f"training step {step} hung: no completion after "
            f"{elapsed_s:.1f}s (deadline {timeout_s:.1f}s) — a stuck "
            f"collective or stalled host loop; the run needs a "
            f"restore+restart, not more waiting")
        self.step = int(step)
        self.elapsed_s = float(elapsed_s)
        self.timeout_s = float(timeout_s)


class Watchdog:
    """Arm a deadline around each step (module docstring)::

        wd = Watchdog(timeout_s=300)
        with wd.guard(step):            # arms, runs, disarms
            model.train_one_batch(x, y)

    or `arm(step)` / `disarm()` by hand. One Watchdog serves the whole
    run; arming again cancels the previous timer."""

    def __init__(self, timeout_s: float,
                 on_hang: Optional[Callable[[int, float], None]] = None,
                 heartbeat_path: Optional[str] = None):
        if timeout_s <= 0:
            raise ValueError(
                f"Watchdog timeout_s={timeout_s!r} must be positive")
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        #: the file whose mtime an out-of-process babysitter watches
        self.heartbeat_path = (heartbeat_path if heartbeat_path
                               is not None
                               else os.environ.get(HEARTBEAT_ENV))
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._armed_step: Optional[int] = None
        self._t0 = 0.0
        self._fired = None  # (step, elapsed_s), set by the timer thread
        # liveness from construction: the build and the first step's
        # capture must not read as a hang to the babysitter
        self._beat()

    def _beat(self) -> None:
        touch_heartbeat(self.heartbeat_path)

    # -- arm/disarm ----------------------------------------------------------
    def arm(self, step: int) -> None:
        self._beat()
        with self._lock:
            self._cancel_locked()
            self._armed_step = int(step)
            self._t0 = time.monotonic()
            self._timer = threading.Timer(
                self.timeout_s, self._expire, args=(int(step),))
            self._timer.daemon = True
            self._timer.start()

    def disarm(self) -> None:
        # the step completed: a long stretch between steps (a checkpoint
        # write, an eval) starts its staleness clock from here
        self._beat()
        with self._lock:
            self._cancel_locked()

    def _cancel_locked(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._armed_step = None

    # -- expiry (timer thread) -----------------------------------------------
    def _expire(self, step: int) -> None:
        with self._lock:
            if self._armed_step != step:
                return  # completed (or re-armed) before the lock
            elapsed = time.monotonic() - self._t0
            self._fired = (step, elapsed)
            self._timer = None
            self._armed_step = None
        counters.bump("hangs")
        # from the timer thread, a root span: the main thread it is
        # about is stuck
        trace.event("watchdog.hang", step=step,
                    elapsed_s=round(elapsed, 3),
                    timeout_s=self.timeout_s)
        if self.on_hang is not None:
            try:
                self.on_hang(step, elapsed)
            except Exception:  # diagnostics must not mask the hang
                pass
        _thread.interrupt_main()

    def pop_fired(self):
        """(step, elapsed_s) of an expiry whose interrupt was not consumed
        yet, cleared; None otherwise. A timer that fires just as the step
        completes lands its KeyboardInterrupt after the guard exited; the
        supervisor reads this to take it for the recorded hang rather
        than a user's Ctrl-C."""
        with self._lock:
            fired, self._fired = self._fired, None
            return fired

    # -- the per-step wrapper ------------------------------------------------
    @contextmanager
    def guard(self, step: int):
        """Arm around the body; an expiry inside it surfaces as
        `StepHangError` (a user's Ctrl-C passes through). An expiry
        record is not cleared on entry: a previous step's late interrupt
        raises inside this body with another step and propagates to the
        caller, where `pop_fired` classifies it."""
        self.arm(step)
        try:
            yield self
        except KeyboardInterrupt:
            fired = self._fired
            if fired is not None and fired[0] == int(step):
                self._fired = None
                raise StepHangError(step, fired[1],
                                    self.timeout_s) from None
            raise
        finally:
            self.disarm()
