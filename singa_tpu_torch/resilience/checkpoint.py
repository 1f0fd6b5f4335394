"""`PreemptionGuard` (counterpart of the preemption class of
singa_tpu/resilience/checkpoint.py). The sharded checkpoint commit,
async saves and elastic restore are ROADMAP queue 1 item 17."""

from __future__ import annotations

import signal as _signal
from typing import Any, Dict

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """SIGTERM-safe loops: the handler only sets a flag (Python signal
    handlers run between bytecodes, so the step in flight always
    completes), and the loop reads `triggered` between steps, drains or
    saves, and exits 0::

        with resilience.PreemptionGuard() as guard:
            for step in range(start, n):
                model.train_one_batch(x, y)
                if guard.triggered:
                    guard.exit_zero()

    `exit_zero` raises SystemExit(0): the scheduler sees a clean exit.
    Previous handlers are restored on context exit."""

    def __init__(self, signals=(_signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self._prev: Dict[int, Any] = {}

    def _on_signal(self, signum, frame):
        self.triggered = True

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            self._prev[s] = _signal.signal(s, self._on_signal)
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            _signal.signal(s, prev)
        self._prev.clear()
        return False

    def exit_zero(self, save_fn=None):
        """Optionally run `save_fn` (the checkpoint), then exit 0:
        preemption handled, not failed."""
        if save_fn is not None:
            save_fn()
        raise SystemExit(0)
