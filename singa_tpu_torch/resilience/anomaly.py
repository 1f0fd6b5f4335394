"""Loss-spike detection from robust running statistics (counterpart of
singa_tpu/resilience/anomaly.py, pure Python, copied whole).

The supervisor's rollback trigger: a poisoned batch (a corrupt record)
or a poisoned update (a huge finite gradient the NaN sentinel cannot
see) shows as the training loss jumping far outside its recent band.
The detector reads the loss scalar the step already returns, so it adds
no collective and no device work.

- **median/MAD, not mean/std.** One spike inflates a running std so much
  that the next spike looks normal; the median and the median absolute
  deviation are immune to the outliers being hunted.
- **Spikes never enter the history,** so a poison burst cannot drag the
  baseline up and mask its own tail.
- **Non-finite losses are ignored, not flagged:** they are the
  sentinel's (skipped on the device, parameters untouched).
- **One-sided:** a loss drop is never a rollback.
- **Scale floor:** `rel_floor * |median|` (and an absolute epsilon)
  keeps a near-constant window (MAD ~ 0) from flagging numeric noise.
"""

from __future__ import annotations

import math
import statistics
from collections import deque
from typing import Dict

__all__ = ["SpikeDetector"]


class SpikeDetector:
    """Flag a loss whose robust z-score against the recent window exceeds
    `zmax` (module docstring). `update(loss) -> bool` per step; True
    means "this step is poisoned: roll back"."""

    def __init__(self, window: int = 32, zmax: float = 8.0,
                 min_history: int = 4, rel_floor: float = 0.05,
                 abs_floor: float = 1e-6):
        if window < max(2, int(min_history)):
            raise ValueError(
                f"SpikeDetector window={window} must hold at least "
                f"min_history={min_history} (>=2) samples")
        self.zmax = float(zmax)
        self.min_history = int(min_history)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self._hist: deque = deque(maxlen=int(window))
        self.spikes = 0

    def update(self, loss) -> bool:
        v = float(loss)
        if not math.isfinite(v):
            return False  # the sentinel's, not a spike
        if len(self._hist) < self.min_history:
            self._hist.append(v)
            return False
        med = statistics.median(self._hist)
        mad = statistics.median(abs(h - med) for h in self._hist)
        # 1.4826 * MAD estimates sigma for gaussian noise; the floors keep
        # a flat window from flagging numeric jitter
        scale = max(1.4826 * mad, self.rel_floor * abs(med),
                    self.abs_floor)
        if (v - med) / scale > self.zmax:
            self.spikes += 1
            return True  # poisoned sample: flagged, never absorbed
        self._hist.append(v)
        return False

    def stats(self) -> Dict[str, float]:
        """Host-side snapshot for logs."""
        med = (statistics.median(self._hist) if self._hist
               else float("nan"))
        return {"n": len(self._hist), "median": med,
                "spikes": self.spikes}
