"""NaN/Inf sentinel and dynamic loss scaling for the training step
(counterpart of singa_tpu/resilience/sentinel.py).

One non-finite gradient step poisons every replica of a data-parallel
run: the update writes NaN into the parameters and no later step
recovers. The sentinel makes the update defend itself:

- **Detection rides the global-norm reduction.** The all-finite check
  is `isfinite` of the fp32 square sum the pspec-aware global-norm clip
  computes (`Optimizer._grad_square_sum`): a NaN or Inf anywhere in any
  gradient shard reaches that one reduced scalar, so the sentinel adds
  no collective of its own.
- **A non-finite step is a no-op, branch-free on the device.** The
  reference resolves the new state through one `lax.cond`; here the
  update runs, then every parameter, every slot and the step counter
  are put back with `torch.where(ok, new, old)` against the pre-step
  values, in place. Nothing reads a value on the host, so the whole
  step, the skip included, is one CUDA Graph that a skipped step does
  not recapture; a skipped step is bitwise a step that never happened
  (the lr schedule does not advance either).
- **Dynamic loss scale.** The loss is multiplied by `loss_scale` before
  the backward, and the gradients are unscaled right before the check.
  A skipped step halves the scale (`backoff`); `growth_interval` good
  steps in a row double it. Both must be powers of two: scaling by a
  power of two is exact in floating point, so the scale never perturbs
  the update, and a resumed run with a decayed scale is bitwise one
  that never scaled.
- **Optimizer state.** `loss_scale`, the growth and seen counters and
  the skip count are device scalars in the optimizer's state
  (`Optimizer.dump_states`, the reference's keys), written in place each
  step, so they ride checkpoints and the bitwise-resume oracle covers
  them.

Attach with ``opt.set_sentinel(GradSentinel(...))`` (on the optimizer or
a DistOpt) before the first step. It composes with the plain and half
syncs and ZeRO-1 (`shard_states=True`); the sparse and partial-update
modes refuse it (their residuals would mix gradients scaled at
different loss scales, or their verdict would differ by rank).

`fault_plan` is the deterministic injection hook (`resilience.faults`):
it multiplies the unscaled gradients by a factor of the always-advancing
`seen_steps` counter, on the device, so the injected non-finite step is
part of the captured step, not a host-side hack.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["GradSentinel", "STATE_KEYS"]

#: the optimizer-state keys of the sentinel's scalars (the leading "//"
#: marks them ownerless)
STATE_KEYS = ("//__loss_scale__", "//__ls_good__", "//__ls_seen__",
              "//__nonfinite_skips__")


def _require_pow2(name: str, v: float) -> float:
    f = float(v)
    if f <= 0 or math.log2(f) != round(math.log2(f)):
        raise ValueError(
            f"GradSentinel {name}={v!r} must be a power of two: scaling "
            f"by powers of two is exact in floating point, which is what "
            f"makes a skipped step bitwise equivalent to no step and a "
            f"decayed-scale resume bitwise equal to an unscaled run")
    return f


class GradSentinel:
    """All-finite gradient guard and dynamic loss scale (module
    docstring).

    State (device scalars, written in place):

    - ``loss_scale``: the multiplier applied to the loss (float32);
    - ``good_steps``: finite steps in a row since the last backoff or
      growth (int32);
    - ``seen_steps``: update attempts, skips included: the fault plan's
      step index (int32);
    - ``skip_count``: non-finite steps skipped (int32).
    """

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_interval: int = 2000,
                 backoff: float = 0.5, growth: float = 2.0,
                 min_scale: float = 2.0 ** -14,
                 max_scale: float = 2.0 ** 24,
                 fault_plan=None):
        self.init_scale = _require_pow2("init_scale", init_scale)
        self.backoff = _require_pow2("backoff", backoff)
        self.growth = _require_pow2("growth", growth)
        self.min_scale = _require_pow2("min_scale", min_scale)
        self.max_scale = _require_pow2("max_scale", max_scale)
        self.growth_interval = int(growth_interval)
        self.fault_plan = fault_plan
        self.loss_scale = torch.tensor(self.init_scale, dtype=torch.float32)
        self.good_steps = torch.zeros((), dtype=torch.int32)
        self.seen_steps = torch.zeros((), dtype=torch.int32)
        self.skip_count = torch.zeros((), dtype=torch.int32)

    def to(self, device) -> None:
        """Keep the scalars on the parameters' device (before the first
        captured step: a move makes new tensors)."""
        for name in ("loss_scale", "good_steps", "seen_steps",
                     "skip_count"):
            t = getattr(self, name)
            if t.device != torch.device(device):
                setattr(self, name, t.to(device))

    # -- backward side ---------------------------------------------------------
    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """loss * loss_scale, on the tape, so the backward hands every
        parameter a scaled gradient. The caller's returned loss stays
        unscaled."""
        return loss * self.loss_scale.to(loss.device, loss.dtype)

    def unscale(self, g: torch.Tensor) -> torch.Tensor:
        """A gradient back at its unscaled magnitude (exact: the scale is
        a power of two), times the fault plan's factor: an injected fault
        takes the same detection and skip as a real one."""
        inv = 1.0 / self.loss_scale
        if self.fault_plan is not None:
            inv = inv * self.fault_plan.factor(self.seen_steps)
        return g * inv.to(g.dtype)

    # -- update side -------------------------------------------------------------
    def check(self, square_sum: torch.Tensor) -> torch.Tensor:
        """The all-finite flag (a bool device scalar) of the global-norm
        square sum, already reduced over every sharded axis."""
        return torch.isfinite(square_sum)

    @torch.no_grad()
    def advance(self, ok: torch.Tensor) -> None:
        """The scale dynamics, branch-free: a good step counts toward
        growth (x`growth` after `growth_interval` in a row, capped at
        `max_scale`); a skipped one backs the scale off (x`backoff`,
        floored at `min_scale`), zeroes the streak and counts a skip.
        `seen_steps` advances on both."""
        s, g, k = self.loss_scale, self.good_steps, self.skip_count
        g2 = g + 1
        grown = g2 >= self.growth_interval
        s_good = torch.where(
            grown, torch.clamp(s * self.growth, max=self.max_scale), s)
        g_good = torch.where(grown, torch.zeros_like(g2), g2)
        s_bad = torch.clamp(s * self.backoff, min=self.min_scale)
        s.copy_(torch.where(ok, s_good, s_bad))
        g.copy_(torch.where(ok, g_good, torch.zeros_like(g2)))
        k.add_((~ok).to(k.dtype))
        self.seen_steps.add_(1)

    # -- state (the optimizer's dump/load, checkpoints) ----------------------
    def dump_states(self) -> Dict[str, torch.Tensor]:
        return {
            "//__loss_scale__": self.loss_scale,
            "//__ls_good__": self.good_steps,
            "//__ls_seen__": self.seen_steps,
            "//__nonfinite_skips__": self.skip_count,
        }

    def absorb_states(self, states: Dict) -> Dict:
        """Take this sentinel's keys out of a state dict, copying them
        into the scalars in place (a captured step keeps reading them);
        a missing key (a checkpoint from before the sentinel) keeps its
        current value. Returns the other entries; the caller's dict is
        untouched."""
        rest = dict(states)
        for key, t in self.dump_states().items():
            if key in rest:
                with torch.no_grad():
                    t.copy_(torch.as_tensor(rest.pop(key)).reshape(()))
        return rest

    # -- observability -----------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        """A host snapshot of the scalars (reads the device)."""
        return {
            "nonfinite_skips": int(self.skip_count),
            "loss_scale": float(self.loss_scale),
            "good_steps": int(self.good_steps),
            "steps_seen": int(self.seen_steps),
        }
