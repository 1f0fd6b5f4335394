"""Step timing, host phase timers and a device trace (counterpart of
singa_tpu/utils/profiler.py).

- ``StepTimer``: wall time per step, the first step reported apart (on
  the card the first call of a captured step runs uncaptured and the
  second captures its CUDA Graph).
- ``phase(name)``: nestable host-side phase timers accumulated into a
  report.
- ``xla_trace(logdir)``: keeps the reference's name so callers port one
  to one, but the trace is `torch.profiler`'s, not XLA's: CPU activity,
  plus CUDA activity (kernels, copies) when the traced work runs on the
  card, written into `logdir` as a Chrome-trace JSON file (open it in
  Perfetto or chrome://tracing); a CUDA trace starts with a pre-roll of
  empty kernels (`xla_trace` says why).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch

__all__ = ["PREROLL", "PREROLL_KERNEL", "StepTimer", "Trace", "phase",
           "phase_report", "reset_phases", "xla_trace"]


def _wait_for(t) -> None:
    """Block until the work that produces tensor `t` is done: its card's
    current stream for a CUDA tensor, nothing for a CPU one (the host ran
    it already)."""
    t = getattr(t, "data", t)
    dev = getattr(t, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class StepTimer:
    """Accumulates per-step wall times; first step reported separately.

    >>> t = StepTimer()
    >>> with t.step(sync=loss):   # doctest: +SKIP
    ...     _, loss = model(x, y)
    >>> t.summary()               # doctest: +SKIP
    """

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self, sync: Optional[object] = None) -> Iterator[None]:
        """Time one step; pass a tensor as `sync` to wait on its device
        at the end, so that asynchronous launches do not hide device
        time."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _wait_for(sync)
        self.times.append(time.perf_counter() - t0)

    @property
    def compile_time(self) -> float:
        return self.times[0] if self.times else 0.0

    @property
    def steady_mean(self) -> float:
        rest = self.times[1:]
        return sum(rest) / len(rest) if rest else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "steps": len(self.times),
            "first_step_s": round(self.compile_time, 4),
            "steady_mean_s": round(self.steady_mean, 4),
            "steady_steps_per_s": round(
                1.0 / self.steady_mean, 2) if self.steady_mean else 0.0,
        }


_phases: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulate host wall time under `name` (nestable)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _phases[name] += time.perf_counter() - t0
        _counts[name] += 1


def phase_report() -> Dict[str, Dict[str, float]]:
    return {
        name: {
            "total_s": round(total, 4),
            "calls": _counts[name],
            "mean_s": round(total / max(1, _counts[name]), 5),
        }
        for name, total in sorted(_phases.items(), key=lambda kv: -kv[1])
    }


def reset_phases() -> None:
    _phases.clear()
    _counts.clear()


#: the kernel of the pre-roll `xla_trace` launches on the card
PREROLL_KERNEL = "spin_kernel"
#: pre-roll kernels a CUDA trace starts with
PREROLL = 1024


@dataclass
class Trace:
    """What `xla_trace` yields: `path` is the Chrome-trace file once the
    block has ended, `profile` the `torch.profiler.profile` itself (its
    `key_averages()`, `events()`)."""

    path: Optional[str] = None
    profile: Optional[object] = None


@contextlib.contextmanager
def xla_trace(logdir: str) -> Iterator[Trace]:
    """Trace the block with `torch.profiler` (not XLA: the name is the
    reference's) into `logdir`, as `trace-<pid>-<ns>.json`. CUDA
    activity is traced too when this process has initialised a card
    (work on the card); the card is synchronised before the trace stops.
    Wrap a few steady-state steps, not the first.

    A CUDA trace starts with `PREROLL` empty kernels (`PREROLL_KERNEL`,
    `torch.cuda._sleep(1)`) before the block: on an H100 with torch
    2.11 a trace lost the records of its first kernels, about 4.7 a
    minute of the process's age after its first trace and none in a
    fresh process (`scripts/trace_loss_torch.py`), so the pre-roll's
    records are the ones lost and the block's are kept. A trace that
    kept none of them may have lost the block's first records too, and
    raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    os.makedirs(logdir, exist_ok=True)
    out = Trace()
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        if cuda:
            for _ in range(PREROLL):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        try:
            yield out
        finally:
            if cuda:
                torch.cuda.synchronize()
    out.profile = prof
    out.path = os.path.join(logdir,
                            f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)
    if cuda and not _kept_preroll(out.path):
        raise RuntimeError(
            f"the trace {out.path} kept none of its {PREROLL} pre-roll "
            f"kernels ({PREROLL_KERNEL}): the block's first kernel records "
            f"may be lost too")


def _kept_preroll(path: str) -> bool:
    """Whether the Chrome trace at `path` holds a `PREROLL_KERNEL`
    kernel record."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return any(e.get("cat") == "kernel" and PREROLL_KERNEL in e["name"]
               for e in events)
