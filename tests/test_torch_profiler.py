"""The port's profiler (singa_tpu_torch.utils.profiler, counterpart of
singa_tpu/utils/profiler.py) on the CPU.

- `StepTimer`, `phase`, `phase_report` and `reset_phases` against the
  reference's on one scripted sequence of calls (the calls of
  tests/test_amp_profiler.py::test_step_timer_and_phases, widened):
  the same keys, call counts and report order; the phases sleep for
  clearly different times so that the order (by total time) is the
  same on both sides.
- `StepTimer.step(sync=t)` accepts a CPU tensor (nothing to wait on).
- `xla_trace(logdir)` on the CPU writes a Chrome-trace JSON file into
  `logdir` that names the `aten::` ops of the traced work.
"""

import json
import time

import pytest
import torch

from singa_tpu.utils import profiler as ref_profiler
from singa_tpu_torch.utils import profiler


def script(prof):
    """One scripted sequence of calls: (summary, report)."""
    t = prof.StepTimer()
    for _ in range(3):
        with t.step():
            sum(range(1000))
    prof.reset_phases()
    with prof.phase("fwd"):
        with prof.phase("inner"):
            time.sleep(0.02)
        time.sleep(0.05)
    for _ in range(2):
        with prof.phase("bwd"):
            time.sleep(0.004)
    try:
        with prof.phase("raises"):
            raise KeyError
    except KeyError:
        pass
    return t.summary(), prof.phase_report()


@pytest.fixture(scope="module")
def both():
    return script(profiler), script(ref_profiler)


def test_step_timer_summary_keys_match_the_reference(both):
    (got, _), (want, _) = both
    assert list(got) == list(want)
    assert got["steps"] == want["steps"] == 3
    assert got["steady_mean_s"] >= 0 and got["first_step_s"] >= 0


def test_phase_report_matches_the_reference(both):
    (_, got), (_, want) = both
    assert list(got) == list(want) == ["fwd", "inner", "bwd", "raises"]
    for name in want:
        assert list(got[name]) == list(want[name])
        assert got[name]["calls"] == want[name]["calls"]
    assert got["bwd"]["calls"] == 2 and got["fwd"]["total_s"] >= 0.07
    profiler.reset_phases()
    assert profiler.phase_report() == {}


def test_step_sync_on_a_cpu_tensor():
    t = profiler.StepTimer()
    x = torch.ones(64, 64)
    with t.step(sync=x):
        y = x @ x
    with t.step(sync=y):
        pass
    assert len(t.times) == 2 and t.summary()["steps"] == 2


def test_xla_trace_writes_a_chrome_trace_naming_aten_ops(tmp_path):
    x = torch.randn(32, 32)
    with profiler.xla_trace(str(tmp_path / "trace")) as tr:
        (x @ x).relu().sum()
    assert tr.path is not None and tr.path.startswith(str(tmp_path))
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert {"aten::mm", "aten::relu", "aten::sum"} <= names, sorted(names)
    # the pre-roll is the card's
    assert not any("_sleep" in n or profiler.PREROLL_KERNEL in n
                   for n in names)
    assert tr.profile is not None


def test_a_trace_without_its_preroll_is_told_apart(tmp_path):
    """`xla_trace` raises on a CUDA trace that kept no pre-roll kernel:
    `_kept_preroll` reads that from the exported file."""
    def trace(*names):
        path = tmp_path / f"{len(names)}.json"
        path.write_text(json.dumps({"traceEvents": [
            {"cat": "kernel", "name": n} for n in names]}))
        return str(path)

    assert profiler._kept_preroll(trace(
        f"void (anonymous namespace)::{profiler.PREROLL_KERNEL}(long)",
        "flash_fwd_kernel"))
    assert not profiler._kept_preroll(trace("flash_fwd_kernel"))
