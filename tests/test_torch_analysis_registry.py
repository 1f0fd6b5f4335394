"""`python -m singa_tpu_torch.analysis` (counterpart of
singa_tpu/analysis/__main__.py) over 4 gloo ranks on the CPU.

- `--devices 4 --device cpu` lints every registry case (the strategies
  runner's model cases, the resilient and supervised 3-D steps, the four
  sharded serving steps): each is clean, the run exits 0 and prints
  `[shardlint] n/n clean`, and the JSON report has the reference's keys;
- `--list` names the applicable cases and the reference's `gpt_bench_*`
  cases as not ported;
- `--hlo --case native_dp` lints the native DP module (C++-emitted by
  `native/hlo_core.cc` through `native.hlo_bridge`) clean under R7, and
  R7 on a PyTorch step, which has no module text, raises.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from helper_torch_parity import SPAWN_DEADLINE_S
from singa_tpu_torch.analysis import __main__ as cli
from singa_tpu_torch.analysis import cases

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
NAMES = [c.name for c in cases.iter_cases(WORLD)]
REPORT_KEYS = {"target", "ok", "violations", "collectives", "schedule",
               "hlo", "notes"}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """(the CLI's stdout, its JSON report) over 4 gloo ranks."""
    out = tmp_path_factory.mktemp("shardlint") / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.analysis", "--devices",
         str(WORLD), "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_DEADLINE_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout, json.loads(out.read_text())


def test_the_sweep_is_clean(sweep):
    stdout, payload = sweep
    n = len(NAMES)
    assert f"[shardlint] {n}/{n} clean" in stdout
    assert payload["devices"] == WORLD and payload["failed"] == 0
    assert payload["cases"] == n and payload["hlo"] is False
    assert set(payload["rules"]) == {"R1", "R2", "R4", "R5", "R7"}


@pytest.mark.parametrize("name", NAMES)
def test_every_registry_case_lints_clean(sweep, name):
    reports = {r["target"]: r for r in sweep[1]["reports"]}
    rep = reports[name]
    assert set(rep) == REPORT_KEYS
    assert rep["ok"] and not rep["violations"], rep
    assert rep["hlo"] is None and rep["collectives"]


def test_the_registry_holds_the_reference_cases_the_port_builds():
    assert {"resilient_3d", "supervised_3d", "serve_tp", "serve_tp_spec",
            "serve_prefix_warm", "serve_chunked", "scan_3d_overlap",
            "pp_transformer", "dp_zero1_overlap"} <= set(NAMES)
    assert len(NAMES) == 25


def test_list_names_the_bench_cases_not_ported():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--list", "--devices", str(WORLD)]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[:len(NAMES)] == NAMES
    for remat in ("none", "per_block", "dots_saveable"):
        for name in (f"gpt_bench_{remat}", f"gpt_bench_3d_{remat}"):
            assert any(ln.startswith(f"{name}: not ported") for ln in lines)


def test_hlo_raises_naming_the_bridge(tmp_path):
    """`--hlo` lints the bridge's module (at world 1: no collective, an
    empty declared census) and writes its report; R7 over a PyTorch
    step raises, naming the bridge's trace as the subject it needs."""
    out = tmp_path / "hlo.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--hlo", "--case", "native_dp", "--device", "cpu",
                         "--out", str(out)]) == 0
    assert "OK   native_dp" in buf.getvalue()
    assert "[shardlint] 1/1 clean" in buf.getvalue()
    payload = json.loads(out.read_text())
    assert payload["hlo"] is True and payload["devices"] == 1
    (rep,) = payload["reports"]
    assert rep["ok"] and rep["hlo"] == {"census": {}, "expected": {}}
    from singa_tpu_torch import analysis

    with pytest.raises(ValueError, match="hlo.trace_native_module"):
        analysis.lint_step(None, rules=("R7",))
