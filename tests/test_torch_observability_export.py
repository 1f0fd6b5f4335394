"""The port's metric exporters and metric-name lint
(singa_tpu_torch.observability.export, .lint) against the reference's,
mirroring tests/test_observability.py:130-233 (the supervisor keys, the
exporters, the endpoint, the lint green and mutated) and
tests/test_observability_serving.py:65-188 (a serving process's live
page, the /healthz flip during a real SIGTERM drain, the acceptance
gauge, no capture added by telemetry).

F11: the port's `HELP` lacked 16 of the reference's names, 9 of them
`SUPERVISOR_KEYS` and 3 emitted by the port itself; the reference's
inventory is read by parsing its source, never imported into the port.

The parity oracle is byte for byte: the same observations, made in a
fresh registry of each package, render the same Prometheus text and the
same JSON snapshot. The serving cases run the port alone, on a small
scanned GPT with seeded numpy weights.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from singa_tpu_torch.observability import export, lint, metrics, trace
from singa_tpu_torch.resilience import counters

ROOT = Path(__file__).resolve().parents[1]
_VOCAB, _W = 61, 64

#: the names whose help text the port words for its own semantics (CUDA
#: Graph captures for XLA compiles; no compile in a step's wall time)
PORT_WORDED = {"graph_compiles", "train_step_ms", "serve_steps",
               "serve_token_ms", "serve_prefill_wait_ms"}


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(trace.TRACE_ENV, raising=False)
    counters.reset()
    metrics.disable()
    yield
    trace.disable()
    counters.reset()
    metrics.disable()


def _reference_help():
    """The reference's HELP, parsed from its source."""
    tree = ast.parse((ROOT / "singa_tpu/observability/metrics.py")
                     .read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.AnnAssign)
                and getattr(node.target, "id", None) == "HELP"):
            return {ast.literal_eval(k): ast.literal_eval(v)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no HELP in the reference's metrics.py")


# -- F11: the inventory -------------------------------------------------------


def test_help_declares_every_name_the_reference_declares():
    ref = _reference_help()
    assert len(ref) == 47
    missing = sorted(set(ref) - set(metrics.HELP))
    assert not missing, missing
    for name, text in metrics.HELP.items():
        assert isinstance(text, str) and text.strip(), name
    for name in set(ref) - PORT_WORDED:
        assert metrics.HELP[name] == ref[name], name


def test_supervisor_keys_are_registered_counters():
    for key in counters.SUPERVISOR_KEYS:
        assert metrics.HELP.get(key), key
        assert metrics.counter(key).help == metrics.HELP[key]


# -- the exporters: byte-for-byte parity ------------------------------------------


def _observe(m, reg, seed):
    """The same observations into registry `reg` of metrics module `m`."""
    rng = np.random.default_rng(seed)
    reg.counter("restores").inc(int(rng.integers(1, 9)))
    reg.counter("spec_accepts").inc(0)
    reg.counter("custom_total", "a counter with its own help").inc(3)
    reg.counter("never_touched")
    g = reg.gauge("serve_slot_occupancy")
    g.set(float(rng.random()))
    reg.gauge("serve_kv_utilization").set(0.75)
    reg.gauge("serve_queue_depth").set(2.0)
    reg.gauge("big").set(1e20)
    reg.gauge("tiny").set(1e-7)
    reg.gauge("negative").set(-1.5)
    h = reg.histogram("serve_decode_stall_ms")
    for v in np.concatenate([rng.exponential(4.0, 50), [0.5, 1e5]]):
        h.observe(float(v))
    c = reg.histogram("custom_ms", "custom buckets", buckets=(1, 2.5, 10))
    for v in (0.1, 1.0, 2.0, 3.0, 12.0):
        c.observe(v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_and_snapshot_equal_the_references_byte_for_byte(seed):
    from singa_tpu.observability import export as jax_export
    from singa_tpu.observability import metrics as jax_metrics

    ours, theirs = metrics.Registry(), jax_metrics.Registry()
    _observe(metrics, ours, seed)
    _observe(jax_metrics, theirs, seed)
    text = export.prometheus_text(ours)
    assert text == jax_export.prometheus_text(theirs)
    assert json.dumps(export.json_snapshot(ours)) == json.dumps(
        jax_export.json_snapshot(theirs))
    assert "never_touched" not in text
    assert 'custom_ms_bucket{le="+Inf"} 5' in text
    assert "big 100000000000000000000" in text


def test_empty_registry_exports_an_empty_page():
    reg = metrics.Registry()
    assert export.prometheus_text(reg) == ""
    assert export.json_snapshot(reg) == {"counters": {}, "gauges": {},
                                         "histograms": {}}


def test_json_snapshot_carries_exact_percentiles():
    h = metrics.histogram("serve_token_ms")
    xs = [2.0, 4.0, 8.0, 16.0]
    for v in xs:
        h.observe(v)
    rec = export.json_snapshot()["histograms"]["serve_token_ms"]
    assert rec["count"] == 4
    assert rec["p50"] == metrics.percentile(xs, 0.5)
    assert rec["p95"] == metrics.percentile(xs, 0.95)


# -- the endpoint ---------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_endpoints():
    counters.bump("saves")
    state = {"status": "ok"}
    srv = export.MetricsServer(healthz=lambda: dict(state))
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert srv.url == base and srv.start() == port
        code, body = _get(base + "/metrics")
        assert code == 200 and "saves 1" in body
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        state["status"] = "draining"
        code, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "draining"
        code, body = _get(base + "/snapshot")
        assert code == 200 and json.loads(body)["counters"]["saves"] == 1
        assert _get(base + "/nope")[0] == 404
    finally:
        srv.stop()
    assert srv._server is None


def test_heartbeat_healthz_judges_observed_change(tmp_path):
    beat = tmp_path / "heartbeat"
    beat.write_text("1")
    judge = export.heartbeat_healthz(str(beat), stale_after_s=0.0)
    assert judge()["status"] == "ok"       # first sight: full window
    time.sleep(0.02)
    assert judge()["status"] == "stale"    # unchanged past the window
    beat.write_text("22")
    assert judge()["status"] == "ok"       # a change is liveness


# -- the metric-name lint ---------------------------------------------------------


def test_metric_name_lint_green():
    assert lint.check() == []
    names = lint.scan_emitted_names()
    for expect in ("babysit", "restarts_external", "fleet",
                   "preempt_drains", "serve_token_ms", "graph_compiles",
                   "serve_acceptance_rate", "serve_prefix_hits"):
        assert expect in names, (expect, sorted(names))
    out = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.observability.lint"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "metric-name lint: ok" in out.stdout


def test_metric_name_lint_catches_undeclared(tmp_path):
    pkg = tmp_path / "fakepkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        'counters.bump("totally_undeclared_metric")\n'
        'metrics.gauge(\n    "another_undeclared")\n')
    problems = lint.check(str(pkg))
    assert any("totally_undeclared_metric" in p for p in problems)
    assert any("another_undeclared" in p and "mod.py:2" in p
               for p in problems)


# -- a serving process ------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    from singa_tpu_torch.examples.serve_gpt import seeded_weights
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT

    m = GPT(vocab_size=_VOCAB, d_model=48, num_layers=2, num_heads=4,
            max_len=_W, dropout=0.0, scan_blocks=True, device="cpu")
    load_singa_tpu_params(m, seeded_weights(m, 0))
    m.eval()
    return m


def _prompt(rng, n):
    return rng.integers(0, _VOCAB, size=n).astype(np.int32)


def test_drain_flips_healthz_over_http(model, tmp_path):
    """A real SIGTERM mid-serve: /healthz, polled over HTTP from a token
    callback during the drain, answers 503 "draining" (200 "ok"
    before); the drain span's counts are the drain report's."""
    from singa_tpu_torch.serving import Frontend, ServingEngine

    trace.enable(str(tmp_path / "trace.jsonl"))
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    srv = export.MetricsServer(healthz=fe.healthz)
    base = f"http://127.0.0.1:{srv.start()}"
    code, body = _get(base + "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    rng = np.random.default_rng(0)
    fired, seen = {"done": False}, []

    def cb(tok, done):
        if len(h1.tokens) == 3 and not fired["done"]:
            fired["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)
        elif fired["done"] and fe.draining and not seen:
            seen.append(_get(base + "/healthz"))

    h1 = fe.submit(_prompt(rng, 5), 12, on_token=cb)
    h2 = fe.submit(_prompt(rng, 7), 12, on_token=cb)
    h3 = fe.submit(_prompt(rng, 6), 12)  # stays queued (2 slots)
    report = fe.run()
    srv.stop()
    trace.disable()
    assert report["drained"] and report["preempted"] == [h3.rid]
    assert h1.status == "done" and h2.status == "done"
    assert seen, "no /healthz poll landed during the drain"
    code, body = seen[0]
    assert code == 503 and json.loads(body)["status"] == "draining"
    drains = trace.find_spans(trace.read_events(
        str(tmp_path / "trace.jsonl")), "serve.preempt_drain")
    assert len(drains) == 1
    assert drains[0]["attrs"]["in_flight"] == 2


def test_live_metrics_page_of_a_serving_process(model):
    from singa_tpu_torch.serving import Frontend, ServingEngine

    metrics.enable()
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    srv = export.MetricsServer()
    port = srv.start()
    rng = np.random.default_rng(1)
    for r in range(4):
        fe.submit(_prompt(rng, 5 + 3 * r), 6 + r)
    fe.run()
    code, body = _get(f"http://127.0.0.1:{port}/metrics")
    srv.stop()
    assert code == 200
    for name in ("serve_queue_depth", "serve_slot_occupancy",
                 "serve_kv_utilization", "serve_kv_blocks_used",
                 "serve_token_ms_bucket", "serve_token_ms_count",
                 "serve_tokens"):
        assert name in body, f"{name} missing from /metrics:\n{body}"
    h = metrics.histogram("serve_token_ms")
    assert h.count == eng.steps and h.percentile(0.95) is not None
    # a drained idle server exports zero occupancy and utilisation
    for name in ("serve_slots_active", "serve_slot_occupancy",
                 "serve_kv_blocks_used", "serve_kv_utilization"):
        assert metrics.gauge(name).value == 0, name
        assert f"\n{name} 0\n" in body, name


def test_telemetry_adds_no_capture(model):
    from singa_tpu_torch.serving import Frontend, ServingEngine

    metrics.enable()
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    rng = np.random.default_rng(2)
    for r in range(4):  # more than slots: evict/re-admit interleaving
        fe.submit(_prompt(rng, 4 + 5 * r), 5 + r)
    fe.run()
    assert eng.decode_compiles == 1
    assert metrics.counter("serve_steps").value == eng.steps


def test_speculative_engine_sets_the_acceptance_gauge(model):
    from singa_tpu_torch.serving import Frontend, SpeculativeEngine

    metrics.enable()
    eng = SpeculativeEngine(model, model, spec_k=3, slots=2,
                            block_size=16, window=_W)
    fe = Frontend(eng)
    rng = np.random.default_rng(3)
    for r in range(3):
        fe.submit(_prompt(rng, 5 + 2 * r), 8)
    fe.run()
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1
    g = metrics.gauge("serve_acceptance_rate")
    assert g.value == pytest.approx(eng.acceptance_rate) == 1.0
    assert metrics.counter("serve_tokens").value == 3 * (8 - 1)
    page = export.prometheus_text()
    assert "\nserve_acceptance_rate 1\n" in page
