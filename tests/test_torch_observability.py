"""The port's telemetry (singa_tpu_torch.observability) against the
reference's (singa_tpu.observability): the same observations give the
same counter, gauge and histogram values, buckets and percentiles; the
span records have the reference's shape and nesting; disabled, nothing
is recorded."""

import numpy as np
import pytest

from singa_tpu.observability import metrics as jax_metrics
from singa_tpu.observability import trace as jax_trace
from singa_tpu_torch.observability import metrics, trace


@pytest.fixture(autouse=True)
def _isolate():
    for m in (metrics, jax_metrics):
        m.reset()
        m.disable()
    yield
    for m in (metrics, jax_metrics):
        m.reset()
        m.disable()


def test_same_observations_give_the_reference_values():
    rng = np.random.default_rng(0)
    obs = np.concatenate([rng.exponential(3.0, 500), [0.5, 2500.0, 1e5]])
    for m in (metrics, jax_metrics):
        c = m.counter("serve_tokens")
        c.inc()
        c.inc(41)
        g = m.gauge("serve_slot_occupancy")
        g.set(0.75)
        g.inc(0.5)
        g.dec(0.25)
        h = m.histogram("serve_token_ms")
        for v in obs:
            h.observe(v)
    for name in ("serve_tokens", "serve_slot_occupancy"):
        assert metrics.DEFAULT.get(name).value == \
            jax_metrics.DEFAULT.get(name).value
    h, jh = (m.histogram("serve_token_ms") for m in (metrics, jax_metrics))
    assert h.count == jh.count and h.sum == jh.sum
    assert h.cumulative_buckets() == jh.cumulative_buckets()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert h.percentile(q) == jh.percentile(q)
        assert metrics.percentile(list(obs), q) == \
            jax_metrics.percentile(list(obs), q)
    assert metrics.percentile([], 0.5) is None
    assert metrics.snapshot() == jax_metrics.snapshot()
    assert metrics.DEFAULT_MS_BUCKETS == jax_metrics.DEFAULT_MS_BUCKETS
    for name, text in metrics.HELP.items():
        assert name in jax_metrics.HELP and text, name


def test_type_conflict_refused_by_name():
    metrics.counter("serve_steps")
    with pytest.raises(TypeError, match="serve_steps.*Counter"):
        metrics.gauge("serve_steps")


def test_hot_path_gate_and_reset():
    assert not metrics.enabled()
    metrics.enable()
    assert metrics.enabled()
    metrics.disable()
    h = metrics.histogram("serve_token_ms")
    h.observe(1.0)
    metrics.reset()
    assert h.count == 0 and not h.touched and metrics.snapshot() == {}


def _records(mod, path):
    mod.enable(str(path))
    try:
        with mod.span("serve.prefill", batch=2, cached_tokens=0):
            mod.event("inner", k=1)
        with pytest.raises(ValueError):
            with mod.span("serve.prefill", batch=1):
                raise ValueError("x")
        sp = mod.begin_span("drain")
        sp.end(queued=3)
        sp.end(queued=4)  # idempotent
    finally:
        mod.disable()
    return mod.read_events(str(path))


def test_spans_have_the_reference_shape_and_nesting(tmp_path):
    ours = _records(trace, tmp_path / "ours.jsonl")
    theirs = _records(jax_trace, tmp_path / "theirs.jsonl")

    def shape(evs):
        sids = {e["sid"]: e["name"] for e in evs}
        return sorted((e["name"], tuple(sorted(e)),
                       tuple(sorted(e["attrs"].items())),
                       str(sids.get(e["parent"]))) for e in evs)

    assert shape(ours) == shape(theirs)
    inner = trace.find_spans(ours, "inner")[0]
    outer = [e for e in trace.find_spans(ours, "serve.prefill")
             if "error" not in e["attrs"]][0]
    assert inner["parent"] == outer["sid"] and inner["dur_s"] == 0.0


def test_disabled_records_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(trace.TRACE_ENV, raising=False)
    assert not trace.enabled() and trace.trace_path() is None
    with trace.span("serve.prefill") as sp:
        trace.event("x")
    assert sp.sid is None
    assert trace.read_events(str(tmp_path / "none.jsonl")) == []
    assert not list(tmp_path.iterdir())
    # the serving engine's hot-path handles stay unset while disabled
    from singa_tpu_torch.serving import Request, ServingEngine
    from tests.helper_torch_parity import serving_gpt_pair

    eng = ServingEngine(serving_gpt_pair(max_len=32)[1], slots=2,
                        window=32)
    eng.admit(Request("r", np.arange(5, dtype=np.int32), 3))
    while eng.n_active:
        eng.step()
    assert eng._step_metrics is None
    h = metrics.DEFAULT.get("serve_token_ms")
    assert h is None or not h.touched
