"""The port's streaming front end (singa_tpu_torch.serving.frontend)
against the reference: the oracles of tests/test_serving_frontend.py,
test_serving_overlap.py, test_serving_chunked.py (not its tp2 case),
test_serving_prefix_frontend.py and the serving names of
test_observability_serving.py, on the small random GPT of the serving
tests (vocab 61, d 48, 2 scanned blocks, window 64) whose seeded
weights both packages carry.

- Streaming and backpressure, the SIGTERM drain (a real signal) and
  its token budget, refusals surfaced, malformed requests refused,
  cancel (queued, active, mid-prefill).
- The overlap and chunked boundaries: zero decode rebuilds, greedy
  streams equal the reference's `generate` (sampled ones the port's
  own), and the same greedy workload served FIFO, overlapped and
  chunk-scheduled through the reference's `Frontend` gives the same
  streams.
- The prefix-affine queue order, the drain span and the /healthz
  judgment during a drain, and the metric names.
"""

import os
import signal

import numpy as np
import pytest

from singa_tpu.serving import ChunkedScheduler as JaxScheduler
from singa_tpu.serving import Frontend as JaxFrontend
from singa_tpu.serving import ServingEngine as JaxEngine
from singa_tpu_torch.observability import metrics, trace
from singa_tpu_torch.resilience import counters
from singa_tpu_torch.serving import (
    ChunkedScheduler, Frontend, OutOfBlocksError, Request, ServingEngine,
    SpeculativeEngine)
from tests.helper_torch_parity import serving_gpt_pair

_VOCAB = 61
_W = 64


@pytest.fixture(scope="module")
def pair():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(trace.TRACE_ENV, raising=False)
    monkeypatch.delenv(trace.OWNER_ENV, raising=False)
    counters.reset()
    metrics.disable()
    yield
    trace.disable()
    counters.reset()
    metrics.disable()


_GENERATED = {}


def _ref(pair, prompt, n_new, temperature=0.0, seed=0):
    """Greedy: the REFERENCE's solo `generate` (memoized), held against
    the port's. Sampled: the port's own `generate` (its noise is its
    own)."""
    ref_model, port = pair
    ours = port.generate(prompt, n_new, window=_W, temperature=temperature,
                         seed=seed)[0, len(prompt):]
    if temperature > 0:
        return ours
    key = (np.asarray(prompt, np.int32).tobytes(), n_new)
    if key not in _GENERATED:
        _GENERATED[key] = np.asarray(ref_model.generate(
            prompt, n_new=n_new, window=_W)[0, len(prompt):], np.int32)
        np.testing.assert_array_equal(ours, _GENERATED[key])
    return _GENERATED[key]


def _prompt(rng, n):
    return rng.integers(0, _VOCAB, size=n).astype(np.int32)


def _sigterm():
    os.kill(os.getpid(), signal.SIGTERM)


def _tokens(h):
    return np.asarray(h.tokens, np.int32)


# -- streaming, drain, refusals, cancel (test_serving_frontend.py) ------------


def test_streaming_callbacks_and_backpressure(pair, model):
    rng = np.random.default_rng(0)
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    streams, handles = {}, []
    for r in range(4):
        p = _prompt(rng, 5 + 9 * r)
        streams[r] = {"prompt": p, "seen": [], "n_new": 6 + r}

        def cb(tok, done, r=r):
            streams[r]["seen"].append(tok)

        handles.append(fe.submit(p, streams[r]["n_new"], on_token=cb))
    report = fe.run()
    assert sorted(report["completed"]) == [0, 1, 2, 3]
    assert not report["drained"]
    for r, h in enumerate(handles):
        assert h.status == "done"
        np.testing.assert_array_equal(
            np.asarray(streams[r]["seen"], np.int32),
            _ref(pair, streams[r]["prompt"], streams[r]["n_new"]))
        assert h.tokens == streams[r]["seen"]
    assert eng.decode_compiles == 1


def test_sigterm_drains_in_flight_and_returns_queued(pair, model):
    rng = np.random.default_rng(1)
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    seen = {"n": 0}

    def trip(tok, done):
        seen["n"] += 1
        if seen["n"] == 3:
            _sigterm()

    p1, p2, p3 = _prompt(rng, 6), _prompt(rng, 20), _prompt(rng, 8)
    h1 = fe.submit(p1, 12, on_token=trip)
    h2 = fe.submit(p2, 12)
    h3 = fe.submit(p3, 12)  # queued behind the 2 slots
    with pytest.raises(SystemExit) as exc:
        fe.run(exit_on_preempt=True)
    assert exc.value.code == 0
    assert h1.status == "done" and len(h1.tokens) == 12
    assert h2.status == "done" and len(h2.tokens) == 12
    assert h3.status == "preempted" and not h3.tokens
    assert counters.snapshot()["preempt_drains"] == 1
    assert counters.supervisor_snapshot()["preempt_drains"] == 1
    np.testing.assert_array_equal(_tokens(h2), _ref(pair, p2, 12))
    # the guard restored the previous handler
    assert signal.getsignal(signal.SIGTERM) is not None


def test_drain_token_budget_bounds_the_drain(model):
    rng = np.random.default_rng(2)
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng, drain_token_budget=4)
    seen = {"n": 0}

    def trip(tok, done):
        seen["n"] += 1
        if seen["n"] == 2:
            _sigterm()

    h1 = fe.submit(_prompt(rng, 6), 30, on_token=trip)
    h2 = fe.submit(_prompt(rng, 9), 30)
    report = fe.run()
    assert report["drained"]
    assert report["drain_tokens"] <= 4 + eng.slots  # one step's slack
    assert h1.status == "preempted" and 0 < len(h1.tokens) < 30
    assert h2.status == "preempted" and 0 < len(h2.tokens) < 30


def test_never_fitting_request_surfaces_refusal(model):
    rng = np.random.default_rng(3)
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        num_blocks=3)  # 2 allocatable blocks
    fe = Frontend(eng)
    h = fe.submit(_prompt(rng, 30), 20)  # needs 4 blocks > 2 total
    with pytest.raises(OutOfBlocksError, match="needs 4 blocks"):
        fe.run()
    assert h.status == "preempted" and not h.tokens


def test_malformed_request_is_refused_not_wedging(model):
    rng = np.random.default_rng(5)
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    good1 = fe.submit(_prompt(rng, 6), 8)
    bad = fe.submit(_prompt(rng, 41), 40)  # 81 > window 64
    good2 = fe.submit(_prompt(rng, 9), 8)
    report = fe.run()
    assert bad.status == "refused" and bad.done and not bad.tokens
    assert isinstance(bad.error, ValueError)
    assert "window" in str(bad.error)
    assert good1.status == "done" and len(good1.tokens) == 8
    assert good2.status == "done" and len(good2.tokens) == 8
    assert sorted(report["completed"]) == [good1.rid, good2.rid]


def test_cancel_queued_and_active(model):
    rng = np.random.default_rng(4)
    eng = ServingEngine(model, slots=1, block_size=16, window=_W)
    fe = Frontend(eng)
    h1 = fe.submit(_prompt(rng, 5), 20)
    h2 = fe.submit(_prompt(rng, 5), 20)
    fe.pump()  # h1 active, h2 queued
    assert (h1.status, h2.status) == ("active", "queued")
    fe.cancel(h2)
    assert h2.status == "cancelled"
    fe.pump()
    fe.cancel(h1)
    assert h1.status == "cancelled"
    assert eng.n_active == 0
    assert fe.run()["completed"] == []


# -- the overlap boundary (test_serving_overlap.py) ---------------------------


def test_overlap_identity_zero_rebuilds_and_ticket_lifecycle(pair, model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng, overlap_prefill=True)
    rng = np.random.default_rng(2)
    prompts = [_prompt(rng, int(rng.integers(4, 30))) for _ in range(6)]
    handles = [fe.submit(p, 8) for p in prompts]
    report = fe.run()
    assert sorted(report["completed"]) == sorted(h.rid for h in handles)
    for h, p in zip(handles, prompts):
        np.testing.assert_array_equal(_tokens(h), _ref(pair, p, 8))
    assert eng.decode_compiles == 1
    assert eng.prefill_pending == 0


def test_zero_free_blocks_mid_overlap_holds_then_admits(pair, model):
    eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                        num_blocks=5)
    rng = np.random.default_rng(4)
    a = Request("a", _prompt(rng, 18), 8)    # 2 blocks
    b = Request("b", _prompt(rng, 20), 10)   # 2 blocks
    eng.admit_many([a, b])
    assert eng.allocator.free_blocks == 0
    late = Request("c", _prompt(rng, 9), 8)
    ticket, err = eng.begin_prefill_async([late])
    assert ticket is None and isinstance(err, OutOfBlocksError)
    eng2 = ServingEngine(model, slots=3, block_size=16, window=_W,
                         num_blocks=5)
    fe = Frontend(eng2, overlap_prefill=True)
    ha = fe.submit(a.prompt, 8)
    hb = fe.submit(b.prompt, 10)
    hc = fe.submit(late.prompt, 8)
    report = fe.run()
    for h, n_new in ((ha, 8), (hb, 10), (hc, 8)):
        assert h.status == "done" and h.rid in report["completed"]
        np.testing.assert_array_equal(
            _tokens(h), _ref(pair, h.request.prompt, n_new))
    assert eng2.decode_compiles == 1


def test_cancel_mid_prefill_defers_eviction_to_finish(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng, overlap_prefill=True)
    rng = np.random.default_rng(5)
    h = fe.submit(_prompt(rng, 6), 8)
    fe._overlap_boundary()          # dispatches h's prefill
    assert h.rid in fe._inflight
    used_before = eng.allocator.used_blocks
    assert used_before > 0
    fe.cancel(h)
    assert h.status == "cancelled"
    assert eng.allocator.used_blocks == used_before  # deferred
    fe._overlap_boundary()          # the boundary finishes the ticket
    assert eng.allocator.used_blocks == 0
    assert eng.n_active == 0 and not h.tokens
    assert fe.run()["completed"] == []


def test_drain_with_prefill_in_flight_queues_it_back(pair, model,
                                                     tmp_path):
    trace.enable(str(tmp_path / "trace.jsonl"))
    eng = ServingEngine(model, slots=4, block_size=16, window=_W)
    fe = Frontend(eng, overlap_prefill=True)
    rng = np.random.default_rng(6)
    fired = {"done": False}
    late = {}

    def cb(tok, done):
        if len(h1.tokens) == 2 and not fired["done"]:
            fired["done"] = True
            late["h2"] = fe.submit(_prompt(rng, 7), 10)
            late["h3"] = fe.submit(_prompt(rng, 9), 10)
            fe._overlap_boundary()
            assert fe._ticket is not None
            _sigterm()

    h1 = fe.submit(_prompt(rng, 5), 10, on_token=cb)
    report = fe.run()
    trace.disable()
    h2, h3 = late["h2"], late["h3"]
    assert report["drained"]
    assert h1.status == "done"
    np.testing.assert_array_equal(_tokens(h1),
                                  _ref(pair, h1.request.prompt, 10))
    assert h2.status == "preempted" and not h2.tokens
    assert h3.status == "preempted" and not h3.tokens
    assert sorted(report["preempted"]) == sorted([h2.rid, h3.rid])
    assert eng.prefill_pending == 0
    assert eng.allocator.used_blocks == 0
    drains = trace.find_spans(trace.read_events(
        str(tmp_path / "trace.jsonl")), "serve.preempt_drain")
    assert len(drains) == 1
    attrs = drains[0]["attrs"]
    assert (attrs["queued"], attrs["in_flight"], attrs["preempted"]) \
        == (2, 1, 2)


def test_overlap_telemetry_names(model):
    metrics.enable()
    metrics.reset()
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng, overlap_prefill=True)
    rng = np.random.default_rng(7)
    for _ in range(3):
        fe.submit(_prompt(rng, 6), 6)
    fe.run()
    waits = metrics.histogram("serve_prefill_wait_ms")
    assert waits.count >= 1
    assert metrics.gauge("serve_prefill_queue").touched


# -- the chunked boundary (test_serving_chunked.py) ---------------------------

# prompt lengths straddle chunk boundaries at bs=16: 1, 2 and 3 chunks,
# one exactly block-aligned
_PROMPTS = (5, 16, 23, 40)


def _prompts(rng):
    return [_prompt(rng, n) for n in _PROMPTS]


def _serve_chunked(engine, prompts, n_new, temps, seeds, chunk_budget=1):
    fe = Frontend(engine, sched=ChunkedScheduler(chunk_budget=chunk_budget))
    hs = [fe.submit(p, n_new, temperature=t, seed=s)
          for p, t, s in zip(prompts, temps, seeds)]
    fe.run()
    assert all(h.status == "done" for h in hs)
    return hs


@pytest.mark.parametrize("block_size", (16, 64))
def test_chunked_identity_greedy_and_sampled(pair, model, block_size):
    eng = ServingEngine(model, slots=4, block_size=block_size, window=_W)
    prompts = _prompts(np.random.default_rng(0))
    temps, seeds = (0.0, 0.0, 0.9, 0.9), (0, 0, 3, 7)
    hs = _serve_chunked(eng, prompts, 10, temps, seeds)
    for h, p, t, s in zip(hs, prompts, temps, seeds):
        np.testing.assert_array_equal(
            _tokens(h), _ref(pair, p, 10, temperature=t, seed=s))
    assert eng.decode_compiles == 1
    assert eng.allocator.used_blocks == 0


def test_chunked_speculative(pair, model):
    draft = serving_gpt_pair(vocab=_VOCAB, d_model=32, layers=1, heads=4,
                             max_len=_W, seed=1)[1]
    eng = SpeculativeEngine(model, draft, slots=4, block_size=16,
                            window=_W, spec_k=3)
    prompts = _prompts(np.random.default_rng(0))
    temps, seeds = (0.0, 0.0, 0.9, 0.9), (0, 0, 3, 7)
    hs = _serve_chunked(eng, prompts, 10, temps, seeds)
    for h, p, t in zip(hs, prompts, temps):
        if t == 0.0:
            np.testing.assert_array_equal(_tokens(h), _ref(pair, p, 10))
        else:
            assert len(h.tokens) == 10
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1


def test_chunked_int8_matches_monolithic_int8(model):
    prompts = _prompts(np.random.default_rng(0))

    def serve(chunked):
        eng = ServingEngine(model, slots=4, block_size=16, window=_W,
                            kv_dtype="int8")
        fe = Frontend(eng, sched=(ChunkedScheduler(chunk_budget=1)
                                  if chunked else None))
        hs = [fe.submit(p, 10) for p in prompts]
        fe.run()
        assert all(h.status == "done" for h in hs)
        assert eng.decode_compiles == 1
        return [list(h.tokens) for h in hs]

    assert serve(chunked=False) == serve(chunked=True)


def test_chunked_prefix_warm(pair, model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        prefix_cache=True)
    rng = np.random.default_rng(2)
    shared = _prompt(rng, 32)

    def mk(n):
        return np.concatenate([shared, _prompt(rng, n)])

    _serve_chunked(eng, [mk(5), mk(9)], 8, (0.0, 0.9), (0, 5))
    p_warm = [mk(7), mk(11)]
    hs = _serve_chunked(eng, p_warm, 8, (0.0, 0.9), (0, 5))
    assert eng.prefix_stats["hits"] >= 2, eng.prefix_stats
    for h, p, t, s in zip(hs, p_warm, (0.0, 0.9), (0, 5)):
        np.testing.assert_array_equal(
            _tokens(h), _ref(pair, p, 8, temperature=t, seed=s))
    assert eng.decode_compiles == 1


def test_advance_protocol_and_write_safety(pair, model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    prompt = _prompt(np.random.default_rng(3), 40)
    req = Request(rid="r0", prompt=prompt, max_new=6)
    ticket, err = eng.begin_prefill_async([req], chunked=True)
    assert err is None and ticket is not None and ticket.work
    slot = ticket.work[0].items[0][0]
    n_chunks = sum(w.n_chunks for w in ticket.work)
    assert n_chunks == 3  # ceil(40/16)
    ran = 0
    while ticket.work:
        assert not ticket.ready()
        assert (np.asarray(eng.page_table[slot]) == 0).all()
        got = eng.advance_prefill(ticket, max_chunks=1)
        assert got == 1
        ran += got
    assert ran == n_chunks
    eng.finish_prefill(ticket)
    while eng.n_active:
        eng.step()
    np.testing.assert_array_equal(_tokens(req), _ref(pair, prompt, 6))
    assert eng.decode_compiles == 1


@pytest.mark.parametrize("mode", ["fifo", "overlap", "chunked"])
def test_greedy_streams_equal_the_reference_frontend(pair, mode):
    """The same greedy workload (more requests than slots, priorities
    and tenants cycled) through the port's and the reference's
    `Frontend` in each boundary mode: identical streams, in the same
    completion order."""
    ref_model, port = pair
    rng = np.random.default_rng(21)
    work = [(_prompt(rng, int(rng.integers(4, 40))),
             int(rng.integers(4, 12)), ("high", "normal", "background")[i % 3],
             f"t{i % 2}") for i in range(7)]
    out = []
    for eng_cls, fe_cls, sched_cls, m in (
            (ServingEngine, Frontend, ChunkedScheduler, port),
            (JaxEngine, JaxFrontend, JaxScheduler, ref_model)):
        eng = eng_cls(m, slots=3, block_size=16, window=_W)
        fe = fe_cls(eng, overlap_prefill=mode == "overlap",
                    sched=sched_cls(chunk_budget=1) if mode == "chunked"
                    else None)
        hs = [fe.submit(p, n, priority=pr, tenant=t)
              for p, n, pr, t in work]
        report = fe.run()
        assert all(h.status == "done" for h in hs)
        assert eng.decode_compiles == 1
        out.append(([list(h.tokens) for h in hs], report["completed"]))
    assert out[0] == out[1]


# -- the prefix-affine queue (test_serving_prefix_frontend.py) ----------------


def _first_token_order(model, prefix_cache):
    eng = ServingEngine(model, slots=1, block_size=16, window=_W,
                        prefix_cache=prefix_cache)
    fe = Frontend(eng)
    rng = np.random.default_rng(7)
    shared = _prompt(rng, 32)
    order = []

    def tracker(name):
        def cb(tok, done):
            if name not in order:
                order.append(name)
        return cb

    fe.submit(np.concatenate([shared, _prompt(rng, 4)]), 12,
              on_token=tracker("opener"))
    fe.pump()  # the opener admits (cold) and registers the shared blocks
    fe.submit(_prompt(rng, 12), 6, on_token=tracker("cold_a"))
    fe.submit(np.concatenate([shared, _prompt(rng, 5)]), 6,
              on_token=tracker("warm"))
    fe.submit(_prompt(rng, 10), 6, on_token=tracker("cold_b"))
    fe.run()
    assert eng.decode_compiles == 1
    return order, eng


def test_queue_admits_prefix_hits_before_cold_traffic(model):
    order, eng = _first_token_order(model, prefix_cache=True)
    assert order == ["opener", "warm", "cold_a", "cold_b"]
    assert eng.prefix_stats["hits"] == 1


def test_queue_order_untouched_when_cache_off(model):
    order, _ = _first_token_order(model, prefix_cache=False)
    assert order == ["opener", "cold_a", "warm", "cold_b"]


def test_overlap_prefill_composes_with_warm_admission(pair, model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        prefix_cache=True)
    fe = Frontend(eng, overlap_prefill=True)
    rng = np.random.default_rng(9)
    shared = _prompt(rng, 32)
    prompts = [np.concatenate([shared, _prompt(rng, 4 + 2 * i)])
               for i in range(4)]
    handles = [fe.submit(p, 8) for p in prompts]
    fe.run()
    for p, h in zip(prompts, handles):
        assert h.status == "done"
        np.testing.assert_array_equal(_tokens(h), _ref(pair, p, 8))
    assert eng.prefix_stats["hits"] >= 2, eng.prefix_stats
    assert eng.decode_compiles == 1
    assert eng.allocator.used_blocks == 0 and not eng.allocator._ref


# -- the serving telemetry (test_observability_serving.py) --------------------


def test_drain_span_counts_and_healthz_flip(model, tmp_path):
    """SIGTERM mid-serve: the serve.preempt_drain span's in-flight,
    queued and drain_tokens counts are the drain report's, and
    `healthz()` says "draining" while the streams in flight finish
    ("ok" before the signal). Its flip over HTTP is held in
    tests/test_torch_observability_export.py."""
    trace.enable(str(tmp_path / "trace.jsonl"))
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    assert fe.healthz()["status"] == "ok"
    rng = np.random.default_rng(0)
    fired = {"done": False}
    seen = []

    def cb(tok, done):
        if len(h1.tokens) == 3 and not fired["done"]:
            fired["done"] = True
            _sigterm()
        elif fired["done"] and fe.draining and not seen:
            seen.append(fe.healthz())

    h1 = fe.submit(_prompt(rng, 5), 12, on_token=cb)
    h2 = fe.submit(_prompt(rng, 7), 12, on_token=cb)
    h3 = fe.submit(_prompt(rng, 6), 12)  # stays queued (2 slots)
    report = fe.run()
    trace.disable()
    assert report["drained"] and report["preempted"] == [h3.rid]
    assert h1.status == "done" and h2.status == "done"
    assert seen and seen[0]["status"] == "draining"
    assert seen[0]["slots"] == 2 and seen[0]["queued"] == 0
    drains = trace.find_spans(trace.read_events(
        str(tmp_path / "trace.jsonl")), "serve.preempt_drain")
    assert len(drains) == 1
    attrs = drains[0]["attrs"]
    assert attrs["queued"] == len(report["preempted"]) == 1
    assert attrs["in_flight"] == 2
    assert attrs["drain_tokens"] == report["drain_tokens"] > 0
    assert attrs["preempted"] == 1


def test_serving_metrics_of_a_served_mix(model):
    """After serving with the hot path on, the registry carries queue
    depth, slot occupancy, KV utilisation and the token-latency
    histogram, read from post-eviction state (idle after a drained
    run)."""
    metrics.enable()
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    rng = np.random.default_rng(1)
    for r in range(4):
        fe.submit(_prompt(rng, 5 + 3 * r), 6 + r)
    fe.run()
    for name in ("serve_queue_depth", "serve_slot_occupancy",
                 "serve_kv_utilization", "serve_kv_blocks_used",
                 "serve_token_ms", "serve_tokens"):
        assert metrics.DEFAULT.get(name) is not None, name
    h = metrics.histogram("serve_token_ms")
    assert h.count == eng.steps and h.percentile(0.95) is not None
    for name in ("serve_slots_active", "serve_slot_occupancy",
                 "serve_kv_blocks_used", "serve_kv_utilization"):
        assert metrics.gauge(name).value == 0, name


def test_telemetry_adds_zero_rebuilds_plain(model):
    metrics.enable()
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng)
    rng = np.random.default_rng(2)
    for r in range(4):
        fe.submit(_prompt(rng, 4 + 5 * r), 5 + r)
    fe.run()
    assert eng.decode_compiles == 1
    assert metrics.counter("serve_steps").value == eng.steps


def test_speculative_acceptance_gauge_and_probes(model, tmp_path):
    metrics.enable()
    trace.enable(str(tmp_path / "trace.jsonl"))
    eng = SpeculativeEngine(model, model, spec_k=3, slots=2,
                            block_size=16, window=_W)
    fe = Frontend(eng)
    rng = np.random.default_rng(3)
    for r in range(3):
        fe.submit(_prompt(rng, 5 + 2 * r), 8)
    fe.run()
    trace.disable()
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1
    g = metrics.gauge("serve_acceptance_rate")
    assert g.value == pytest.approx(eng.acceptance_rate) == 1.0
    # tokens counted per emitted token (each stream's first comes from
    # prefill, outside the stepped count)
    assert metrics.counter("serve_tokens").value == 3 * (8 - 1)
