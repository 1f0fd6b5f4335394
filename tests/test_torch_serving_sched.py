"""The port's chunked-prefill scheduler (singa_tpu_torch.serving.sched)
against the reference's policy oracles (tests/test_serving_sched.py)
and against the reference's own `ChunkedScheduler`: on the same handle
lists, `order()` and the `commit()` accounting agree pick for pick.

The policy is host-only and pure (order() simulates on copies,
commit() replays), so most oracles run without a model; two ride the
port's engine on the CPU (the prefix sort's dirty flag, the metric
emissions).
"""

import numpy as np
import pytest

from singa_tpu.serving import ChunkedScheduler as JaxScheduler
from singa_tpu.serving.engine import Request as JaxRequest
from singa_tpu.serving.frontend import StreamHandle as JaxHandle
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.serving import ChunkedScheduler, Frontend, ServingEngine
from singa_tpu_torch.serving.engine import Request
from singa_tpu_torch.serving.frontend import StreamHandle
from singa_tpu_torch.serving.sched import LANES
from tests.helper_torch_parity import serving_gpt_pair

_VOCAB = 61
_W = 64


def _handle(rid, prompt_len=8, max_new=8, priority="normal",
            tenant=None, ref=False):
    req_cls, handle_cls = ((JaxRequest, JaxHandle) if ref
                           else (Request, StreamHandle))
    req = req_cls(rid=rid, prompt=np.zeros(prompt_len, np.int32),
                  max_new=max_new, priority=priority, tenant=tenant)
    return handle_cls(rid, req)


@pytest.fixture(scope="module")
def model():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)[1]


# -- construction -------------------------------------------------------------


def test_rejects_zero_chunk_budget():
    with pytest.raises(ValueError):
        ChunkedScheduler(chunk_budget=0)


def test_rejects_zero_lane_weight():
    with pytest.raises(ValueError):
        ChunkedScheduler(lane_weights=(4, 0))
    with pytest.raises(ValueError):
        ChunkedScheduler(lane_weights=(0, 1))


def test_unknown_priority_schedules_as_normal():
    s = ChunkedScheduler()
    assert s._lane(_handle(0, priority="frobnicate").request) == "normal"
    assert set(LANES) == {"high", "normal", "background"}


# -- priority lanes -----------------------------------------------------------


def test_high_strictly_before_normal():
    s = ChunkedScheduler()
    hs = [_handle(i, priority="normal") for i in range(3)]
    hs += [_handle(10 + i, priority="high") for i in range(3)]
    out = s.order(hs)
    assert [h.rid for h in out[:3]] == [10, 11, 12]
    assert [h.rid for h in out[3:]] == [0, 1, 2]


def test_background_starvation_bound_under_sustained_high():
    s = ChunkedScheduler(lane_weights=(4, 1))
    hs = [_handle(i, priority="high") for i in range(20)]
    hs += [_handle(100 + i, priority="background") for i in range(5)]
    out = s.order(hs)
    lanes = [s._lane(h.request) for h in out]
    window = sum(s.lane_weights)
    for i in range(0, 25 - window + 1):
        assert "background" in lanes[i:i + window], (
            f"background starved in window {i}: {lanes[i:i + window]}")
    assert lanes[:5].count("high") == 4 and lanes[4] == "background"


def test_background_only_queue_dispatches_freely():
    s = ChunkedScheduler()
    hs = [_handle(i, priority="background") for i in range(4)]
    assert [h.rid for h in s.order(hs)] == [0, 1, 2, 3]


# -- tenant fairness ----------------------------------------------------------


def test_tenant_deficit_round_robin_under_skewed_arrival():
    cost = 8 + 8  # prompt + max_new
    hs = [_handle(i, tenant="a") for i in range(8)]
    hs += [_handle(100 + i, tenant="b") for i in range(2)]
    out = ChunkedScheduler().order(hs)
    served = {"a": 0, "b": 0}
    for k, h in enumerate(out):
        served[h.request.tenant] += cost
        if k < 4:
            assert abs(served["a"] - served["b"]) <= cost, (k, served)
    assert {h.rid for h in out[:4]} >= {100, 101}


def test_served_ratio_bounded_with_unequal_costs():
    hs = [_handle(i, prompt_len=24, max_new=24, tenant="a")
          for i in range(3)]
    hs += [_handle(100 + i, prompt_len=4, max_new=8, tenant="b")
           for i in range(6)]
    out = ChunkedScheduler().order(hs)
    first_a = next(k for k, h in enumerate(out)
                   if h.request.tenant == "a")
    nxt = [h.request.tenant for h in out[first_a + 1:first_a + 5]]
    assert nxt == ["b", "b", "b", "b"], nxt


def test_none_tenants_share_one_account():
    s = ChunkedScheduler()
    hs = [_handle(i) for i in range(3)]
    s.order(hs)
    assert s.tenant_deficit() == 0  # pure: real state untouched
    for h in hs:
        s.commit(h)
    assert s.tenant_deficit() == 0


# -- order/commit replay, and agreement with the reference --------------------


def test_order_is_pure_and_commit_replays_exactly():
    hs = [_handle(i, priority=p, tenant=t)
          for i, (p, t) in enumerate(
              [("high", "a"), ("normal", "b"), ("background", "a"),
               ("normal", "a"), ("high", "b"), ("background", "b")])]
    s = ChunkedScheduler()
    first = [h.rid for h in s.order(hs)]
    assert [h.rid for h in s.order(hs)] == first
    by_rid = {h.rid: h for h in hs}
    for rid in first[:2]:
        s.commit(by_rid[rid])
    rest = [h for h in hs if h.rid not in first[:2]]
    assert [h.rid for h in s.order(rest)] == first[2:]


def test_lane_picks_account_every_commit():
    s = ChunkedScheduler()
    for h in [_handle(0, priority="high"), _handle(1),
              _handle(2, priority="background"), _handle(3)]:
        s.commit(h)
    assert s.lane_picks == {"high": 1, "normal": 2, "background": 1}


@pytest.mark.parametrize("seed", range(6))
def test_order_and_commit_equal_the_reference(seed):
    """Random queues of mixed lanes, tenants and costs: the port's and
    the reference's schedulers dispatch in the same order, and after
    committing the same prefixes hold the same lane picks, deficits and
    re-orders of the remainder, over three dispatch waves."""
    rng = np.random.default_rng(seed)
    spec = [(i, int(rng.integers(2, 40)), int(rng.integers(1, 30)),
             str(rng.choice(list(LANES) + ["other"])),
             rng.choice(["a", "b", "c", None]))
            for i in range(int(rng.integers(6, 20)))]
    weights = (int(rng.integers(1, 6)), int(rng.integers(1, 3)))
    queues, scheds = [], []
    for ref in (False, True):
        queues.append([_handle(i, n, m, p, t, ref=ref)
                       for i, n, m, p, t in spec])
        scheds.append((JaxScheduler if ref else ChunkedScheduler)(
            lane_weights=weights))
    for _ in range(3):
        orders = [s.order(q) for s, q in zip(scheds, queues)]
        assert [h.rid for h in orders[0]] == [h.rid for h in orders[1]]
        take = int(rng.integers(1, 4))
        for s, order, q in zip(scheds, orders, queues):
            for h in order[:take]:
                s.commit(h)
                q.remove(h)
        assert scheds[0].lane_picks == scheds[1].lane_picks
        assert scheds[0].tenant_deficit() == scheds[1].tenant_deficit()
        assert scheds[0]._served == scheds[1]._served


# -- engine-backed: the prefix sort's dirty flag, the metrics -----------------


def test_prefix_sort_runs_per_dirty_event_not_per_turn(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        prefix_cache=True)
    fe = Frontend(eng)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, _VOCAB, size=16).astype(np.int32)
    handles = []
    for _ in range(4):
        sfx = rng.integers(0, _VOCAB, size=4).astype(np.int32)
        handles.append(fe.submit(np.concatenate([shared, sfx]), 12))
    fe.run()
    assert all(h.status == "done" for h in handles)
    assert eng.tokens_emitted >= 12 * 2
    assert 1 <= fe._prefix_sorts <= 3, fe._prefix_sorts


def test_sched_metrics_emitted(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    fe = Frontend(eng, sched=ChunkedScheduler(chunk_budget=1))
    rng = np.random.default_rng(1)
    obs_metrics.reset()
    obs_metrics.enable()
    try:
        hs = [fe.submit(rng.integers(0, _VOCAB, size=n).astype(np.int32),
                        8, priority=p, tenant=t)
              for n, p, t in [(6, "high", "a"), (20, "normal", "b"),
                              (33, "background", "a")]]
        fe.run()
        assert all(h.status == "done" for h in hs)
        snap = obs_metrics.snapshot()
        # chunk arithmetic: ceil(6/16) + ceil(20/16) + ceil(33/16)
        assert snap["serve_prefill_chunks"] == 1 + 2 + 3, snap
        assert snap["serve_sched_lane_picks"] == 3, snap
        assert obs_metrics.gauge("serve_tenant_deficit").value >= 0
        hist = obs_metrics.histogram("serve_decode_stall_ms")
        assert hist.count > 0
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    assert fe.sched.lane_picks == {"high": 1, "normal": 1,
                                   "background": 1}
