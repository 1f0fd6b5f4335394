"""Prefix cache and asynchronous prefill of the port's serving engine.

Mirrors tests/test_serving_prefix.py (the allocator and `PrefixIndex`
cases run against the port's copy of blocks.py; warm and cold streams
against the port's solo `generate`), and the cases of
tests/test_serving_overlap.py that need no Frontend: the prefill
ticket's lifecycle (`begin_prefill_async` / `advance_prefill` /
`finish_prefill` / `abort_prefill`), a refusal returned at zero free
blocks, and a cancel racing the in-flight prefill.
"""

import numpy as np
import pytest

from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.observability import trace as obs_trace
from singa_tpu_torch.serving import (
    BlockAllocator, OutOfBlocksError, Request, ServingEngine)
from singa_tpu_torch.serving.blocks import PrefixIndex
from tests.helper_torch_parity import serving_gpt_pair

_VOCAB = 61
_W = 64


@pytest.fixture(scope="module")
def model():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)[1]


def _prompt(rng, n):
    return rng.integers(0, _VOCAB, size=n).astype(np.int32)


def _ref(model, prompt, n_new, temperature=0.0, seed=0, window=_W):
    out = model.generate(prompt, n_new=n_new, window=window,
                         temperature=temperature, seed=seed)
    return out[0, len(prompt):]


def _same(req, model, window=_W):
    np.testing.assert_array_equal(
        np.asarray(req.tokens, np.int32),
        _ref(model, req.prompt, req.max_new, req.temperature, req.seed,
             window), err_msg=f"request {req.rid} diverged from generate")


# -- allocator and index (the port's copy of blocks.py) -----------------------


def test_allocator_refcount_share_and_lru_reclaim():
    a = BlockAllocator(num_blocks=5, block_size=16)  # capacity 4
    g1 = a.alloc("r1", 2)
    for b in g1:
        a.mark_registered(b)
    a.free("r1")
    assert a.cached_blocks == 2 and a.used_blocks == 0
    assert a.available_blocks == 4
    g2 = a.alloc("r2", 1, shared=g1)
    assert g2 and a.cached_blocks == 0
    assert all(a.refcount(b) == 1 for b in g1)
    g3 = a.alloc("r3", 0, shared=g1)
    assert g3 == [] and all(a.refcount(b) == 2 for b in g1)
    assert a.shared_pages == 2
    a.free("r2")
    assert all(a.refcount(b) == 1 for b in g1) and a.cached_blocks == 0
    a.free("r3")
    assert a.cached_blocks == 2 and not a._ref
    reclaimed = []
    a.on_reclaim = reclaimed.append
    g4 = a.alloc("r4", 4)
    assert len(g4) == 4 and sorted(reclaimed) == sorted(g1)
    assert a.cached_blocks == 0 and a.available_blocks == 0


def test_allocator_refusals_and_cow():
    a = BlockAllocator(num_blocks=3, block_size=16)  # capacity 2
    g1 = a.alloc("r1", 2)
    for b in g1:
        a.mark_registered(b)
    a.free("r1")
    with pytest.raises(OutOfBlocksError, match="needs 1 blocks"):
        a.alloc("r2", 1, shared=g1)   # sharing both leaves nothing
    assert a.cached_blocks == 2 and not a._ref
    a = BlockAllocator(num_blocks=5, block_size=16)
    g1 = a.alloc("r1", 2)
    for b in g1:
        a.mark_registered(b)
    a.free("r1")
    a.alloc("r2", 2)
    with pytest.raises(OutOfBlocksError,
                       match="prefix cache: 2 reclaimable cached blocks"):
        a.alloc("r3", 3)
    a = BlockAllocator(num_blocks=4, block_size=16)  # cache off: LIFO
    g1 = a.alloc("r1", 3)
    a.free("r1")
    assert a.alloc("r2", 3) == list(reversed(g1))
    with pytest.raises(OutOfBlocksError) as ei:
        a.alloc("r3", 1)
    assert "prefix cache" not in str(ei.value)
    a = BlockAllocator(num_blocks=3, block_size=16)
    (b0,) = a.alloc("r1", 1)
    a.mark_registered(b0)
    a.alloc("r2", 0, shared=[b0])
    new = a.cow("r2", b0)
    assert new != b0 and a.refcount(b0) == 1 and a.refcount(new) == 1
    assert a._owned["r2"] == [new] and a._owned["r1"] == [b0]
    with pytest.raises(ValueError, match="does not hold"):
        a.cow("r2", b0)


def test_prefix_index_chain_lookup_register_purge():
    idx = PrefixIndex("gpt:test", block_size=4)
    toks = np.arange(11, dtype=np.int32)
    chain = idx.chain_keys(toks)
    assert len(chain) == 2
    assert idx.lookup(chain) == []
    assert idx.register(*chain[0], block=5)
    assert idx.register(*chain[1], block=7)
    assert idx.lookup(chain) == [5, 7]
    assert not idx.register(*chain[0], block=9)
    other = idx.chain_keys(np.arange(100, 104, dtype=np.int32))
    assert not idx.register(*other[0], block=5)
    idx.purge_block(5)
    assert idx.lookup(chain) == [] and idx.block_of(chain[1][0]) == 7
    t2 = toks.copy()
    t2[1] += 1
    assert idx.chain_keys(t2)[1][0] != chain[1][0]
    assert PrefixIndex("gpt:b", 4).chain_keys(toks)[0][0] != chain[0][0]


# -- warm vs cold identity ----------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_warm_streams_match_generate(model, temperature):
    """Three streams share a two-block prefix, staggered with a cold
    stream and a mid-run cancel: every survivor equals its solo
    generate, and the warm admissions hit."""
    eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                        prefix_cache=True)
    rng = np.random.default_rng(7)
    shared = _prompt(rng, 32)
    reqs = {f"s{i}": Request(f"s{i}", np.concatenate(
        [shared, _prompt(rng, 3 + 2 * i)]), 10, temperature=temperature,
        seed=3) for i in range(3)}
    cold = Request("cold", _prompt(rng, 12), 10, temperature=temperature,
                   seed=3)
    eng.admit(reqs["s0"])
    eng.admit(cold)
    for _ in range(3):
        eng.step()
    eng.cancel("cold")
    eng.admit(reqs["s1"])
    for _ in range(2):
        eng.step()
    eng.admit(reqs["s2"])
    while eng.n_active:
        eng.step()
    for req in reqs.values():
        _same(req, model)
    assert [reqs[k].cached_tokens for k in ("s0", "s1", "s2")] == [0, 32, 32]
    st = eng.prefix_stats
    assert st["hits"] == 2 and st["misses"] == 2, st
    assert eng.decode_compiles == 1 and eng.prefix_prefill_compiles == 1


def test_warm_admission_runs_suffix_only(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        prefix_cache=True)
    calls = {"full": 0, "suffix": 0}
    for name in ("full", "suffix"):
        orig = getattr(eng, f"_dispatch_{name}_chunk")

        def spy(items, name=name, orig=orig):
            calls[name] += 1
            return orig(items)

        setattr(eng, f"_dispatch_{name}_chunk", spy)
    rng = np.random.default_rng(9)
    shared = _prompt(rng, 32)
    r1 = Request("r1", np.concatenate([shared, _prompt(rng, 5)]), 4)
    eng.admit(r1)
    assert calls == {"full": 1, "suffix": 0}
    r2 = Request("r2", np.concatenate([shared, _prompt(rng, 5)]), 4)
    eng.admit(r2)
    assert calls == {"full": 1, "suffix": 1} and r2.cached_tokens == 32
    while eng.n_active:
        eng.step()
    for r in (r1, r2):
        _same(r, model)


def test_block_64_sharing_and_the_private_tail_block():
    """block_size 64 over a 128 window shares one full block; a prompt
    ending exactly on a block boundary keeps its last block private."""
    m = serving_gpt_pair(vocab=_VOCAB, max_len=128)[1]
    eng = ServingEngine(m, slots=2, block_size=64, window=128,
                        prefix_cache=True)
    rng = np.random.default_rng(5)
    shared = _prompt(rng, 64)
    r1 = Request("r1", np.concatenate([shared, _prompt(rng, 4)]), 8)
    r2 = Request("r2", np.concatenate([shared, _prompt(rng, 9)]), 8)
    eng.admit(r1)
    eng.admit(r2)
    while eng.n_active:
        eng.step()
    assert r1.cached_tokens == 0 and r2.cached_tokens == 64
    for r in (r1, r2):
        _same(r, m, window=128)
    eng2 = ServingEngine(m, slots=2, block_size=16, window=128,
                         prefix_cache=True)
    p = _prompt(rng, 32)  # exactly 2 blocks
    r3, r4 = Request("r3", p, 6), Request("r4", p.copy(), 6)
    eng2.admit(r3)
    s4 = eng2.admit(r4)
    assert r4.cached_tokens == 16  # block 1 (holding t0-1) stays private
    assert eng2.allocator.refcount(int(eng2.page_table[s4][1])) == 1
    while eng2.n_active:
        eng2.step()
    for r in (r3, r4):
        _same(r, m, window=128)


def test_churn_drains_to_zero_refcounts(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        num_blocks=7, prefix_cache=True)
    rng = np.random.default_rng(21)
    shared = _prompt(rng, 32)
    for wave in range(3):
        for r in (Request(f"w{wave}a", np.concatenate(
                [shared, _prompt(rng, 3 + wave)]), 8),
                  Request(f"w{wave}b", _prompt(rng, 10 + wave), 8)):
            eng.admit(r)
        while eng.n_active:
            eng.step()
    a = eng.allocator
    assert a.used_blocks == 0 and a.shared_pages == 0 and not a._ref
    assert len(a._free) + a.cached_blocks == a.capacity
    assert eng.prefix_stats["hits"] >= 2 and eng.decode_compiles == 1


def test_cow_fork_write_is_never_observed_by_the_sharing_stream(model):
    """Manufacture the fork the guard defends against: two identical
    prompts share the partial tail block itself. The first decode write
    lands on a refcount-2 block; the guard copies it out first, and both
    streams still match their solo generate."""
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        prefix_cache=True)
    rng = np.random.default_rng(17)
    p = _prompt(rng, 40)
    r1, r2 = Request("r1", p, 8), Request("r2", p.copy(), 8)
    s1 = eng.admit(r1)
    s2 = eng.admit(r2)
    assert r2.cached_tokens == 32
    alloc = eng.allocator
    b1 = int(eng.page_table[s1][2])
    b2 = int(eng.page_table[s2][2])
    held2 = alloc._owned[s2]
    held2[held2.index(b2)] = b1
    alloc._ref[b1] += 1
    alloc._decref(b2)
    eng.page_table[s2][2] = b1
    assert alloc.refcount(b1) == 2 and alloc.shared_pages == 3
    while eng.n_active:
        eng.step()
    assert eng.prefix_stats["cow_copies"] == 1
    for r in (r1, r2):
        _same(r, model)
    assert alloc.used_blocks == 0 and not alloc._ref


def test_decoded_blocks_register_and_hit_on_the_next_turn(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                        prefix_cache=True)
    rng = np.random.default_rng(23)
    p1 = _prompt(rng, 20)
    r1 = Request("r1", p1, 30)
    eng.admit(r1)
    while eng.n_active:
        eng.step()
    turn2 = np.concatenate([p1, np.asarray(r1.tokens, np.int32),
                            _prompt(rng, 3)])
    r2 = Request("r2", turn2, 6)
    eng.admit(r2)
    assert r2.cached_tokens == 48
    while eng.n_active:
        eng.step()
    _same(r2, model)
    assert eng.prefix_stats["hits"] == 1


def test_prefix_metrics_counters_and_gauges(model):
    obs_metrics.reset()
    obs_metrics.enable()
    try:
        eng = ServingEngine(model, slots=2, block_size=16, window=_W,
                            prefix_cache=True)
        rng = np.random.default_rng(29)
        shared = _prompt(rng, 32)
        eng.admit(Request("r1", np.concatenate([shared, _prompt(rng, 4)]),
                          4))
        eng.admit(Request("r2", np.concatenate([shared, _prompt(rng, 6)]),
                          4))
        assert obs_metrics.counter("serve_prefix_hits").value == 1
        assert obs_metrics.counter("serve_prefix_misses").value == 1
        assert obs_metrics.gauge("serve_shared_pages").value == 2.0
        assert obs_metrics.gauge("serve_prefix_hit_rate").value == 0.5
        while eng.n_active:
            eng.step()
        assert obs_metrics.histogram("serve_token_ms").count == 3
        assert obs_metrics.counter("serve_tokens").value == 6
        assert obs_metrics.gauge("serve_kv_utilization").value == 0.0
    finally:
        obs_metrics.disable()
        obs_metrics.reset()


def test_prefix_cache_off_emits_nothing(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    assert not eng.prefix_cache and eng.prefix_prefill_compiles == 0
    r = Request("r", _prompt(np.random.default_rng(31), 8), 4)
    assert eng.prefix_match_tokens(r) == 0
    eng.admit(r)
    assert r.cached_tokens == 0
    while eng.n_active:
        eng.step()
    _same(r, model)


# -- asynchronous prefill -----------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True])
def test_ticket_lifecycle_with_evictions_mid_window(model, chunked,
                                                    tmp_path):
    """A ticket dispatched (or staged, chunked) while decode runs: the
    reserved slot stays trash-paged and inactive until finish, an
    eviction mid-window frees other blocks, and every stream matches
    generate; one `serve.prefill` span per dispatched chunk (a staged
    chunked ticket dispatches none)."""
    obs_trace.enable(str(tmp_path / "trace.jsonl"))
    try:
        eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                            num_blocks=10)
        rng = np.random.default_rng(3)
        a = Request("a", _prompt(rng, 5), 10)
        b = Request("b", _prompt(rng, 8), 10)
        c = Request("c", _prompt(rng, 40), 8)
        eng.admit(a)
        eng.admit(b)
        eng.step()
        ticket, err = eng.begin_prefill_async([c], chunked=chunked)
        assert err is None and eng.prefill_pending == 1
        slot = next(s for s, r in enumerate(eng._reqs) if r is c)
        assert not eng.page_table[slot].any() and not eng.active[slot]
        if chunked:
            assert not ticket.ready()
            assert eng.advance_prefill(ticket) == 1 and not ticket.ready()
            assert eng.advance_prefill(ticket, max_chunks=5) == 2
        assert ticket.ready() and ticket.requests == [c]
        eng.cancel("a")
        eng.step()
        assert eng.finish_prefill(ticket) == [slot]
        assert eng.prefill_pending == 0 and len(c.tokens) == 1
        while eng.n_active:
            eng.step()
        for r in (b, c):
            _same(r, model)
        assert eng.decode_compiles == 1
    finally:
        obs_trace.disable()
    spans = obs_trace.find_spans(
        obs_trace.read_events(str(tmp_path / "trace.jsonl")),
        "serve.prefill")
    assert [sp["attrs"]["batch"] for sp in spans] == [1] * (2 + (not chunked))
    assert eng.prefix_prefill_compiles == (1 if chunked else 0)


def test_zero_free_blocks_returns_the_refusal(model):
    eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                        num_blocks=5)
    rng = np.random.default_rng(4)
    eng.admit_many([Request("a", _prompt(rng, 18), 8),
                    Request("b", _prompt(rng, 20), 10)])
    assert eng.allocator.free_blocks == 0
    ticket, err = eng.begin_prefill_async(
        [Request("c", _prompt(rng, 9), 8)])
    assert ticket is None and isinstance(err, OutOfBlocksError)


def test_cancel_mid_prefill_defers_eviction_and_abort_unstarts(model):
    eng = ServingEngine(model, slots=2, block_size=16, window=_W)
    rng = np.random.default_rng(5)
    h = Request("h", _prompt(rng, 6), 8)
    ticket, _ = eng.begin_prefill_async([h])
    used = eng.allocator.used_blocks
    assert used > 0 and eng.cancel("h")
    assert eng.allocator.used_blocks == used  # deferred to finish
    eng.finish_prefill(ticket)
    assert eng.allocator.used_blocks == 0 and eng.n_active == 0
    assert not h.tokens
    r = Request("r", _prompt(rng, 7), 8)
    ticket, _ = eng.begin_prefill_async([r], chunked=True)
    assert eng.abort_prefill(ticket) == [r]
    assert eng.prefill_pending == 0 and eng.allocator.used_blocks == 0
    assert eng.free_slots == 2 and not r.tokens
