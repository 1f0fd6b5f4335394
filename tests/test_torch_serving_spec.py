"""The port's speculative engine (singa_tpu_torch.serving.speculative)
against the reference (singa_tpu), the oracles of
tests/test_serving_spec.py and the speculative cases of
test_serving_int8.py and the prefix suites.

A small random GPT (vocab 61, d 48, 2 scanned blocks, window 64) and a
draft (d 32, 4 heads, 1 block) carry the same seeded weights in both
packages:

- every GREEDY speculative stream equals the reference's
  `generate(use_cache=True)` bit for bit (and the port's), under
  staggered admits/evicts, fragmented tables, an eviction between
  rounds, a same-model draft (every proposal accepted) and a hostile
  draft (almost none), with one propose and one verify build;
- int8 pools, and a warm prefix whose draft rows come from the draft's
  own suffix chunks;
- sampled streams (the port's noise is its own, so they are not
  compared across packages): deterministic per seed, complete, and
  independent of their batch; `_accept` alone preserves the target's
  distribution (a chi-square bound over a vocab of 8);
- `pool_bytes=` charges both caches, with the reference's block count;
  the refusals carry the reference's messages.
"""

import time

import numpy as np
import pytest
import torch

from singa_tpu.serving import SpeculativeEngine as JaxSpeculativeEngine
from singa_tpu_torch.models.gpt import GPT, gpt_draft
from singa_tpu_torch.resilience import counters
from singa_tpu_torch.serving import (
    Request, ServingEngine, SpeculativeEngine, kv_block_bytes)
from singa_tpu_torch.serving.speculative import _accept
from tests.helper_torch_parity import serving_gpt_pair

_VOCAB = 61
_W = 64


@pytest.fixture(scope="module")
def pair():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def draft_pair():
    # an untrained, differently seeded draft: acceptance ~0, so the
    # identity oracles run almost entirely through the correction token
    return serving_gpt_pair(vocab=_VOCAB, d_model=32, layers=1, heads=4,
                            max_len=_W, seed=3)


@pytest.fixture(scope="module")
def draft(draft_pair):
    return draft_pair[1]


_GENERATED = {}


def _ref(pair, prompt, n_new):
    """The oracle: the REFERENCE's solo greedy `generate`, generated
    suffix (memoized: each prompt shape compiles once), held against
    the port's own `generate` too."""
    key = (np.asarray(prompt, np.int32).tobytes(), n_new)
    if key not in _GENERATED:
        ref_model, port = pair
        want = ref_model.generate(prompt, n_new=n_new,
                                  window=_W)[0, len(prompt):]
        np.testing.assert_array_equal(
            port.generate(prompt, n_new, window=_W)[0, len(prompt):],
            want)
        _GENERATED[key] = np.asarray(want, np.int32)
    return _GENERATED[key]


def _prompt(rng, n):
    return rng.integers(0, _VOCAB, size=n).astype(np.int32)


def _tokens(req):
    return np.asarray(req.tokens, np.int32)


# -- the round-15 matrix, speculatively ---------------------------------------


@pytest.mark.parametrize("block_size", [16, 64])
def test_spec_identity_under_staggered_admit_evict(pair, model, draft,
                                                   block_size):
    rng = np.random.default_rng(7)
    eng = SpeculativeEngine(model, draft, spec_k=3, slots=4,
                            block_size=block_size, window=_W)
    reqs = {
        "a": Request("a", _prompt(rng, 5), 20),
        "b": Request("b", _prompt(rng, 30), 16),
        "c": Request("c", _prompt(rng, 37), 20),
        "d": Request("d", _prompt(rng, 12), 8),
        "e": Request("e", _prompt(rng, 22), 10),
    }
    eng.admit(reqs["a"])
    eng.admit(reqs["b"])
    for _ in range(3):
        eng.step()
    eng.admit(reqs["c"])            # admitted mid-flight
    for _ in range(2):
        eng.step()
    eng.cancel("b")                 # evict mid-flight: blocks fragment
    eng.admit(reqs["d"])            # reuses b's freed blocks
    eng.admit(reqs["e"])
    while eng.n_active:
        eng.step()
    for rid, req in reqs.items():
        want = _ref(pair, req.prompt, req.max_new)
        got = _tokens(req)
        if rid == "b":
            np.testing.assert_array_equal(got, want[:got.size])
        else:
            np.testing.assert_array_equal(
                got, want, err_msg=f"request {rid} diverged from generate")
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1
    assert eng.allocator.used_blocks == 0


def test_fragmented_page_table_spec(pair, model, draft):
    rng = np.random.default_rng(3)
    eng = SpeculativeEngine(model, draft, spec_k=3, slots=3,
                            block_size=16, window=_W, num_blocks=7)
    a = Request("a", _prompt(rng, 5), 20)
    b = Request("b", _prompt(rng, 20), 20)
    eng.admit(a)
    eng.admit(b)
    for _ in range(2):
        eng.step()
    eng.cancel("a")
    c = Request("c", _prompt(rng, 30), 4)
    eng.admit(c)
    row = eng.page_table[[s for s, r in enumerate(eng._reqs)
                          if r is c][0]]
    used = row[row > 0]
    assert not np.array_equal(used, np.sort(used)) or \
        (used.max() - used.min() >= len(used)), (
            f"page table row {row} is contiguous")
    while eng.n_active:
        eng.step()
    np.testing.assert_array_equal(_tokens(c), _ref(pair, c.prompt, 4))
    np.testing.assert_array_equal(_tokens(b), _ref(pair, b.prompt, 20))


def test_evict_mid_speculation(pair, model, draft):
    """An eviction between rounds frees the slot's blocks; the
    survivors stay exact and the freed blocks' stale target and draft
    rows never leak into the next occupant."""
    rng = np.random.default_rng(11)
    eng = SpeculativeEngine(model, draft, spec_k=3, slots=3,
                            block_size=16, window=_W, num_blocks=8)
    a = Request("a", _prompt(rng, 20), 18)   # 3 blocks
    b = Request("b", _prompt(rng, 9), 18)    # 2 blocks
    eng.admit(a)
    eng.admit(b)
    eng.step()
    free_before = eng.allocator.free_blocks
    eng.cancel("a")
    assert eng.allocator.free_blocks == free_before + 3
    c = Request("c", _prompt(rng, 30), 10)   # re-admits into a's blocks
    eng.admit(c)
    while eng.n_active:
        eng.step()
    np.testing.assert_array_equal(_tokens(b), _ref(pair, b.prompt, 18))
    np.testing.assert_array_equal(_tokens(c), _ref(pair, c.prompt, 10))
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1


# -- the ends of the acceptance spectrum --------------------------------------


def test_same_model_draft_full_acceptance(pair, model):
    """The target as its own draft accepts every proposal (exactly 1.0
    on the CPU), emitting K+1 tokens a round, token-identically."""
    rng = np.random.default_rng(5)
    eng = SpeculativeEngine(model, model, spec_k=4, slots=2,
                            block_size=16, window=_W)
    reqs = [Request(i, _prompt(rng, 5 + 9 * i), 16) for i in range(2)]
    for r in reqs:
        eng.admit(r)
    while eng.n_active:
        eng.step()
    assert eng.acceptance_rate == 1.0, eng.acceptance_rate
    # 1 prefill token + ceil(15 / (K+1)) rounds, not 15
    assert eng.spec_rounds <= 4, eng.spec_rounds
    for r in reqs:
        np.testing.assert_array_equal(_tokens(r), _ref(pair, r.prompt, 16))


def test_hostile_draft_still_token_identical(pair, model, draft):
    counters.reset()
    rng = np.random.default_rng(13)
    eng = SpeculativeEngine(model, draft, spec_k=3, slots=1,
                            block_size=16, window=_W)
    r = Request("h", _prompt(rng, 8), 12)
    eng.admit(r)
    while eng.n_active:
        eng.step()
    np.testing.assert_array_equal(_tokens(r), _ref(pair, r.prompt, 12))
    snap = counters.snapshot()
    assert snap.get("spec_accepts", 0) + snap.get("spec_rejects", 0) \
        == eng.spec_rounds * eng.spec_k
    assert snap.get("spec_rejects", 0) > 0
    assert eng.spec_rounds <= 11, eng.spec_rounds
    assert counters.supervisor_snapshot()["spec_rejects"] \
        == snap["spec_rejects"]


# -- storage formats and the prefix cache -------------------------------------


def test_int8_pools_speculative(pair, model):
    """int8 pools under a self-draft: the reference's bound (acceptance
    > 0.5, >= 80% of tokens equal to generate, exact length, 1 + 1
    builds), and the streams equal the port's plain int8 engine's (both
    paths quantize and read the same rows)."""
    def serve(spec):
        rng = np.random.default_rng(9)
        kw = dict(slots=2, block_size=16, window=_W, kv_dtype="int8")
        eng = (SpeculativeEngine(model, model, spec_k=3, **kw) if spec
               else ServingEngine(model, **kw))
        reqs = [Request(i, _prompt(rng, 6 + 10 * i), 14)
                for i in range(2)]
        for r in reqs:
            eng.admit(r)
        while eng.n_active:
            eng.step()
        return eng, reqs

    eng, reqs = serve(True)
    _, plain = serve(False)
    assert eng.acceptance_rate > 0.5, eng.acceptance_rate
    for r, p in zip(reqs, plain):
        assert len(r.tokens) == 14
        rate = np.mean(_tokens(r) == _ref(pair, r.prompt, 14))
        assert rate >= 0.8, rate
        assert r.tokens == p.tokens
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1


def test_warm_prefix_fills_the_draft_cache_by_suffix(pair, model):
    """A speculative engine with the prefix cache: wave 2 maps wave 1's
    shared blocks and prefills only the suffix, for the target AND the
    draft (the draft's headless suffix chunks). A self-draft accepts
    every proposal only if those draft rows are right."""
    eng = SpeculativeEngine(model, model, spec_k=3, slots=2,
                            block_size=16, window=_W, prefix_cache=True)
    assert eng._prefix_fingerprint().endswith(":draft(d48:h4:L2:k3)")
    rng = np.random.default_rng(2)
    shared = _prompt(rng, 32)
    waves = [[np.concatenate([shared, _prompt(rng, n)]) for n in ns]
             for ns in ((5, 9), (7, 11))]
    for wave in waves:
        reqs = [Request(i, p, 10) for i, p in enumerate(wave)]
        eng.admit_many(reqs)
        while eng.n_active:
            eng.step()
        for r in reqs:
            np.testing.assert_array_equal(_tokens(r),
                                          _ref(pair, r.prompt, 10))
    assert eng.prefix_stats["hits"] >= 2, eng.prefix_stats
    assert eng.prefix_prefill_compiles == 1
    assert eng.acceptance_rate == 1.0, eng.acceptance_rate
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1
    assert eng.allocator.used_blocks == 0


def test_prefix_fingerprint_separates_speculative_blocks(model, draft):
    """A block's draft rows are part of its content: a plain engine and
    speculative engines with other drafts or depths never share a
    fingerprint."""
    kw = dict(slots=1, block_size=16, window=_W, prefix_cache=True)
    prints = {ServingEngine(model, **kw)._prefix_fingerprint(),
              SpeculativeEngine(model, draft, spec_k=3,
                                **kw)._prefix_fingerprint(),
              SpeculativeEngine(model, draft, spec_k=2,
                                **kw)._prefix_fingerprint(),
              SpeculativeEngine(model, model, spec_k=3,
                                **kw)._prefix_fingerprint()}
    assert len(prints) == 4


# -- sampled streams ----------------------------------------------------------


def test_sampled_spec_deterministic_and_complete(pair, model):
    rng = np.random.default_rng(17)
    p = _prompt(rng, 9)
    pg = _prompt(rng, 15)

    def run():
        eng = SpeculativeEngine(model, model, spec_k=3, slots=2,
                                block_size=16, window=_W)
        rs = Request("s", p.copy(), 14, temperature=0.8, seed=5)
        rg = Request("g", pg.copy(), 14)
        eng.admit_many([rs, rg])
        while eng.n_active:
            eng.step()
        return rs.tokens, rg.tokens

    s1, g1 = run()
    s2, g2 = run()
    assert s1 == s2 and len(s1) == 14
    assert all(0 <= t < _VOCAB for t in s1)
    np.testing.assert_array_equal(np.asarray(g1, np.int32),
                                  _ref(pair, pg, 14))
    assert g1 == g2


def test_sampled_stream_does_not_depend_on_its_batch(model, draft):
    """Every speculative draw is keyed on (seed, domain, position): a
    sampled stream served alone equals the same request served in
    another slot beside other streams."""
    rng = np.random.default_rng(19)
    p = _prompt(rng, 12)
    others = [_prompt(rng, n) for n in (7, 20, 30)]

    def serve(crowd):
        eng = SpeculativeEngine(model, draft, spec_k=3, slots=4,
                                block_size=16, window=_W)
        reqs = [Request(f"o{i}", q, 12, temperature=0.9, seed=40 + i)
                for i, q in enumerate(others[:crowd])]
        target = Request("t", p.copy(), 16, temperature=0.8, seed=3)
        eng.admit_many(reqs + [target])
        while eng.n_active:
            eng.step()
        return target.tokens

    assert serve(0) == serve(3)


def test_accept_preserves_the_target_distribution():
    """`_accept` alone, over a vocab of 8: 6,000 rows (one seed each)
    share one target and one draft distribution; proposals are drawn
    from the draft's q. Residual rejection makes the first emitted
    token a sample of softmax(p / T): its frequencies pass a chi-square
    test at 7 degrees of freedom below 24.32 (p = 0.001; the draws are
    a fixed function of the seeds, so the test is deterministic)."""
    n, V, K, T = 6000, 8, 2, 0.8
    gen = np.random.default_rng(0)
    lp = gen.standard_normal((K + 1, V)).astype(np.float32) * 2.0
    lq = gen.standard_normal((K, V)).astype(np.float32) * 2.0

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    q = softmax(lq / T)
    dtoks = np.stack([gen.choice(V, size=n, p=q[j]) for j in range(K)], 1)
    logits = torch.from_numpy(np.broadcast_to(lp, (n, K + 1, V)).copy())
    dlogits = torch.from_numpy(np.broadcast_to(lq, (n, K, V)).copy())
    emit, n_acc = _accept(
        logits, torch.from_numpy(dtoks), dlogits,
        torch.from_numpy(gen.integers(0, 40, n)),
        torch.arange(n) + 1000, torch.full((n,), T),
        torch.ones(n, dtype=torch.bool), K)
    want = softmax(lp[0] / T) * n
    got = np.bincount(emit[:, 0].numpy(), minlength=V)
    chi2 = float(((got - want) ** 2 / want).sum())
    assert chi2 < 24.32, (chi2, got, want)
    # both paths ran: some rows accepted the first proposal, some not
    assert 0 < int((n_acc > 0).sum()) < n
    # greedy rows take the target's argmax prefix
    emit_g, n_g = _accept(
        logits[:4], torch.from_numpy(dtoks[:4]), dlogits[:4],
        torch.zeros(4, dtype=torch.long), torch.arange(4),
        torch.full((4,), 1e-6), torch.zeros(4, dtype=torch.bool), K)
    tgt = lp.argmax(-1)
    for row, m in zip(emit_g.numpy(), n_g.numpy()):
        assert (row[:m + 1] == tgt[:m + 1]).all()


# -- capacity and refusals ----------------------------------------------------


def test_pool_bytes_budget_charges_both_caches(pair, draft_pair):
    """`pool_bytes=` sizes the pool by the full per-block cost, target
    and draft pools together, with the reference's block count."""
    tgt = kv_block_bytes(2, 4, 48 // 4, 16, "fp32")
    drf = kv_block_bytes(1, 4, 32 // 4, 16, "fp32")
    budget = 6 * (tgt + drf) + tgt  # room for 6 full blocks, not 7
    kw = dict(spec_k=2, slots=2, block_size=16, window=_W,
              pool_bytes=budget)
    eng = SpeculativeEngine(pair[1], draft_pair[1], **kw)
    ref = JaxSpeculativeEngine(pair[0], draft_pair[0], **kw)
    assert eng.allocator.bytes_per_block == tgt + drf \
        == ref.allocator.bytes_per_block
    assert eng.allocator.num_blocks == ref.allocator.num_blocks == 6
    assert eng.pool_bytes == 6 * (tgt + drf)


def test_draft_vocab_mismatch_refused(model):
    bad = gpt_draft(vocab_size=_VOCAB + 3, max_len=_W, d_model=32,
                    num_layers=1, num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(model, bad, slots=1, window=_W)


def test_spec_k_validated(model, draft):
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeEngine(model, draft, spec_k=0, slots=1, window=_W)


def test_draft_window_must_fit(model):
    shallow = gpt_draft(vocab_size=_VOCAB, max_len=32, d_model=32,
                        num_layers=1, num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        SpeculativeEngine(model, shallow, slots=1, window=_W)


def test_gpt_draft_defaults_follow_the_reference(model):
    from singa_tpu.models.gpt import gpt_draft as jax_gpt_draft

    ours = gpt_draft(model)
    theirs = jax_gpt_draft(vocab_size=_VOCAB, max_len=_W)
    assert isinstance(ours, GPT) and ours.device == model.device
    assert (ours.vocab_size, ours.pos.table.shape[0]) == (_VOCAB, _W)
    assert ours.d_model == theirs.d_model == 64
    assert ours.decoder.num_heads == 4 and ours.decoder.n_blocks == 1
    alone = gpt_draft(device="cpu")
    assert (alone.vocab_size, alone.pos.table.shape[0]) == (256, 256)


# -- host bookkeeping ---------------------------------------------------------


def test_advance_slots_vectorized_not_regressed(model):
    """`_advance_slots` is a vectorized numpy write, not a per-slot
    loop: at a production slot count it beats the loop and stays under
    10 ms per step."""
    slots = 4096
    eng = ServingEngine(model, slots=slots, block_size=16, window=_W,
                        num_blocks=2)
    idx = np.arange(slots)
    toks = np.arange(slots, dtype=np.int32) % _VOCAB
    ones = np.ones(slots, np.int32)
    reps = 20
    lengths = eng.lengths.copy()
    n_gen = eng.n_gen.copy()
    last = eng.last_tok.copy()

    t0 = time.perf_counter()
    for _ in range(reps):
        eng._advance_slots(idx, toks, ones)
    t_vec = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        for s in idx:
            lengths[s] += 1
            n_gen[s] += 1
            last[s] = toks[s]
    t_loop = time.perf_counter() - t0

    assert t_vec < t_loop, (t_vec, t_loop)
    assert t_vec / reps < 0.01, t_vec / reps
    np.testing.assert_array_equal(eng.lengths, lengths)
    np.testing.assert_array_equal(eng.n_gen, n_gen)
    np.testing.assert_array_equal(eng.last_tok, last)
