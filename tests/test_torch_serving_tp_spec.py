"""The sharded speculative round of the port (`SpeculativeEngine(mesh=,
tp_axis=)`), mirroring tests/test_serving_tp.py:127-190 and the
speculative cases of tests/test_serving_prefix_tp.py, over 2 gloo ranks.

One spawn of 2 ranks builds engines on the group's (2,) "model" mesh
for a small scanned GPT (vocab 61, d 48, 2 layers, 4 heads, window 64)
carrying seeded random weights that both packages load
(`helper_torch_parity.serving_params`), and an untrained draft (d 32, 1
block, 4 heads): the draft's
pools and weights shard over the target's axis, so each rank's draft
pools hold 2 of its 4 heads, each propose micro-step runs the draft's
blocks of the weights with its all-reduces and one logits gather, and
verify is the target's sharded window pass. The reference's greedy
`generate` runs in a process of its own, spawned beside the ranks
(`run_both`).

Held: greedy staggered streams (spec_k 3, slots 3, a mid-flight cancel)
equal the reference's generate; int8 pools match them on at least 85%
of the tokens; sampled streams equal the port's single-device
speculative engine on the same seeds (the noise is the port's own); the
model as its own draft accepts every proposal; propose and verify build
once each; one round runs 2 x (L_target + L_draft x (K+1)) all-reduces
and K+2 logits gathers (`declared_schedule`'s census); the prefix
cache's warm admissions fill both caches suffix-only; a draft whose
heads the axis does not divide is refused by name.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_serving_tp_spec,  # noqa: E402
                                 run_both, serving_params)
from singa_tpu_torch.parallel import tp  # noqa: E402

WORLD, W, VOCAB, K = 2, 64, 61, 3
KW = dict(vocab_size=VOCAB, d_model=48, num_layers=2, num_heads=4,
          max_len=W, dropout=0.0, scan_blocks=True)
ODD_KW = dict(KW, num_heads=3, num_layers=1)
MAX_NEW = {"a": 14, "b": 12, "c": 14, "d": 8}


def _prompts():
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, VOCAB, n).astype(np.int32)
            for k, n in (("a", 5), ("b", 30), ("c", 37), ("d", 12))}


def _shared():
    rng = np.random.default_rng(8)
    shared = rng.integers(0, VOCAB, 32).astype(np.int32)
    tails = [rng.integers(0, VOCAB, 4 + 3 * i).astype(np.int32)
             for i in range(3)]
    return shared, tails


PROMPTS = _prompts()
SHARED, TAILS = _shared()


def reference_side(params):
    """The reference GPT carrying `params`, and its greedy generate of
    every stream the ranks hold."""
    from singa_tpu.models.gpt import GPT as JaxGPT

    ref = JaxGPT(**KW)
    ref.eval()
    ref._ensure_initialized(W)
    ref.set_params(params)

    def gen(p, n):
        return np.asarray(ref.generate(p, n_new=n, window=W))[0, len(p):]

    return dict(streams={k: gen(PROMPTS[k], MAX_NEW[k]) for k in "acd"},
                prefix=[gen(np.concatenate([SHARED, t]), 8) for t in TAILS])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's side, the ranks' results), spawned together: the
    weights are made here, so neither waits for the other."""
    params = serving_params(KW)
    return run_both(
        ("test_torch_serving_tp_spec", "reference_side",
         tmp_path_factory.mktemp("reference"), dict(params=params)),
        (_rank_serving_tp_spec, WORLD, tmp_path_factory.mktemp("ranks"),
         dict(kw=KW, params=params, window=W, prompts=PROMPTS,
              max_new=MAX_NEW, shared=SHARED, tails=TAILS,
              odd_kw=ODD_KW)))


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


def test_greedy_staggered_streams_equal_generate(ranks, reference):
    for r in range(WORLD):
        for k in "acd":
            np.testing.assert_array_equal(ranks[r]["greedy"][k],
                                          reference["streams"][k], err_msg=k)


@pytest.mark.parametrize("name", ["greedy", "int8", "sampled"])
def test_propose_and_verify_build_once(ranks, name):
    for r in range(WORLD):
        assert ranks[r][f"{name}_compiles"] == (1, 1)


def test_int8_pools_keep_a_high_match_rate(ranks, reference):
    for r in range(WORLD):
        for k in "acd":
            rate = (ranks[r]["int8"][k] == reference["streams"][k]).mean()
            assert rate >= 0.85, (k, rate)


def test_sampled_streams_equal_the_single_device_speculative_engine(ranks):
    for r in range(WORLD):
        for k in "acd":
            np.testing.assert_array_equal(ranks[r]["sampled"][k],
                                          ranks[0]["solo_sampled"][k])


def test_self_draft_acceptance_is_full(ranks, reference):
    for r in range(WORLD):
        toks, rate = ranks[r]["self"]
        np.testing.assert_array_equal(toks, reference["streams"]["d"])
        assert rate == 1.0


def test_one_round_follows_the_declared_census(ranks):
    lt, ld = KW["num_layers"], 1
    for r in range(WORLD):
        assert ranks[r]["round_counts"] == {
            "g:model": tp.PSUMS_PER_BLOCK * (lt + ld * (K + 1)),
            "gather:model": tp.LOGITS_GATHERS_PER_STEP * (K + 2)}
        assert ranks[r]["draft_pool"][3] == 2   # (L, NB, bs, heads, hd)


def test_prefix_cache_warm_streams_fill_both_caches(ranks, reference):
    for r in range(WORLD):
        got = ranks[r]["prefix"]
        assert [c for _, c in got] == [0, 32, 32]
        for i, (toks, _) in enumerate(got):
            np.testing.assert_array_equal(toks, reference["prefix"][i])
        assert ranks[r]["prefix_stats"] == (2, 1, 1)


def test_a_draft_the_axis_does_not_divide_is_refused(ranks):
    for r in range(WORLD):
        assert "draft has 3 heads" in ranks[r]["refusal"]
