"""The tensor-parallel serving decode of the port (`ServingEngine(mesh=,
tp_axis=)`), the decode half of tests/test_serving_tp.py and the tp
cases of tests/test_serving_prefix_tp.py, over 2 gloo ranks.

One spawn of 2 ranks (`helper_torch_parity.run_ranks`) builds engines
on the group's (2,) "model" mesh for a small scanned GPT carrying the
reference's seeded random weights (vocab 61, not divisible by 2, so the
vocab-parallel head pads and slices back): each rank's pools hold 2 of
the 4 heads, its step runs its blocks of the weights, and one logits
all-gather a step assembles the row. The reference's greedy `generate`
of every stream runs in a process of its own (`run_reference`).

Held: greedy fp32 streams of the staggered admit/evict workload (a
mid-flight cancel fragments the blocks) equal the reference's generate
and the port's solo generate on both ranks; sampled streams equal the
port's solo generate (its noise is the port's own, not jax.random's);
int8 pools match the fp32 stream on at least 85% of the tokens (the
reference test's rate); the prefix cache's warm streams, greedy and
sampled, equal the solo generate with two hits; one step runs
2 all-reduces a block and one logits gather; a rank's block bytes are
half the single-device engine's; an engine on a (1,) mesh of one rank
gives the single-device engine's logits bitwise; the refusals name
their cause: no tp_axis, an axis not on the mesh, heads the axis does
not divide, a prefill batch the prefill mesh does not divide, a prefill
axis not on the prefill mesh, and a draft whose heads the axis does not
divide.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_serving_tp, randomize_params,  # noqa: E402
                                 run_ranks, run_reference)
from singa_tpu_torch.parallel import tp  # noqa: E402
from singa_tpu_torch.serving.blocks import kv_block_bytes  # noqa: E402

WORLD, W, VOCAB = 2, 64, 61
KW = dict(vocab_size=VOCAB, d_model=48, num_layers=2, num_heads=4,
          max_len=W, dropout=0.0, scan_blocks=True)
ODD_KW = dict(KW, num_heads=3)
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


def reference_side():
    """The reference GPT's seeded random weights and its greedy
    generate of every stream."""
    from singa_tpu.models.gpt import GPT as JaxGPT

    ref = JaxGPT(**KW)
    ref.eval()
    ref._ensure_initialized(W)
    params = randomize_params(ref, 0)

    def gen(p, n):
        return np.asarray(ref.generate(p, n_new=n, window=W))[0, len(p):]

    return dict(params=params,
                streams={k: gen(PROMPTS[k], MAX_NEW[k]) for k in "acd"},
                prefix=[gen(np.concatenate([SHARED, t]), 8) for t in TAILS])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_serving_tp", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    return run_ranks(_rank_serving_tp, WORLD,
                     tmp_path_factory.mktemp("ranks"), kw=KW,
                     params=reference["params"], window=W, prompts=PROMPTS,
                     max_new=MAX_NEW, shared=SHARED, tails=TAILS,
                     odd_kw=ODD_KW)


def test_tp2_fp32_staggered_streams_equal_generate(ranks, reference):
    solo = ranks[0]["solo"]
    for r in range(WORLD):
        for k in "acd":
            np.testing.assert_array_equal(ranks[r]["fp32"][k],
                                          reference["streams"][k], err_msg=k)
            np.testing.assert_array_equal(ranks[r]["fp32"][k], solo[k])
        assert ranks[r]["fp32_compiles"] == 1


def test_tp2_sampled_streams_equal_the_ports_generate(ranks):
    for r in range(WORLD):
        for k in "acd":
            np.testing.assert_array_equal(ranks[r]["sampled"][k],
                                          ranks[0]["solo_sampled"][k])


def test_tp2_int8_streams_keep_a_high_match_rate(ranks, reference):
    for r in range(WORLD):
        for k in "acd":
            rate = (ranks[r]["int8"][k] == reference["streams"][k]).mean()
            assert rate >= 0.85, (k, rate)
        assert ranks[r]["int8_compiles"] == 1


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_tp2_prefix_cache_warm_streams_equal_generate(ranks, reference,
                                                      temperature):
    for r in range(WORLD):
        got = ranks[r][f"prefix_{temperature}"]
        assert [c for _, c in got] == [0, 32, 32]
        for i, (toks, _) in enumerate(got):
            np.testing.assert_array_equal(
                toks, ranks[0]["solo_prefix"][temperature][i])
            if temperature == 0.0:
                np.testing.assert_array_equal(toks, reference["prefix"][i])
        assert ranks[r][f"prefix_{temperature}_stats"] == (2, 1, 1)


def test_one_step_is_two_all_reduces_a_block_and_one_gather(ranks):
    n = KW["num_layers"] * tp.PSUMS_PER_BLOCK
    for r in range(WORLD):
        assert ranks[r]["step_counts"] == {
            "g:model": n, "gather:model": tp.LOGITS_GATHERS_PER_STEP}


def test_per_rank_block_bytes_halve_at_tp2(ranks):
    full = kv_block_bytes(2, 4, 12, 16, "fp32")
    half = kv_block_bytes(2, 4, 12, 16, "fp32", tp=2)
    assert half * 2 == full
    for r in range(WORLD):
        assert ranks[r]["bytes_per_block"] == half
        assert ranks[r]["pool_heads"][3] == 2  # (L, NB, bs, heads, hd)


def test_a_one_rank_mesh_gives_the_single_device_logits(ranks):
    for r in range(WORLD):
        single, mesh1 = ranks[r]["tp1_logits"]
        np.testing.assert_array_equal(single, mesh1)


def test_the_refusals_name_the_problem(ranks):
    got = ranks[0]["refusals"]
    assert "needs tp_axis" in got["needs_tp_axis"]
    assert "not on the mesh" in got["not_on_mesh"]
    assert "heads do not divide" in got["heads"]
    assert got["prefill_mesh"].startswith("ValueError") and (
        "does not divide over the prefill mesh axis 'model' (extent 2)"
        in got["prefill_mesh"]), got["prefill_mesh"]
    assert got["prefill_axis"].startswith("ValueError") and (
        "'data' is not on the prefill mesh" in got["prefill_axis"])
    assert got["speculative"].startswith("ValueError") and (
        "draft has 3 heads, not divisible over tp=2"
        in got["speculative"]), got["speculative"]


def test_a_mesh_without_a_group_serves_as_the_single_device_engine(
        reference):
    """A (1,) mesh of one process with no group: the collectives are the
    identity and the streams and logits are the single-device engine's."""
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT
    from singa_tpu_torch.parallel import mesh as mesh_module
    from singa_tpu_torch.serving import Request, ServingEngine

    m = GPT(**KW, device="cpu")
    load_singa_tpu_params(m, reference["params"])
    m.eval()
    got = []
    for kw in ({}, dict(mesh=mesh_module.get_mesh((1,), ("model",)),
                        tp_axis="model")):
        eng = ServingEngine(m, slots=2, block_size=16, window=W, **kw)
        r = Request("a", PROMPTS["c"], MAX_NEW["c"])
        eng.admit(r)
        logits = eng.peek_logits()
        while eng.n_active:
            eng.step()
        got.append((r.tokens, logits))
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_array_equal(np.asarray(got[0][0], np.int32),
                                  reference["streams"]["c"])


def test_serve_example_tp2_streams_equal_the_single_device_serve(capsys):
    """`serve_gpt --tp 2` on the CPU: rank 0 here, rank 1 spawned over
    gloo, the weights pretrained once on rank 0 and broadcast; its greedy
    streams equal the same serve without --tp."""
    from singa_tpu_torch.examples import serve_gpt

    argv = ["--device", "cpu", "--requests", "4", "--slots", "2",
            "--max-new", "8", "--d-model", "32", "--heads", "2",
            "--steps", "2"]
    plain = serve_gpt.main(argv)
    sharded = serve_gpt.main(argv + ["--tp", "2"])
    out = capsys.readouterr().out
    assert out.count("served 4/4 requests") == 2
    assert [list(h.tokens) for h in sharded] == [
        list(h.tokens) for h in plain]
    assert all(len(h.tokens) == 8 for h in sharded)
