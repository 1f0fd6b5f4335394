"""The disaggregated prefill mesh of the port (`ServingEngine(prefill_mesh=,
prefill_axis=)`), mirroring tests/test_serving_tp.py's
`test_prefill_on_its_own_mesh_reshards_into_tp_decode`, over 4 gloo
ranks.

The reference's oracle puts prefill on chips decode does not use. Here a
rank is a process: decode runs on a (2,) "model" mesh of ranks 0-1,
prefill on a (2,) "data" mesh of ranks 2-3 (`get_mesh(devices=,
allow_outside=True)`, so each side knows the other's ranks). A
`prefill_batch=2` chunk splits one row per prefill rank; each prefill
rank sends each decode rank that rank's 2 of the 4 heads of its row's
K/V, and the logits of its row's last prompt position. One spawn of the
4 ranks runs every case on a small scanned GPT (vocab 61, d 48, 2
layers, 4 heads, window 64) carrying seeded random weights that both
packages load (`helper_torch_parity.serving_params`); the reference's
greedy `generate` runs in a process of its own, spawned beside the
ranks (`run_both`).

Held: requests of 12 and 25 tokens with 8 new each, prefilled as one
2-wide chunk on the prefill mesh into the tp decode, give the
reference's streams with one decode capture; a single-device decode on
rank 0 fed by the same prefill ranks, the second pair admitted through
`begin_prefill_async` after three steps, whose reserved slots' page rows
stay at trash until `finish_prefill`; the speculative engine with an
untrained draft, and with the model as its own draft (acceptance 1.0:
the draft caches crossed whole);
`Frontend(overlap_prefill=True)` gives the FIFO frontend's streams; the
refusals (`prefill_batch` not dividing the prefill axis, a rank with no
role).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_serving_disagg,  # noqa: E402
                                 run_both, serving_params)

WORLD, W, VOCAB = 4, 64, 61
KW = dict(vocab_size=VOCAB, d_model=48, num_layers=2, num_heads=4,
          max_len=W, dropout=0.0, scan_blocks=True)
MAX_NEW = {"a": 8, "b": 8, "c": 10, "d": 6}


def _prompts():
    rng = np.random.default_rng(5)
    return {k: rng.integers(0, VOCAB, n).astype(np.int32)
            for k, n in (("a", 12), ("b", 25), ("c", 9), ("d", 30))}


PROMPTS = _prompts()


def reference_side(params):
    """The reference GPT carrying `params`, and its greedy generate of
    every request."""
    from singa_tpu.models.gpt import GPT as JaxGPT

    ref = JaxGPT(**KW)
    ref.eval()
    ref._ensure_initialized(W)
    ref.set_params(params)
    streams = {k: np.asarray(ref.generate(p, n_new=MAX_NEW[k], window=W))
               [0, len(p):] for k, p in PROMPTS.items()}
    return dict(streams=streams)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's side, the ranks' results), spawned together: the
    weights are made here, so neither waits for the other."""
    params = serving_params(KW)
    return run_both(
        ("test_torch_serving_disagg", "reference_side",
         tmp_path_factory.mktemp("reference"), dict(params=params)),
        (_rank_serving_disagg, WORLD, tmp_path_factory.mktemp("ranks"),
         dict(kw=KW, params=params, window=W, prompts=PROMPTS,
              max_new=MAX_NEW)))


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


def _equal_reference(got, reference, keys):
    assert sorted(got) == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], reference["streams"][k],
                                      err_msg=k)


def test_each_rank_knows_both_layouts(ranks):
    for r in range(WORLD):
        dm, pm, dranks, pranks = ranks[r]["layouts"]
        assert (dm, pm) == (r < 2, r >= 2)
        assert (tuple(dranks), tuple(pranks)) == ((0, 1), (2, 3))


def test_prefill_on_its_own_mesh_reshards_into_tp_decode(ranks, reference):
    for r in (0, 1):
        _equal_reference(ranks[r]["tp"], reference, "ab")
        assert ranks[r]["tp_compiles"][0] == 1
    for r in (2, 3):
        assert ranks[r]["tp_served"] == 1   # one 2-wide chunk, a row each


def test_single_device_decode_fed_by_the_prefill_mesh(ranks, reference):
    _equal_reference(ranks[0]["single"], reference, "abcd")
    assert ranks[0]["single_compiles"][0] == 1
    assert "single" not in ranks[1] and "single_served" not in ranks[1]
    for r in (2, 3):
        assert ranks[r]["single_served"] == 2


@pytest.mark.parametrize("draft", ["tiny", "self"])
def test_speculative_engine_on_the_disaggregated_layout(ranks, reference,
                                                       draft):
    for r in (0, 1):
        _equal_reference(ranks[r][f"spec_{draft}"], reference, "ab")
        assert ranks[r][f"spec_{draft}_compiles"] == (1, 1)
        if draft == "self":
            assert ranks[r]["spec_self_accept"] == 1.0
    for r in (2, 3):
        assert ranks[r][f"spec_{draft}_served"] == 1


def test_reserved_rows_stay_trash_until_finish_prefill(ranks):
    err, before = ranks[0]["async_rows"]
    assert err is None and before == [0, 0]
    assert all(s > 0 for s in ranks[0]["async_rows_after"])


def test_overlapped_frontend_gives_fifos_streams(ranks, reference):
    for r in (0, 1):
        _equal_reference(ranks[r]["fifo"], reference, "abcd")
        for k in "abcd":
            np.testing.assert_array_equal(ranks[r]["overlap"][k],
                                          ranks[r]["fifo"][k])
        assert ranks[r]["overlap_compiles"][0] == 1


def test_the_refusals_name_the_problem(ranks):
    for r in range(WORLD):
        assert "does not divide over the prefill mesh axis" in ranks[r][
            "refusals"]["prefill_batch"]
    assert "has no role" in ranks[1]["refusals"]["no_role"]
    for r in (0, 2, 3):
        assert ranks[r]["refusals"]["no_role"] == "no error"
