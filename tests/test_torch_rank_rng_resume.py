"""F12: a resumed multi-rank run keeps every rank's dropout stream.

The reference folds the data-axis index into each distributed step's key
(singa_tpu/graph.py:669-673), and that key comes from the global PRNG
state its manifest saves and restores (singa_tpu/resilience/
checkpoint.py:427, 1386-1390): every rank's masks resume. In the port
rank r > 0 draws from a generator of its own (`autograd.rank_draws`);
its state must ride the checkpoint too.

tests/test_torch_resume.py's unrolled GPT (dropout 0.1) under
DistOpt(AdamW) on 2 gloo ranks (`helper_torch_parity._rank_rng_resume`):
run A trains 8 steps unbroken; run B trains 4 and saves; run C, in
fresh processes whose generators start elsewhere, restores and trains
the last 4. Held, on every rank: C's losses bitwise A's last 4, and
every parameter and optimizer slot after step 8 bitwise A's.

Then what a restore into another world does with rank r's stream,
pinned in one process (`autograd.rank_draws` stands for the ranks): a
rank the saving world had resumes its stream where the save left it; a
rank it did not have starts its stream from the seed, as at a fresh
start; a world-1 checkpoint carries no rank stream at all. A rank's
saved stream resumes on another index of the same device type (the same
world laid out over other cards), and a stream saved on another device
type starts afresh with a warning.
"""

import warnings

import numpy as np
import pytest
import torch

from helper_torch_parity import (_rank_rng_resume, ckpt_net,
                                 rng_resume_batches, run_ranks)
from singa_tpu_torch import autograd, resilience, tensor

WORLD, STEPS = 2, 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("ck"))
    data = rng_resume_batches(STEPS)
    ab = run_ranks(_rank_rng_resume, WORLD, tmp_path_factory.mktemp("ab"),
                   phase="ab", directory=directory, data=data)
    c = run_ranks(_rank_rng_resume, WORLD, tmp_path_factory.mktemp("c"),
                  phase="c", directory=directory, data=data)
    return ab, c


def _max_delta(got, want):
    return max(float(np.max(np.abs(got[k].astype(np.float64)
                                   - want[k].astype(np.float64))))
               for k in want)


@pytest.mark.parametrize("rank", range(WORLD))
def test_resumed_losses_are_the_unbroken_runs(runs, rank):
    ab, c = runs
    a, got = ab[rank]["a"], c[rank]["c"]
    assert c[rank]["start"] == 4
    np.testing.assert_array_equal(ab[rank]["b"]["losses"], a["losses"][:4])
    np.testing.assert_array_equal(
        got["losses"], a["losses"][4:],
        err_msg=f"rank {rank}: resumed losses part from the unbroken run")


@pytest.mark.parametrize("rank", range(WORLD))
def test_resumed_parameters_and_slots_are_the_unbroken_runs(runs, rank):
    ab, c = runs
    a, got = ab[rank]["a"], c[rank]["c"]
    keys = [k for k in a if k != "losses"]
    assert sorted(k for k in got if k != "losses") == sorted(keys)
    delta = _max_delta({k: got[k] for k in keys}, {k: a[k] for k in keys})
    for k in keys:
        np.testing.assert_array_equal(
            got[k], a[k], err_msg=f"rank {rank}: {k} (max |d| over every "
                                  f"parameter and slot {delta:.3e})")


# -- a restore into another world --------------------------------------------


def _masks(rank, n=3):
    """n dropout masks drawn as rank `rank` (the generator of a rank > 0
    is made, or reseeded, at its first draw)."""
    x = torch.ones(64)
    with autograd.rank_draws(rank):
        return [autograd.dropout(x, 0.5) for _ in range(n)]


def _saved(tmp_path, ranks):
    tensor.set_seed(5)
    autograd.reset_rank_draws()
    m = ckpt_net()[0]
    for r in ranks:
        _masks(r)
    d = str(tmp_path / f"ck{len(ranks)}")
    resilience.save(d, m, m.optimizer, step=1)
    return m, d


def test_an_elastic_restore_resumes_the_saved_ranks_and_seeds_the_rest(
        tmp_path):
    # the streams as the saving world 2 would continue them, and rank 2's
    # from a fresh start
    _saved(tmp_path, [1])
    want1 = _masks(1)
    autograd.reset_rank_draws()
    fresh2 = _masks(2)

    m, d = _saved(tmp_path, [1])
    _masks(1), _masks(2)  # the live streams move on past the save
    manifest, _ = resilience.read_manifest(d)
    assert [e["rank"] for e in manifest["rng"]["ranks"]] == [1]
    resilience.restore(d, m, m.optimizer)  # into a world of 3
    for got, want in zip(_masks(1), want1):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(_masks(2), fresh2):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_world_1_checkpoint_carries_no_rank_stream(tmp_path):
    m, d = _saved(tmp_path, [])
    manifest, _ = resilience.read_manifest(d)
    assert "ranks" not in manifest["rng"]
    autograd.reset_rank_draws()
    fresh1 = _masks(1)
    _masks(1)
    resilience.restore(d, m, m.optimizer)
    for got, want in zip(_masks(1), fresh1):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_rank_resumes_on_another_index_of_its_device_type(tmp_path):
    # rank 1's stream saved by a process on card 1 (one card a process,
    # 2 nodes x 2 cards) and restored where rank 1 draws on another index
    tensor.set_seed(5)
    autograd.reset_rank_draws()
    _masks(1)
    state = tensor.get_rng_state()
    want1 = _masks(1)
    assert [e["device"] for e in state["ranks"]] == ["cpu"]
    state["ranks"] = [dict(e, device="cpu:1") for e in state["ranks"]]
    _masks(1)  # the live stream moves on past the snapshot
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tensor.set_rng_state(state)
        got = _masks(1)
    for g, w in zip(got, want1):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_a_stream_saved_on_another_device_type_starts_afresh_and_warns(
        tmp_path):
    tensor.set_seed(5)
    autograd.reset_rank_draws()
    fresh1 = _masks(1)
    state = tensor.get_rng_state()
    state["ranks"] = [{"rank": 1, "device": "cuda:0",
                       "state": [0] * 16}]  # a card's philox seed, offset
    with pytest.warns(UserWarning, match="rank 1's dropout stream was "
                                         "saved on cuda"):
        tensor.set_rng_state(state)
    for g, w in zip(_masks(1), fresh1):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
