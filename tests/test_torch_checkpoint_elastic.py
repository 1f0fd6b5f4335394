"""Elastic restore and the two-phase commit over ranks: the port of
tests/test_resilience_elastic.py and tests/test_multihost_checkpoint.py,
a rank being a process.

One spawn of 2 gloo ranks (`helper_torch_parity._rank_ckpt_elastic`):

- the reference's TpMLP (tests/test_tp_model.py) on a (data 1, model 2)
  mesh and the scanned GPT with `zero3_axis="data"` on a data axis of 2,
  3 steps of DistOpt(SGD(0.1, momentum 0.9)) each, then a save: each
  rank writes only the shards it owns (`distributed.shard_owner_map`),
  its shard index and receipt, and rank 0 commits the merged manifest;
- a fresh TpMLP on that mesh restored from a checkpoint this process
  wrote at world 1 (each rank reads only the files overlapping its
  blocks);
- a save rank 1 never joins, which rank 0 must refuse with
  `TornSaveError` naming rank 1, committing nothing.

The reference, in a process of its own spawned at the same time
(`run_both`), runs the same steps from the same init on its virtual
devices, saves, restores into the model with the same axes declared on
one device, and takes one more step: its elastic run.

Held: the ranks' losses within 1e-6 of the reference's; the restore at
world 1 (the tp and zero3 axes declared, no mesh) bitwise the ranks'
gathered parameters and optimizer slots; one more step after it within
1e-6 of the reference's elastic run; the world-1 checkpoint read at
world 2 bitwise (each rank's blocks its slices of the full arrays); the
manifest's per-rank shard files, receipts and ACKs, with no attempt
nonce left.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (CKPT_GPT, _ckpt_train, _np,  # noqa: E402
                                 _rank_ckpt_elastic, ckpt_tp_states,
                                 port_tp_mlp, run_both)
from singa_tpu_torch import resilience, storage  # noqa: E402
from singa_tpu_torch.models.gpt import GPT  # noqa: E402
from singa_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402

WORLD, STEPS, TOL = 2, 3, 1e-6


def gpt_inputs():
    torch.manual_seed(0)
    m = GPT(**CKPT_GPT, scan_blocks=True, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (4, 16)).astype(np.int32)
    y = rng.integers(0, 64, (4, 16)).astype(np.int32)
    m.compile([torch.from_numpy(x).long()], is_train=False)
    return dict(states={k: _np(v) for k, v in m.get_states().items()},
                x=x, y=y)


def reference_side(tp, gpt, steps, base):
    """The reference's elastic runs: the TpMLP on a (1, 2) mesh and the
    zero3 GPT on a data axis of 2, `steps` steps from the given states,
    saved, restored into the same model declared on one device, then one
    more step: the losses, and the states after that step."""
    import tempfile

    import test_tp_model as ref_tp
    from singa_tpu import opt, resilience as ref_resilience
    from singa_tpu.models.gpt import GPT as RGPT
    from singa_tpu.parallel import mesh as ref_mesh
    from singa_tpu.tensor import from_numpy

    def train(m, d, mesh, n):
        x, y = from_numpy(d["x"]), from_numpy(d["y"])
        sgd = opt.SGD(lr=0.1, momentum=0.9)
        m.set_optimizer(sgd if mesh is None else opt.DistOpt(
            sgd, mesh=mesh, axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        if d.get("states") is not None:
            m.set_states(d["states"])
        return [float(np.asarray(m.train_one_batch(x, y)[1].data))
                for _ in range(n)]

    out = {}
    cases = (
        ("tp", lambda: ref_tp.TpMLP(hidden=16, num_classes=4,
                                    tp_axis="model"), tp, (1, 2),
         ("data", "model")),
        ("z3", lambda: RGPT(**CKPT_GPT, scan_blocks=True,
                            zero3_axis="data"), gpt, (2,), ("data",)))
    for name, make, d, shape, names in cases:
        mesh = ref_mesh.get_mesh(shape, names, devices=jax.devices()[:2])
        m = make()
        losses = train(m, d, mesh, steps)
        where = tempfile.mkdtemp(dir=base)
        ref_resilience.save(where, m, m._optimizer, step=steps)
        single = make()
        train(single, dict(d, states=None), None, 0)
        ref_resilience.restore(where, single, single._optimizer,
                               set_rng=False)
        train_more = [float(np.asarray(single.train_one_batch(
            from_numpy(d["x"]), from_numpy(d["y"]))[1].data))]
        out[name] = dict(losses=losses, next_loss=train_more[0], after={
            k: np.asarray(t.data) for k, t in single.get_states().items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic")
    tp_states, x, y = ckpt_tp_states()
    tp = dict(states=tp_states, x=x, y=y)
    gpt = gpt_inputs()
    dirs = {k: str(base / k) for k in ("tp", "z3", "w1", "torn")}
    # a checkpoint of one process, for the ranks to read at world 2
    w1 = port_tp_mlp(tp_axis="model")
    _ckpt_train(w1, tp["states"], x, y, STEPS, None)
    resilience.save(dirs["w1"], w1, w1.optimizer, step=STEPS)
    w1_state = dict(after={k: _np(v) for k, v in w1.get_states().items()},
                    opt={k: _np(v) for k, v in
                         w1.optimizer.dump_states().items()})
    ref, ranks = run_both(
        ("test_torch_checkpoint_elastic", "reference_side",
         tmp_path_factory.mktemp("reference"),
         dict(tp=tp, gpt=gpt, steps=STEPS, base=str(base))),
        (_rank_ckpt_elastic, WORLD, tmp_path_factory.mktemp("ranks"),
         dict(tp=tp, gpt=gpt, steps=STEPS, dirs=dirs)))
    return dict(ref=ref, ranks=ranks, dirs=dirs, tp=tp, gpt=gpt,
                w1=w1_state)


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def slices(full, block, rank):
    """Whether `block` is rank `rank`'s equal part of `full` along the
    dims where their shapes differ."""
    out = full
    for dim, (f, b) in enumerate(zip(full.shape, block.shape)):
        if f != b:
            out = np.split(out, f // b, axis=dim)[rank]
    return np.array_equal(out, block)


@pytest.mark.parametrize("name", ["tp", "z3"])
def test_the_ranks_train_and_save_as_the_reference(runs, name):
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"]
    close(r0["losses"], runs["ref"][name]["losses"], f"{name} losses")
    same(r1["after"], r0["after"], f"{name}: the ranks' gathered states")
    assert r0["blocks"], "no placed block: the run was not sharded"
    manifest, step_dir = resilience.read_manifest(runs["dirs"][name])
    assert manifest["processes"] == WORLD and manifest["step"] == STEPS
    assert step_dir == r0["step_dir"] == r1["step_dir"]
    drv = storage.get_driver(step_dir)
    names = drv.list(step_dir)
    assert {"COMMIT-p1", "SHARDS-p1.json", "ACK-p1"} <= set(names)
    assert ckpt.SAVE_NONCE not in names
    index = json.loads(drv.read(storage.join(step_dir, "SHARDS-p1.json")))
    nonce = index["nonce"]
    assert drv.read(storage.join(step_dir, "COMMIT-p1")).decode() == nonce
    assert drv.read(storage.join(step_dir, "ACK-p1")).decode() == nonce
    # rank 1 wrote only the shards it owns: its blocks, never a
    # replicated leaf (rank 0, the lowest holder, owns those)
    by_rank1 = {leaf["name"]: len(leaf["shards"])
                for leaf in index["leaves"]}
    shards = {leaf["name"]: len(leaf["shards"])
              for leaf in manifest["leaves"]}
    for leaf, n in shards.items():
        placed = leaf.split("/", 1)[1].split("//")[0] in r0["blocks"]
        assert n == (WORLD if placed else 1), leaf
        assert by_rank1[leaf] == (1 if placed else 0), leaf


@pytest.mark.parametrize("name", ["tp", "z3"])
def test_a_restore_at_world_1_is_bitwise_then_tracks_the_reference(
        runs, name):
    r0, r1 = (r[name] for r in runs["ranks"])
    d = runs["tp"] if name == "tp" else runs["gpt"]
    m = (port_tp_mlp(tp_axis="model") if name == "tp" else
         GPT(**CKPT_GPT, scan_blocks=True, zero3_axis="data", device="cpu"))
    fresh = {k: v * 0 for k, v in d["states"].items()}
    _ckpt_train(m, fresh, d["x"], d["y"], 0, None)
    meta = resilience.restore(runs["dirs"][name], m, m.optimizer)
    assert meta["step"] == STEPS and m.optimizer.step_counter == STEPS
    same({k: _np(v) for k, v in m.get_states().items()}, r0["after"],
         f"{name}: restored states")
    for k, v in m.optimizer.dump_states().items():
        full = _np(v)
        if k == "__step__":
            assert int(full) == STEPS
            continue
        for rank, got in enumerate((r0["opt"][k], r1["opt"][k])):
            assert slices(full, got, rank), f"{name}: slot {k} rank {rank}"
    tx = torch.from_numpy(d["x"])
    tx, ty = (tx if name == "tp" else tx.long()), torch.from_numpy(
        d["y"]).long()
    loss = m.train_one_batch(tx, ty)[1].item()
    want = runs["ref"][name]
    close(loss, want["next_loss"], f"{name}: the next loss")
    got = {k: _np(v) for k, v in m.get_states().items()}
    for k, v in want["after"].items():
        close(got[k], v, f"{name}: {k} after the next step")


def test_a_world_1_checkpoint_restores_at_world_2(runs):
    want = runs["w1"]
    for rank, r in enumerate(runs["ranks"]):
        got = r["from_w1"]
        assert got["step"] == STEPS
        same(got["after"], want["after"], f"rank {rank}: gathered")
        assert got["blocks"], "no placed block"
        for n, (shape, block) in got["blocks"].items():
            assert slices(want["after"][n], block, rank), (rank, n)
        for k, block in got["opt"].items():
            if k != "__step__":
                assert slices(want["opt"][k], block, rank), (rank, k)


def test_a_rank_without_a_receipt_tears_the_save(runs):
    msg = runs["ranks"][0]["torn"]
    assert msg is not None and "no phase-1 receipt" in msg
    assert "rank(s) [1]" in msg
    assert runs["ranks"][1].get("torn") is None
    with pytest.raises(resilience.CheckpointError, match="no committed"):
        resilience.latest_step_dir(runs["dirs"]["torn"])
