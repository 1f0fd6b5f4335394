"""ZeRO-3 on the scanned stack (`ScanTransformerStack(zero3_axis=)`
through `GPT(scan_blocks=True, zero3_axis=)`), serial and with the
double-buffered prefetch (`overlap=True`), alone and beside tensor and
sequence parallelism on distinct axes: the ports of the reference's
tests/test_scan_sharded.py (:114-222), tests/test_scan_tp_zero3.py,
tests/test_scan_overlap.py (:34-130) and tests/test_scan_3d_memory.py.

One spawn of 4 gloo ranks (`helper_torch_parity.run_ranks`) trains the
reference's scan-3d GPT (tests/helper_scan3d.py: vocab 64, d 32, 2
blocks, 4 heads, batch 8 x 16) with DistOpt(SGD(0.1)) for 3 steps: ZeRO-3
over a data axis of 4 (serial; overlapped under each remat policy), over
(data 2, model 2) beside tp (serial under each remat policy, overlapped,
and with a global-norm clip of 0.1), over (data 2, sp 2) beside the ring
(per_block), and the broken prefetch rotation. A rank holds 1/world of
the stack's weights and slots (`distributed.place_model_states`) and
gathers each block as it runs. Every run starts from the port's own
init (the tp stack's the same with its QKV head-interleaved). The
reference, in a process of its own spawned at the same time as the
ranks (`run_both`), loads it and gives its own ZeRO-3 run on a data axis
of 4 of its virtual devices, and the oracle of every one of those
tests: the unrolled single-device decoder carrying the same weights,
trained with SGD (with and without the clip).

Held at the reference tests' tolerance, 1e-4 on the losses (relative and
absolute), and 2e-4 on the gathered states after 3 steps (those of
tests/test_torch_scan_tp.py): each case against the oracle, the serial
ZeRO-3 run against the reference's. The broken rotation must miss the
oracle. Memory: `step_memory_analysis`'s `parameter_bytes` at 1/world of
the stack (1/(tp x zero3) for the tp-split weights), and
`gathered_block_bytes` one block of per-tp-shard weights serial, two
under overlap. The reference's 3-D clip oracle ran on (2, 2, 2); here the
clip runs on (data 2, model 2), where the tp x zero3 weights' square sums
sum over both axes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import _rank_zero3, run_both  # noqa: E402
from singa_tpu_torch import layer, opt  # noqa: E402
from singa_tpu_torch.models.gpt import GPT  # noqa: E402
from singa_tpu_torch.parallel import mesh as mesh_module  # noqa: E402
from singa_tpu_torch.parallel import tp as tp_module  # noqa: E402

WORLD, STEPS, LR, CLIP = 4, 3, 0.1, 0.1
TOL, STATE_TOL = 1e-4, 2e-4
KW = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=32,
          dropout=0.0)
REMATS = ("none", "per_block", "dots_saveable")
#: the tp-split leaves: at 1/(tp x zero3) on a rank, gathered to 1/tp
DOUBLY = {"w_qkv", "b_qkv", "w_o", "w1", "b1", "w2"}
LEAVES = {"w_qkv": "attn.w_qkv", "b_qkv": "attn.b_qkv", "w_o": "attn.w_o",
          "b_o": "attn.b_o", "ln1_s": "ln1.scale", "ln1_o": "ln1.offset",
          "ln2_s": "ln2.scale", "ln2_o": "ln2.offset", "w1": "fc1.W",
          "b1": "fc1.b", "w2": "fc2.W", "b2": "fc2.b"}


def inputs():
    """The scanned GPT's init (the port's own draws) and
    tests/helper_scan3d.py's batch (8 x 16 over 64, numpy seed 0)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (8, 16)).astype(np.int32)
    y = rng.integers(0, 64, (8, 16)).astype(np.int32)
    m = GPT(**KW, scan_blocks=True, device="cpu")
    init = {k: v.detach().numpy().copy() for k, v in m.get_states().items()}
    return dict(init=init, x=x, y=y)


def reference_side(init, x, y):
    """From the port's init: the unrolled single-device oracle (losses
    and parameters after) with and without the clip, and the
    reference's ZeRO-3 run on a data axis of 4."""
    import helper_scan3d as h3
    from singa_tpu import opt as ref_opt
    from singa_tpu.models.gpt import GPT as RGPT
    from singa_tpu.parallel import mesh as ref_mesh
    from singa_tpu.tensor import from_numpy
    from singa_tpu_torch.models.gpt import unstack_params

    x, y = from_numpy(x), from_numpy(y)
    out = {}
    for clip in (None, CLIP):
        unrolled = RGPT(**KW, scan_blocks=False)
        unrolled.compile([x], is_train=True, use_graph=False)
        unrolled.set_params(unstack_params(init))
        unrolled.set_optimizer(ref_opt.SGD(lr=LR, clip_norm=clip))
        unrolled.compile([x], is_train=True, use_graph=True)
        out[f"oracle_{clip}"] = dict(losses=h3.train(unrolled, x, y, STEPS),
                                     after={k: np.asarray(t.data) for k, t in
                                            unrolled.get_params().items()})
    m = RGPT(**KW, scan_blocks=True, zero3_axis="data")
    mesh = ref_mesh.get_mesh((4,), ("data",), devices=jax.devices()[:4])
    m.set_optimizer(ref_opt.DistOpt(ref_opt.SGD(lr=LR), mesh=mesh,
                                    axis_name="data"))
    m.compile([x], is_train=True, use_graph=True)
    m.set_states(init)
    out["z3"] = dict(losses=h3.train(m, x, y, STEPS), after={
        k: np.asarray(t.data) for k, t in m.get_states().items()})
    return out


CASES = {
    "z3": dict(mesh="data", gpt=dict(zero3_axis="data")),
    **{f"overlap_{r}": dict(mesh="data", remat=r,
                            gpt=dict(zero3_axis="data", overlap=True))
       for r in REMATS},
    **{f"tp_z3_{r}": dict(mesh="dp_tp", remat=r,
                          gpt=dict(tp_axis="model", zero3_axis="data"))
       for r in REMATS},
    "tp_z3_overlap": dict(mesh="dp_tp", gpt=dict(
        tp_axis="model", zero3_axis="data", overlap=True)),
    "z3_seq": dict(mesh="dp_sp", remat="per_block",
                   gpt=dict(zero3_axis="data", seq_axis="sp")),
    "clip": dict(mesh="dp_tp", clip=CLIP,
                 gpt=dict(tp_axis="model", zero3_axis="data")),
    "broken": dict(mesh="data", mutate=True,
                   gpt=dict(zero3_axis="data", overlap=True)),
    # 2 heads cannot be split over a model axis of 4
    "heads": dict(mesh="tp4", kw=dict(num_heads=2), expect=True,
                  gpt=dict(tp_axis="model", zero3_axis="data")),
}


def interleaved(states):
    """A tp stack's init: the same draws, its QKV head-interleaved (the
    reference's tp stack draws the standard layout, then permutes)."""
    out = dict(states)
    for k in ("decoder.w_qkv", "decoder.b_qkv"):
        out[k] = tp_module.interleave_qkv_shards(
            torch.from_numpy(states[k]), KW["num_heads"]).numpy()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's runs and the one spawn of the ranks, at once."""
    c = inputs()
    ref, got = run_both(
        ("test_torch_zero3", "reference_side",
         tmp_path_factory.mktemp("reference"), c),
        (_rank_zero3, WORLD, tmp_path_factory.mktemp("ranks"), dict(
            kw=KW, states=dict(plain=c["init"], tp=interleaved(c["init"])),
            x=c["x"], y=c["y"], steps=STEPS, lr=LR, cases=CASES,
            prompt=c["x"][:1, :5], n_new=4)))
    return c, ref, got


@pytest.fixture(scope="module")
def reference(both):
    return dict(both[1], **both[0])


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def stacked(unrolled):
    """The unrolled oracle's parameters under the scanned stack's names."""
    out = {k: v for k, v in unrolled.items() if ".blocks." not in k}
    n = KW["num_layers"]
    for leaf, attr in LEAVES.items():
        out[f"decoder.{leaf}"] = np.stack(
            [unrolled[f"decoder.blocks.{i}.{attr}"] for i in range(n)])
    return out


def held(ranks, reference, name, clip=None):
    want = reference[f"oracle_{clip}"]
    flat = stacked(want["after"])
    for r in range(WORLD):
        got = ranks[r][name]
        close(got["losses"], want["losses"], f"{name} losses, rank {r}")
        after = dict(got["after"])
        if "tp_axis" in CASES[name]["gpt"]:
            for k in ("decoder.w_qkv", "decoder.b_qkv"):
                after[k] = tp_module.deinterleave_qkv_shards(
                    torch.from_numpy(after[k]), KW["num_heads"]).numpy()
        for k, v in flat.items():
            close(after[k], v, f"{name} {k} after, rank {r}", STATE_TOL)


def test_scan_zero3_matches_unrolled_single_device(ranks, reference):
    held(ranks, reference, "z3")
    for r in range(WORLD):
        got = ranks[r]["z3"]
        close(got["losses"], reference["z3"]["losses"], f"vs ref z3, {r}")
        for k, v in reference["z3"]["after"].items():
            close(got["after"][k], v, f"{k} vs ref z3, rank {r}", STATE_TOL)


@pytest.mark.parametrize("remat", REMATS)
def test_overlap_zero3_matches_unrolled(ranks, reference, remat):
    held(ranks, reference, f"overlap_{remat}")


@pytest.mark.parametrize("remat", REMATS)
def test_scan_tp_zero3_matches_unrolled(ranks, reference, remat):
    held(ranks, reference, f"tp_z3_{remat}")


def test_overlap_tp_zero3_matches_unrolled(ranks, reference):
    held(ranks, reference, "tp_z3_overlap")


def test_scan_zero3_seq_matches_unrolled(ranks, reference):
    held(ranks, reference, "z3_seq")


def test_3d_global_norm_clip_oracle(ranks, reference):
    """Each jointly sharded gradient's square sum sums over both its
    axes, so the clip scale is the single device's."""
    held(ranks, reference, "clip", clip=CLIP)
    clipped = reference[f"oracle_{CLIP}"]["losses"]
    unclipped = reference["oracle_None"]["losses"]
    assert abs(clipped[-1] - clipped[0]) < abs(unclipped[-1] - unclipped[0])


def test_broken_double_buffer_rotation_is_caught(ranks, reference):
    broken = ranks[0]["broken"]["losses"]
    assert not np.allclose(reference["oracle_None"]["losses"], broken,
                           atol=TOL, rtol=TOL), (
        "the consume-current-gather mutation trained identically to the "
        "oracle: the overlap equality oracle has no teeth")
    assert not layer._MUTATE_CONSUME_CURRENT_GATHER


def _bytes(states, pred):
    return sum(v.nbytes for k, v in states.items() if pred(k))


def test_zero3_parameter_bytes_are_one_worldth_of_the_stack(ranks,
                                                            reference):
    init = reference["init"]
    stack = _bytes(init, lambda k: k.startswith("decoder."))
    other = _bytes(init, lambda k: not k.startswith("decoder."))
    expect_tp = other + sum(
        v.nbytes // (4 if k[len("decoder."):] in DOUBLY else 2)
        for k, v in init.items() if k.startswith("decoder."))
    for r in range(WORLD):
        assert ranks[r]["z3"]["parameter_bytes"] == other + stack // 4
        assert ranks[r]["z3_seq"]["parameter_bytes"] == other + stack // 2
        assert ranks[r]["tp_z3_none"]["parameter_bytes"] == expect_tp


def test_gathered_block_bytes_models_overlap_liveness(ranks, reference):
    init = reference["init"]
    n = KW["num_layers"]
    block = _bytes(init, lambda k: k.startswith("decoder.")) // n
    tp_block = sum(v.nbytes // n // (2 if k[len("decoder."):] in DOUBLY
                                     else 1)
                   for k, v in init.items() if k.startswith("decoder."))
    for r in range(WORLD):
        got = {k: ranks[r][k]["gathered_block_bytes"] for k in CASES
               if k != "heads"}
        assert got["z3"] == block
        assert got["overlap_none"] == 2 * block
        assert got["tp_z3_none"] == tp_block
        assert got["tp_z3_overlap"] == 2 * tp_block
        # the resting footprint is overlap-blind
        assert ranks[r]["overlap_none"]["parameter_bytes"] == \
            ranks[r]["z3"]["parameter_bytes"]
        assert ranks[r]["tp_z3_overlap"]["parameter_bytes"] == \
            ranks[r]["tp_z3_none"]["parameter_bytes"]


def test_place_model_states_shards_by_pspec(ranks):
    """Each rank holds 1/world of dim 1 of every stacked weight and of
    its optimizer slots; the tp x zero3 blocks hold 1/tp of the tp dim
    and 1/zero3 of the other; the schedule counts 12 gathers a block."""
    for r in range(WORLD):
        z3 = ranks[r]["z3"]
        assert z3["shapes"]["w_qkv"] == (2, 8, 96)
        assert z3["shapes"]["b_o"] == (2, 8)
        assert z3["slot_shape"] == (2, 8, 128)
        assert ranks[r]["tp_z3_none"]["shapes"]["w_qkv"] == (2, 16, 48)
        assert ranks[r]["tp_z3_none"]["shapes"]["w_o"] == (2, 16, 16)
        assert ranks[r]["tp_z3_none"]["shapes"]["b1"] == (2, 32)
        for name in ("z3", "overlap_none", "tp_z3_none"):
            per_block = ranks[r][name]["schedule"]["per_block"]
            assert per_block[("all_gather", "data")] == len(
                layer.ScanTransformerStack.STACKED)
        assert "num_heads" in ranks[r]["heads"]["error"]


def test_cached_decode_of_a_zero3_stack(ranks):
    """`generate` gathers the blocks; every rank decodes the tokens of a
    dense scanned twin carrying the gathered states."""
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["z3"]["tokens"],
                                      ranks[0]["z3"]["twin_tokens"])


def test_declared_schedule_unchanged_under_overlap():
    mesh = mesh_module.get_mesh_3d(1, 1, 1)
    kw = dict(tp_axis="model", zero3_axis="data", seq_axis="sp",
              d_model=32, device="cpu")
    serial = layer.ScanTransformerStack(2, 4, **kw)
    overlapped = layer.ScanTransformerStack(2, 4, overlap=True, **kw)
    assert serial.declared_schedule(mesh) == \
        overlapped.declared_schedule(mesh)


def test_overlap_refused_on_unrolled_gpt():
    with pytest.raises(NotImplementedError, match="scan_blocks=True"):
        GPT(**KW, overlap=True, device="cpu")


def test_overlap_noop_without_sharded_axes(reference):
    """overlap=True with neither zero3_axis nor seq_axis live trains
    bitwise as without it."""
    tx = torch.from_numpy(reference["x"]).long()
    ty = torch.from_numpy(reference["y"]).long()

    def run(overlap):
        m = GPT(**KW, scan_blocks=True, overlap=overlap, device="cpu")
        m.set_states(reference["init"])
        m.set_optimizer(opt.SGD(lr=LR))
        m.compile([tx], is_train=True, use_graph=True)
        return [m.train_one_batch(tx, ty)[1].item() for _ in range(STEPS)]

    assert run(False) == run(True)


def test_scan_sharding_guards():
    with pytest.raises(ValueError, match="DISTINCT"):
        layer.ScanTransformerStack(2, 4, tp_axis="model", zero3_axis="model",
                                   d_model=32, device="cpu")
    with pytest.raises(NotImplementedError, match="scan_blocks"):
        GPT(**KW, scan_blocks=False, zero3_axis="data", device="cpu")
