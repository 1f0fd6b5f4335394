"""The scanned stack's tensor parallelism
(`ScanTransformerStack(tp_axis=)` through `GPT(scan_blocks=True,
tp_axis=)`), alone and beside sequence parallelism on a distinct axis,
against singa_tpu's on its virtual mesh.

One spawn of 4 gloo ranks (`helper_torch_parity.run_ranks`) trains the
reference's scan-3d GPT (tests/helper_scan3d.py: vocab 64, d 32, 2
blocks, 4 heads) with DistOpt(SGD) for 3 steps on a (data 1, model 2)
mesh of ranks 0-1 and on `get_mesh_3d(1, 2, 2)` of all 4 (model x sp),
each rank holding its blocks of the head-interleaved stack; rank 0
trains the port's dense unrolled twin from the same init. The reference
trains the same model on the same meshes of its virtual devices, in a
process of its own (`run_reference`), from the seed-0 init whose states
(QKV head-interleaved in both packages) carry over name for name.

Held: losses and the gathered parameters after 3 steps against the
reference's runs, the losses against the port's dense twin; one step's
"g" and "f" all-reduces against `tp.PSUMS_PER_BLOCK` a block; the
greedy decode of each trained tp stack (blocks gathered, QKV
de-interleaved) against the reference's `generate` of its trained
model. Tolerance 2e-4 (relative and absolute), that of
tests/test_torch_sp_model.py on trained parameters.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from helper_torch_parity import _rank_scan_tp, run_ranks, run_reference  # noqa: E402
from singa_tpu_torch import layer  # noqa: E402
from singa_tpu_torch.parallel import tp  # noqa: E402

WORLD, STEPS, LR, TOL = 4, 3, 0.1, 2e-4
KW = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=32,
          dropout=0.0)
N_NEW, WINDOW = 10, 32


def reference_side():
    """The reference's scanned tp GPT from the seed-0 init, trained on a
    (1, 2) and a (1, 2, 2) mesh: init states, batch, losses, states
    after and the trained model's greedy decode; the dense unrolled
    parameters of the init."""
    import helper_scan3d as h3
    from singa_tpu import opt
    from singa_tpu import tensor as tensor_module
    from singa_tpu.models.gpt import GPT
    from singa_tpu.parallel import mesh as ref_mesh

    devs = jax.devices()
    x, y = h3.batch()
    prompt = np.random.default_rng(3).integers(0, 64, (1, 6)).astype(
        np.int32)
    out = dict(x=np.asarray(x.data), y=np.asarray(y.data), prompt=prompt)
    for name, mesh, kw in (
            ("tp", ref_mesh.get_mesh((1, 2), ("data", "model"),
                                     devices=devs[:2]), {}),
            ("tp_seq", ref_mesh.get_mesh_3d(1, 2, 2, devices=devs[:4]),
             dict(seq_axis="sp"))):
        tensor_module.set_seed(0)
        m = GPT(**KW, scan_blocks=True, tp_axis="model", **kw)
        m.compile([x], is_train=True, use_graph=False)
        init = {k: np.asarray(t.data) for k, t in m.get_states().items()}
        if name == "tp":
            unrolled = GPT(**KW, scan_blocks=False)
            unrolled.compile([x], is_train=True, use_graph=False)
            h3.copy_scan_into_unrolled(m, unrolled)
            out["dense_params"] = {k: np.asarray(t.data) for k, t in
                                   unrolled.get_params().items()}
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=LR), mesh=mesh,
                                    axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        losses = h3.train(m, x, y, STEPS)
        out[name] = dict(init=init, losses=losses, after={
            k: np.asarray(t.data) for k, t in m.get_states().items()},
            tokens=np.asarray(m.generate(prompt, N_NEW, window=WINDOW)))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_scan_tp", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    return run_ranks(
        _rank_scan_tp, WORLD, tmp_path_factory.mktemp("ranks"), kw=KW,
        states=reference["tp"]["init"],
        dense_params=reference["dense_params"], x=reference["x"],
        y=reference["y"], steps=STEPS, lr=LR, prompt=reference["prompt"],
        n_new=N_NEW, window=WINDOW)


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("name,which", [("tp", (0, 1)),
                                        ("tp_seq", (0, 1, 2, 3))])
def test_losses_and_trained_parameters_match_the_reference(
        ranks, reference, name, which):
    want = reference[name]
    close(want["losses"], reference["tp"]["losses"], "reference meshes")
    for r in which:
        got = ranks[r][name]
        close(got["losses"], want["losses"], f"{name} losses, rank {r}")
        close(got["losses"], ranks[0]["dense"]["losses"],
              f"{name} vs the port's dense twin, rank {r}")
        for k, v in want["after"].items():
            close(got["after"][k], v, f"{name} {k} after, rank {r}")


@pytest.mark.parametrize("name,which", [("tp", (0, 1)),
                                        ("tp_seq", (0, 1, 2, 3))])
def test_each_block_costs_psums_per_block_all_reduces(ranks, name, which):
    n = KW["num_layers"] * tp.PSUMS_PER_BLOCK
    for r in which:
        got = ranks[r][name]
        assert got["counts"] == {"g:model": n, "f:model": n}, got["counts"]
        assert got["schedule"]["per_block"][("psum", "model")] == \
            tp.PSUMS_PER_BLOCK
        # each rank holds its half of the interleaved QKV columns
        assert got["block_shape"] == (2, 32, 48)


@pytest.mark.parametrize("name,which", [("tp", (0, 1)),
                                        ("tp_seq", (0, 1, 2, 3))])
def test_decode_of_the_trained_stack_matches_the_reference(
        ranks, reference, name, which):
    for r in which:
        np.testing.assert_array_equal(ranks[r][name]["tokens"],
                                      reference[name]["tokens"])
    # the port's dense twin, trained the same 3 steps from the same init
    np.testing.assert_array_equal(ranks[0]["dense"]["tokens"],
                                  reference[name]["tokens"])


def test_the_stack_refuses_a_shared_axis_and_zero3():
    """tp and seq, or tp and ZeRO-3, on one axis raise; ZeRO-3 on a
    distinct axis composes with tp (tests/test_torch_zero3.py)."""
    with pytest.raises(ValueError, match="DISTINCT"):
        layer.ScanTransformerStack(1, 4, d_model=32, device="cpu",
                                   tp_axis="model", seq_axis="model")
    with pytest.raises(ValueError, match="DISTINCT"):
        layer.ScanTransformerStack(1, 4, d_model=32, device="cpu",
                                   tp_axis="model", zero3_axis="model")
    stack = layer.ScanTransformerStack(1, 4, d_model=32, device="cpu",
                                       tp_axis="model", zero3_axis="data")
    assert stack.w_o.pspec == (None, "model", "data")
    assert stack.b_qkv.pspec == (None, ("model", "data"))
