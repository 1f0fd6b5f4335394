"""Model-level tensor parallelism of the port (`Linear(tp_axis=)`, BERT's
head-parallel attention and col -> row FFN) trained inside the ordinary
Model / graph / DistOpt stack on a (data, model) mesh: the port of
tests/test_tp_model.py's seven cases.

One spawn of 4 gloo ranks (`helper_torch_parity.run_ranks`) trains the
reference's TpMLP and its one-block BERT on a (data 2, model 2) mesh of
the 4 ranks, the TpMLP again on a (data 1, model 2) mesh of ranks 0-1
(`get_mesh(devices=[0, 1])`), and rank 0 the dense twins without a
mesh. Each rank holds only its blocks of the tensor-parallel weights
(`distributed.place_model_states`, when the DistOpt meets the model);
`get_states` gathers them back. The reference trains the same models
from the same seeded init on a (2, 2) and a (1, 2) mesh of its virtual
devices and on one device, in a process of its own
(`helper_torch_parity.run_reference`). Losses are held to the
reference's tp runs and to the port's dense run, the gathered
parameters after training to the reference's.

Tolerances: the reference test's 1e-4 on losses (relative and
absolute), and 1e-4 on trained parameters (the two packages' sums add
in different orders over 5 SGD steps with momentum).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_tp_model, port_tp_bert,  # noqa: E402
                                 port_tp_mlp, run_ranks, run_reference)
from singa_tpu_torch import layer  # noqa: E402
from singa_tpu_torch.models.transformer import (  # noqa: E402
    BertForClassification, TransformerEncoderLayer, states_from_tp,
    states_to_tp)

WORLD = 4
TOL = 1e-4
STEPS = {"mlp": 5, "bert": 4}


def reference_side():
    """The reference's runs (tests/test_tp_model.py's models and
    settings) on one device, on a (2, 2) mesh and, for the MLP, on a
    (1, 2) mesh: init states, batch, losses and states after."""
    import test_tp_model as ref
    from singa_tpu import opt
    from singa_tpu import tensor as tensor_module
    from singa_tpu.models.transformer import BertForClassification as RBert
    from singa_tpu.parallel import mesh as ref_mesh
    from singa_tpu.tensor import from_numpy

    def bert_setup(tp_axis):
        m = RBert(num_classes=4, num_layers=1, d_model=16, num_heads=4,
                  vocab_size=50, max_len=8, dropout=0.0, tp_axis=tp_axis)
        ids = from_numpy(np.random.default_rng(0).integers(
            0, 50, size=(4, 8)).astype(np.int32))
        y = from_numpy((np.arange(4) % 4).astype(np.int32))
        return m, ids, y, opt.SGD(lr=0.1)

    def run(setup, tp_axis, mesh, steps):
        tensor_module.set_seed(0)
        m, x, y, sgd = setup(tp_axis)
        m.set_optimizer(sgd if mesh is None else opt.DistOpt(
            sgd, mesh=mesh, axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        init = {k: np.asarray(t.data) for k, t in m.get_states().items()}
        losses = [float(np.asarray(m.train_one_batch(x, y)[1].data))
                  for _ in range(steps)]
        after = {k: np.asarray(t.data) for k, t in m.get_states().items()}
        return dict(init=init, losses=losses, after=after,
                    x=np.asarray(x.data), y=np.asarray(y.data))

    devs = jax.devices()
    dp_tp = ref_mesh.get_mesh((2, 2), ("data", "model"), devices=devs[:4])
    tp_only = ref_mesh.get_mesh((1, 2), ("data", "model"), devices=devs[:2])
    out = {}
    for kind, setup in (("mlp", ref._mlp_setup), ("bert", bert_setup)):
        out[kind] = dict(single=run(setup, None, None, STEPS[kind]),
                         dp_tp=run(setup, "model", dp_tp, STEPS[kind]))
    out["mlp"]["tp_only"] = run(ref._mlp_setup, "model", tp_only,
                                STEPS["mlp"])
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_tp_model", "reference_side",
                         tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    def case(kind):
        r = reference[kind]
        return dict(states=r["dp_tp"]["init"],
                    dense_states=r["single"]["init"], x=r["single"]["x"],
                    y=r["single"]["y"])

    return run_ranks(_rank_tp_model, WORLD, tmp_path_factory.mktemp("ranks"),
                     mlp=case("mlp"), bert=case("bert"), steps=STEPS)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _held(ranks, reference, kind, run_key, ref_key, which):
    want = reference[kind][ref_key]
    dense = ranks[0][f"{kind}_dense"]
    for r in which:
        losses, after, _ = ranks[r][run_key]
        close(losses, want["losses"], f"{run_key} losses, rank {r}")
        close(losses, dense[0], f"{run_key} vs the port's dense, rank {r}")
        for k, v in want["after"].items():
            close(after[k], v, f"{run_key} {k} after, rank {r}")
    close(want["losses"], reference[kind]["single"]["losses"],
          f"the reference's {ref_key} vs its single device")


def test_dp_tp_matches_single_device(ranks, reference):
    _held(ranks, reference, "mlp", "mlp_dp_tp", "dp_tp", range(WORLD))


def test_tp_only_matches_single_device(ranks, reference):
    """A (1, 2) mesh of ranks 0-1 (`get_mesh(devices=)`); ranks 2-3 are
    outside it and are told so."""
    _held(ranks, reference, "mlp", "mlp_tp", "tp_only", (0, 1))
    for r in (2, 3):
        assert "not among the mesh's devices" in ranks[r][
            "outside_the_subset"]


def test_param_pspec_set(ranks):
    m = port_tp_mlp(tp_axis="model")
    m.compile([torch.zeros(2, 12)], is_train=False, use_graph=False)
    assert m.fc1.W.pspec == (None, "model")
    assert m.fc1.b.pspec == ("model",)
    assert m.fc2.W.pspec == ("model", None)
    assert getattr(m.fc2.b, "pspec", None) is None  # replicated
    # on the (2, 2) mesh each rank holds its blocks only
    for r in range(WORLD):
        blocks = ranks[r]["mlp_blocks"]
        assert blocks["fc1.W"] == ((12, 8), (None, "model"), (12, 16))
        assert blocks["fc1.b"] == ((8,), ("model",), (16,))
        assert blocks["fc2.W"] == ((8, 4), ("model", None), (16, 4))
        assert "fc2.b" not in blocks and "fc0.W" not in blocks
        assert ranks[r]["bert_blocks"][
            "bert.encoder.blocks.0.attn.w_q"][:2] == ((16, 8),
                                                     (None, "model"))


def test_bad_tp_mode_raises():
    with pytest.raises(ValueError, match="col.*row|row.*col|tp_mode"):
        layer.Linear(8, tp_axis="model", tp_mode="diagonal")


def test_bert_megatron_tp_matches_single_device(ranks, reference):
    _held(ranks, reference, "bert", "bert_dp_tp", "dp_tp", range(WORLD))


def test_seq_axis_equal_tp_axis_raises():
    with pytest.raises(ValueError, match="distinct"):
        TransformerEncoderLayer(4, seq_axis="sp", tp_axis="sp", d_model=16,
                                device="cpu")


def test_tp_checkpoint_portability(ranks, reference):
    """A fused-attention BERT's states restore into a tp model (and back)
    with identical outputs at world 1; the 4 ranks' gathered states of
    the trained tp BERT restore into the dense model, whose logits are
    the ranks'."""
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 50, (2, 8)))
    plain, tp = port_tp_bert(), port_tp_bert("model")
    plain.eval()
    tp.eval()
    states = {k: v.detach().numpy().copy()
              for k, v in plain.get_states().items()}
    with torch.no_grad():
        want = plain(ids)
        tp.set_states(states_to_tp(states))
        close(tp(ids).numpy(), want.numpy(), "tp from the plain states",
              1e-5)
        back = port_tp_bert()
        back.eval()
        back.set_states(states_from_tp(
            {k: v.detach().numpy() for k, v in tp.get_states().items()}))
        close(back(ids).numpy(), want.numpy(), "and back", 1e-5)
    _, gathered, logits = ranks[0]["bert_dp_tp"]
    dense = port_tp_bert()
    dense.eval()
    dense.set_states(states_from_tp(gathered))
    with torch.no_grad():
        got = dense(torch.from_numpy(reference["bert"]["single"]["x"]))
    for r in range(WORLD):
        close(ranks[r]["bert_dp_tp"][2], got.numpy(),
              f"trained tp logits vs the dense restore, rank {r}", 1e-5)
    assert isinstance(dense, BertForClassification)
