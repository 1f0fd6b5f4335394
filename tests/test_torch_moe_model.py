"""Model-level Mixture-of-Experts of the port (`layer.MoEFFN`, the MoE
encoder block, BERT and GPT) trained through the ordinary Model / graph
/ DistOpt stack on (data, expert) meshes: the ports of the reference's
tests/test_moe_model.py (twelve cases), tests/test_moe_model_guards.py
(three) and tests/test_hybrid_3axis.py (two).

One spawn of 4 gloo ranks (`helper_torch_parity.run_ranks`) runs every
multi-rank case: the distributed step cuts the batch over (data,
expert), the MoE FFN exchanges its queues with an all-to-all over the
expert axis, and DistOpt's pspec-aware sync reduces the replicated
gradients over the expert axis while the expert shards skip it. The
reference's meshes had 8 devices; here they have 4: dp x ep is (2, 2)
with one expert a rank, several experts a rank is (2, 2) with 4
experts, ep-only is (1, 4), dp x ep x tp is (1, 2, 2) and the 3-axis
hybrids are (data 1, sp 2, expert 2) and (data 1, sp 2, model 2); the
GPT cases share one model (2 blocks, d 16, 4 experts, batch 8 x 8),
its dense twin the hybrid's dense oracle. Every model starts from the
port's own init and seeded numpy batches, which the reference, in a
process of its own spawned at the same time as the ranks
(`run_both`), loads into its models: it gives each single-device run
(the oracle of its tests), and its own expert-parallel runs of the
aux-loss and the tight-capacity cases on a (2, 2) mesh of its virtual
devices, which no single-device run equals (per-shard aux means and
capacities).

Held at the reference tests' tolerance, 1e-4 on losses (relative and
absolute; 2e-2 between the bf16 wire and the fp32 one), and 2e-4 on
the gathered states after training against the single-device run's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_moe, port_moe_model,  # noqa: E402
                                 port_moe_net, run_both)
from singa_tpu_torch.models.transformer import (  # noqa: E402
    TransformerEncoderLayer, states_to_tp)

WORLD, LR, TOL, STATE_TOL = 4, 0.1, 1e-4, 2e-4
STEPS = dict(net=5, bert=4, gpt=3)


def inputs():
    """Each model's init (the port's own draws, full arrays) and batch:
    the MoeNet with 2 and 4 experts (x (16, 12) standard normal, labels
    0-3), the one-block BERT (ids (8, 8) over 50), the GPT with 4
    experts and its dense twin (tokens (8, 8) over 64)."""
    from singa_tpu_torch.models.gpt import GPT

    def states(m, x):
        m.compile([torch.from_numpy(x)], is_train=False, use_graph=False)
        return {k: v.detach().numpy().copy() for k, v in m.get_states().items()}

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 12)).astype(np.float32)
    y = (np.arange(16) % 4).astype(np.int32)
    ids = rng.integers(0, 50, (8, 8)).astype(np.int32)
    by = (np.arange(8) % 4).astype(np.int32)
    gx = rng.integers(0, 64, (8, 8)).astype(np.int32)
    gy = rng.integers(0, 64, (8, 8)).astype(np.int32)
    out = {f"net{e}": dict(init=states(port_moe_net(n_experts=e), x), x=x,
                           y=y) for e in (2, 4)}
    out["bert"] = dict(init=states(port_moe_model("bert", None), ids),
                       x=ids, y=by)
    out["gpt"] = dict(init=states(port_moe_model("gpt", None, **GPT4), gx),
                      x=gx, y=gy)
    dense = GPT(vocab_size=64, d_model=16, num_layers=2, num_heads=4,
                max_len=16, dropout=0.0, device="cpu")
    out["dense"] = dict(init=states(dense, gx), x=gx, y=gy)
    return out


def reference_side(cases):
    """singa_tpu's runs from the port's inits: each model's
    single-device losses and states after; the expert-parallel aux and
    tight-capacity runs on a (2, 2) mesh; the dense tight-capacity
    forward with expert 0 favoured."""
    import test_moe_model as ref
    from singa_tpu import opt
    from singa_tpu.models.gpt import GPT
    from singa_tpu.models.transformer import BertForClassification
    from singa_tpu.parallel import mesh as ref_mesh
    from singa_tpu.tensor import from_numpy

    def net(n_experts, cf=8.0, aux=0.0):
        return lambda ax: (ref.MoeNet(4, n_experts=n_experts, moe_axis=ax,
                                      cf=cf, aux_coef=aux),
                           opt.SGD(lr=LR, momentum=0.9))

    def bert(ax):
        return BertForClassification(
            num_classes=4, num_layers=1, d_model=16, num_heads=4,
            vocab_size=50, max_len=8, dropout=0.0, moe_experts=4,
            moe_axis=ax, moe_aux_coef=0.0,
            moe_capacity_factor=8.0), opt.SGD(lr=LR)

    def gpt(experts):
        moe = {} if experts is None else dict(moe_experts=experts,
                                               moe_capacity_factor=8.0)
        return lambda ax: (GPT(vocab_size=64, d_model=16, num_layers=2,
                               num_heads=4, max_len=16, dropout=0.0,
                               moe_axis=ax, moe_aux_coef=0.0, **moe),
                           opt.SGD(lr=LR))

    def run(make, case, steps, mesh=None):
        m, sgd = make(None if mesh is None else "expert")
        x, y = from_numpy(case["x"]), from_numpy(case["y"])
        m.set_optimizer(sgd if mesh is None else opt.DistOpt(
            sgd, mesh=mesh, axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        m.set_states(case["init"])
        losses = [float(np.asarray(m.train_one_batch(x, y)[1].data))
                  for _ in range(steps)]
        return dict(losses=losses, after={
            k: np.asarray(t.data) for k, t in m.get_states().items()})

    mesh = ref_mesh.get_mesh((2, 2), ("data", "expert"),
                             devices=jax.devices()[:4])
    out = dict(
        net2=run(net(2), cases["net2"], STEPS["net"]),
        net4=run(net(4), cases["net4"], STEPS["net"]),
        bert=run(bert, cases["bert"], STEPS["bert"]),
        gpt=run(gpt(4), cases["gpt"], STEPS["gpt"]),
        dense=run(gpt(None), cases["dense"], STEPS["gpt"]),
        aux=run(net(4, aux=0.05), cases["net4"], 3, mesh),
        tight=run(net(4, cf=1.25, aux=0.05), cases["net4"], 4, mesh))
    # the dense forward at capacity factor 1.25, expert 0 favoured
    m, _ = net(4, cf=1.25)(None)
    x = from_numpy(cases["net4"]["x"])
    m.compile([x], is_train=False, use_graph=False)
    m.set_states(cases["skew"])
    h = m.fc0(x)
    out["skew"] = dict(h=np.asarray(h.data), y=np.asarray(m.moe(h).data))
    return out


#: the GPT with 4 experts of every GPT case
GPT4 = dict(max_len=16, moe_experts=4, moe_capacity_factor=8.0)


def skewed(states):
    """The MoeNet's states with expert 0 favoured by the gate: its queue
    overflows a capacity of ceil(16 / 4 * 1.25) = 5."""
    out = dict(states)
    out["moe.w_gate"] = states["moe.w_gate"].copy()
    out["moe.w_gate"][:, 0] += 2.0
    return out


def _case(c, kind, mesh, kw, **extra):
    return dict(kind=kind, kw=kw, mesh=mesh, states=c["init"], x=c["x"],
                y=c["y"], **extra)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's runs and the one spawn of the ranks, at once."""
    c = inputs()
    c["skew"] = skewed(c["net4"]["init"])
    net2, net4 = dict(n_experts=2), dict(n_experts=4)
    mom = dict(momentum=0.9)
    cases = {
        "dp_ep": _case(c["net2"], "net", "dp_ep", net2, **mom),
        "multi": _case(c["net4"], "net", "dp_ep", net4, **mom),
        "ep_only": _case(c["net4"], "net", "ep", net4, **mom),
        "aux": _case(c["net4"], "net", "dp_ep", dict(net4, aux_coef=0.05),
                     **mom),
        "bert": _case(c["bert"], "bert", "dp_ep", {}),
        "gpt": _case(c["gpt"], "gpt", "dp_ep", GPT4),
        "plain": _case(c["net4"], "net", "dp_ep", net4, **mom,
                       dist_option="plain"),
        "half": _case(c["net4"], "net", "dp_ep", net4, **mom,
                      dist_option="half"),
        "tp": dict(_case(c["gpt"], "gpt", "dp_ep_tp",
                         dict(GPT4, tp_axis="model")),
                   states=states_to_tp(c["gpt"]["init"])),
        "tight": _case(c["net4"], "net", "dp_ep",
                       dict(net4, cf=1.25, aux_coef=0.05), **mom),
        "hyb_moe": _case(c["gpt"], "gpt", "dp_sp_ep",
                         dict(GPT4, seq_axis="sp")),
        "hyb_tp": dict(_case(c["dense"], "gpt", "dp_sp_tp", dict(
            max_len=16, seq_axis="sp", tp_axis="model")), moe_axis=None),
        "undeclared": _case(c["net4"], "net", "dp_ep", net4,
                            model_attrs=dict(moe_axis=None),
                            expect="ValueError"),
        "uneven": _case(c["net4"], "net", "ep", dict(n_experts=6),
                        expect="ValueError"),
        "zero1": _case(c["net4"], "net", "dp_ep", net4,
                       distkw=dict(shard_states=True),
                       expect="NotImplementedError"),
    }
    ref, got = run_both(
        ("test_torch_moe_model", "reference_side",
         tmp_path_factory.mktemp("reference"), dict(cases=c)),
        (_rank_moe, WORLD, tmp_path_factory.mktemp("ranks"),
         dict(cases=cases, steps=dict(STEPS), lr=LR)))
    return c, ref, got


@pytest.fixture(scope="module")
def reference(both):
    return both[1]


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def held(ranks, want, name, states=True, tol=TOL, steps=None):
    for r in range(WORLD):
        got = ranks[r][name]
        close(got["losses"][:steps], want["losses"][:steps],
              f"{name} losses, rank {r}", tol)
        if states:
            for k, v in want["after"].items():
                close(got["after"][k], v, f"{name} {k}, rank {r}",
                      STATE_TOL)


def test_dp_ep_matches_single_device(ranks, reference):
    """(2 data, 2 expert), one expert a rank."""
    held(ranks, reference["net2"], "dp_ep")


def test_ep_multiple_experts_per_chip(ranks, reference):
    """(2 data, 2 expert) with 4 experts: two a rank."""
    held(ranks, reference["net4"], "multi")
    assert ranks[0]["multi"]["w1_shape"] == (2, 16, 32)


def test_ep_only_mesh(ranks, reference):
    """(1, 4): pure expert parallelism."""
    held(ranks, reference["net4"], "ep_only")
    assert ranks[0]["ep_only"]["w1_shape"] == (1, 16, 32)


def test_expert_pspec_set():
    m = port_moe_net(moe_axis="expert")
    m.compile([torch.zeros(2, 12)], is_train=False, use_graph=False)
    assert m.moe.w1.pspec == ("expert", None, None)
    assert m.moe.b1.pspec == ("expert", None)
    assert m.moe.w2.pspec == ("expert", None, None)
    assert getattr(m.moe.w_gate, "pspec", None) is None  # replicated


def test_aux_loss_trains_and_balances_gate(ranks, reference):
    """With aux_coef > 0 the gate takes gradients; the run is the
    reference's expert-parallel run on the same mesh (per-shard aux)."""
    held(ranks, reference["aux"], "aux", states=False, steps=3)
    for r in range(WORLD):
        assert np.all(np.isfinite(ranks[r]["aux"]["losses"]))
        assert ranks[r]["aux"]["gate_moved"]


def test_bert_moe_matches_single_device(ranks, reference):
    held(ranks, reference["bert"], "bert")


def test_gpt_moe_matches_single_device(ranks, reference):
    held(ranks, reference["gpt"], "gpt")


def test_moe_half_wire_matches_plain_within_tolerance(ranks, reference):
    for r in range(WORLD):
        close(ranks[r]["half"]["losses"][:3], ranks[r]["plain"]["losses"][:3],
              f"half vs plain, rank {r}", 2e-2)
    held(ranks, reference["net4"], "plain")


def test_moe_tp_same_axis_refused_with_design_reason():
    for kw in (dict(tp_axis="model"), dict(tp_axis="model",
                                           moe_axis="model")):
        with pytest.raises(NotImplementedError, match="DISTINCT"):
            TransformerEncoderLayer(4, moe_experts=4, d_model=16,
                                    device="cpu", **kw)


def test_gpt_moe_tp_compose_matches_single_device(ranks, reference):
    """(1 data, 2 expert, 2 model): attention head-parallel over the
    model axis, the FFNs expert-parallel."""
    held(ranks, reference["gpt"], "tp", states=False)


def test_model_dense_tight_capacity_matches_switch_oracle(both):
    """The dense forward at capacity factor 1.25 with expert 0 favoured
    drops tokens exactly as the reference's layer does, to zero rows."""
    c, reference, _ = both
    want = reference["skew"]
    m = port_moe_net(cf=1.25)
    m.compile([torch.zeros(2, 12)], is_train=False, use_graph=False)
    m.set_states(c["skew"])
    m.eval()
    with torch.no_grad():
        h = m.fc0(torch.from_numpy(c["net4"]["x"]))
        got = m.moe(h).numpy()
    close(h.numpy(), want["h"], "the layer's input", 1e-5)
    close(got, want["y"], "the MoE output")
    zero = np.where(np.all(want["y"] == 0.0, axis=-1))[0]
    assert len(zero) > 0, "the case must overflow expert 0's queue"
    np.testing.assert_array_equal(got[zero], 0.0)


def test_ep_tight_capacity_trains_with_finite_losses_and_gate_motion(
        ranks, reference):
    held(ranks, reference["tight"], "tight", states=False, steps=4)
    for r in range(WORLD):
        assert np.all(np.isfinite(ranks[r]["tight"]["losses"]))
        assert ranks[r]["tight"]["gate_moved"]


def test_undeclared_model_moe_axis_raises(ranks):
    for r in range(WORLD):
        assert "moe_axis" in ranks[r]["undeclared"]["error"]


def test_uneven_experts_raise(ranks):
    for r in range(WORLD):
        assert "divide" in ranks[r]["uneven"]["error"]


def test_zero1_with_sharded_params_raises(ranks):
    for r in range(WORLD):
        assert "shard_states" in ranks[r]["zero1"]["error"]


def test_dp_sp_ep_matches_single_device(ranks, reference):
    """data x sequence x expert: the ring and the all-to-all in one
    step."""
    held(ranks, reference["gpt"], "hyb_moe")


def test_dp_sp_tp_matches_single_device(ranks, reference):
    """data x sequence x tensor: the ring owns the sp axis, the FFN is
    the Megatron pair over the model axis."""
    held(ranks, reference["dense"], "hyb_tp", states=False)
