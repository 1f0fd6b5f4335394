"""GPipe in the port (`parallel.pipeline.pipeline_apply`,
`layer.PipelineStack`, `layer.PipelineTransformerStack`,
`GPT(pp_axis=, pp_micro=)`) against the reference: the ports of
tests/test_parallel.py's two pipeline cases and of the ten cases of
tests/test_pp_model.py, with the placement of pipe-sharded stacks, the
n_blocks guard, the pspec-aware clip over the pipe axis and the pp GPT's
decode refusal.

One spawn of 4 gloo ranks (`helper_torch_parity.run_ranks`) runs every
multi-rank case: `pipeline_apply` over a pipe axis of 4 (values) and of
2 (gradients, on a (data 2, pipe 2) mesh), and the models trained by
DistOpt(SGD) over the data axis on (data 2, pipe 2) and (data 1, pipe
4), the meshes of the reference's tests cut from 8 devices to 4 (its
pp-only mesh had 8 stages of one block; here 4 stages of 2). Every
model starts from the port's own init, which the reference, in a
process of its own spawned at the same time (`run_both`), loads into
its single-device models: their losses and states are the oracle, as
in the reference's tests. Held at the reference tests' tolerances:
1e-5 on `pipeline_apply`'s values, 2e-4 on its gradients, 1e-4 on the
losses and 2e-4 on the gathered states after training.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_pipeline, port_pp_model,  # noqa: E402
                                 run_both)

WORLD, TOL, STATE_TOL = 4, 1e-4, 2e-4
MLP_SGD = dict(lr=0.1, momentum=0.9)
GPT_SGD = dict(lr=0.1)


def _states(m, x):
    m.compile([torch.from_numpy(x)], is_train=False, use_graph=False)
    return {k: v.detach().numpy().copy() for k, v in m.get_states().items()}


def inputs():
    """The schedule's arrays and each model's init (the port's own draws)
    and batch: the PipeMLP of 4 and 8 blocks (x (8, 12) standard
    normal, labels 0-3), the GPT of 4 and 8 blocks (tokens (8, 8) over
    64)."""
    rng = np.random.default_rng(0)
    arrays = dict(x=rng.standard_normal((8, 8)).astype(np.float32),
                  w=(rng.standard_normal((4, 8, 8)) * 0.5).astype(np.float32),
                  gx=rng.standard_normal((4, 4)).astype(np.float32),
                  gw=(rng.standard_normal((2, 4, 4)) * 0.5).astype(
                      np.float32))
    x = rng.standard_normal((8, 12)).astype(np.float32)
    y = (np.arange(8) % 4).astype(np.int32)
    gx = rng.integers(0, 64, (8, 8)).astype(np.int32)
    gy = rng.integers(0, 64, (8, 8)).astype(np.int32)
    models = {}
    for n in (4, 8):
        models[f"mlp{n}"] = dict(
            kind="mlp", n_blocks=n, x=x, y=y,
            states=_states(port_pp_model("mlp", "pipe", n, 4), x))
        models[f"gpt{n}"] = dict(
            kind="gpt", n_blocks=n, x=gx, y=gy,
            states=_states(port_pp_model("gpt", "pipe", n, 2), gx))
    return arrays, models


def reference_side(arrays, models):
    """singa_tpu's side: `pipeline_apply` under shard_map on 4 virtual
    devices against the sequential stages (values) and on 2 (the
    gradients of both), and the single-device runs of each model from
    the port's init: losses, and states after `keep` steps."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import test_pp_model as ref
    from singa_tpu import opt
    from singa_tpu.models.gpt import GPT
    from singa_tpu.parallel import pipeline
    from singa_tpu.tensor import from_numpy

    def stage(p, h):
        return jnp.tanh(h @ p[0])

    def seq(x, w):
        h = x
        for s in range(w.shape[0]):
            h = jnp.tanh(h @ w[s])
        return h

    out = {"values": {}}
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    for n_micro in (2, 4):
        def f(x, wl, n_micro=n_micro):
            y, valid = pipeline.pipeline_apply(stage, wl, x, "pipe", n_micro)
            return jax.lax.psum(y * valid, "pipe")

        out["values"][n_micro] = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P(), P("pipe")), out_specs=P(),
            check_vma=False))(arrays["x"], arrays["w"]))
    out["seq"] = np.asarray(seq(arrays["x"], arrays["w"]))
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("pipe",))
    gx = jnp.asarray(arrays["gx"])

    def loss_pp(w):
        f = jax.shard_map(
            lambda x, wl: jax.lax.psum(
                (lambda yv: yv[0] * yv[1])(pipeline.pipeline_apply(
                    stage, wl, x, "pipe", 2)), "pipe"),
            mesh=mesh2, in_specs=(P(), P("pipe")), out_specs=P(),
            check_vma=False)
        return jnp.sum(f(gx, w) ** 2)

    out["g_pp"] = np.asarray(jax.grad(loss_pp)(arrays["gw"]))
    out["g_seq"] = np.asarray(jax.grad(
        lambda w: jnp.sum(seq(gx, w) ** 2))(arrays["gw"]))

    def run(c, steps, keep, sgd):
        if c["kind"] == "mlp":
            m = ref.PipeMLP(num_classes=4, n_blocks=c["n_blocks"],
                            pipe_axis="pipe", n_micro=4)
        else:
            m = GPT(vocab_size=64, d_model=16, num_layers=c["n_blocks"],
                    num_heads=4, max_len=16, dropout=0.0, pp_axis="pipe",
                    pp_micro=2)
        x, y = from_numpy(c["x"]), from_numpy(c["y"])
        m.set_optimizer(opt.SGD(**sgd))
        m.compile([x], is_train=True, use_graph=True)
        m.set_states(c["states"])
        losses, after = [], None
        for i in range(steps):
            losses.append(float(np.asarray(m.train_one_batch(x, y)[1].data)))
            if i + 1 == keep:
                after = {k: np.asarray(t.data)
                         for k, t in m.get_states().items()}
        return dict(losses=losses, after=after)

    out["mlp4"] = run(models["mlp4"], 10, 5, MLP_SGD)
    out["mlp8"] = run(models["mlp8"], 5, 5, MLP_SGD)
    out["clip"] = run(models["mlp4"], 3, 3, dict(MLP_SGD, clip_norm=0.05))
    out["gpt4"] = run(models["gpt4"], 8, 4, GPT_SGD)
    out["gpt8"] = run(models["gpt8"], 4, 4, GPT_SGD)
    return out


def _case(c, mesh, steps, sgd, n_micro, **extra):
    return dict(kind=c["kind"], n_blocks=c["n_blocks"], mesh=mesh,
                n_micro=n_micro, states=c["states"], x=c["x"], y=c["y"],
                steps=steps, sgd=sgd, **extra)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's runs and the one spawn of the ranks, at once."""
    arrays, models = inputs()
    mlp4, mlp8 = models["mlp4"], models["mlp8"]
    cases = {
        "mlp_dp_pp": _case(mlp4, "dp_pp", 5, MLP_SGD, 4),
        "mlp_pp": _case(mlp8, "pp", 5, MLP_SGD, 4),
        "micro3": _case(mlp8, "pp", 1, MLP_SGD, 3, expect="ValueError"),
        "uneven": dict(_case(mlp8, "pp", 1, MLP_SGD, 4, expect="ValueError"),
                       n_blocks=6, states={}),
        "clip": _case(mlp4, "dp_pp", 3, dict(MLP_SGD, clip_norm=0.05), 4),
        "gpt_dp_pp": _case(models["gpt4"], "dp_pp", 4, GPT_SGD, 2),
        "gpt_pp": _case(models["gpt8"], "pp", 4, GPT_SGD, 2),
    }
    ref, got = run_both(
        ("test_torch_pipeline", "reference_side",
         tmp_path_factory.mktemp("reference"),
         dict(arrays=arrays, models=models)),
        (_rank_pipeline, WORLD, tmp_path_factory.mktemp("ranks"),
         dict(arrays=arrays, cases=cases)))
    return models, ref, got


@pytest.fixture(scope="module")
def reference(both):
    return both[1]


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def held(ranks, want, name, steps=None, states=True):
    for r in range(WORLD):
        got = ranks[r][name]
        close(got["losses"], want["losses"][:steps or len(got["losses"])],
              f"{name} losses, rank {r}")
        if states:
            for k, v in want["after"].items():
                close(got["after"][k], v, f"{name} {k}, rank {r}", STATE_TOL)


def single_device(kind, c, steps, sgd):
    """The port's own single-device run (the stack's loop) from the same
    init."""
    from singa_tpu_torch import opt

    m = port_pp_model(kind, "pipe", c["n_blocks"], 4 if kind == "mlp" else 2)
    tx = torch.from_numpy(c["x"])
    tx = tx.long() if kind == "gpt" else tx
    ty = torch.from_numpy(c["y"]).long()
    m.set_optimizer(opt.SGD(**sgd))
    m.compile([tx], is_train=True, use_graph=True)
    m.set_states(c["states"])
    return [m.train_one_batch(tx, ty)[1].item() for _ in range(steps)]


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_matches_sequential(ranks, reference, n_micro):
    """World 4: the psum'd pipeline output is the sequential stages', on
    every rank, as the reference's is."""
    for r in range(WORLD):
        got = ranks[r]["values"][n_micro]
        close(got, reference["seq"], f"rank {r}", 1e-5)
        close(got, reference["values"][n_micro], f"rank {r} vs ref", 1e-5)


def test_pipeline_grads_flow(ranks, reference):
    """World 2 (the pipe axis of a (2, 2) mesh): each stage's gradient
    through the schedule is the sequential one, and the reference's."""
    g = np.zeros_like(reference["g_seq"])
    for r in range(WORLD):
        stage, grad = ranks[r]["grad"]
        if r < 2:
            g[stage] = grad[0]
        else:  # the other data group runs the same pipeline
            close(grad[0], g[stage], f"rank {r} vs its data twin", 1e-6)
    close(g, reference["g_seq"], "sequential", 2e-4)
    close(g, reference["g_pp"], "the reference's pipeline", 2e-4)


def test_pp_matches_single_device(ranks, reference):
    """(data 2, pipe 2), 4 blocks: 2 a stage, microbatches of 1 row."""
    held(ranks, reference["mlp4"], "mlp_dp_pp", steps=5)


def test_pp_only_mesh(ranks, reference):
    """(data 1, pipe 4), 8 blocks: 2 a stage. Losses, as the reference's
    test holds them: 8 residual blocks at lr 0.1 with momentum 0.9 grow
    the input layer's weights to ~2e3 in 5 steps, where fp32 rounding
    alone moves them by more than the state tolerance."""
    held(ranks, reference["mlp8"], "mlp_pp", states=False)


def test_pp_stage_weights_sharded(ranks):
    """The stacked stage weights carry the pipe pspec, and a placed rank
    holds its n_blocks/world blocks and their momentum slots."""
    for r in range(WORLD):
        got = ranks[r]["mlp_dp_pp"]
        assert got["pspecs"]["W"] == ("pipe", None, None)
        assert got["pspecs"]["b"] == ("pipe", None)
        assert got["local_shape"] == (2, 16, 16)
        assert got["slots"]["stack.W//momentum"] == (2, 16, 16)
        assert got["slots"]["stack.b//momentum"] == (2, 16)
        assert got["slots"]["head.W//momentum"] == (16, 4)
        assert ranks[r]["mlp_pp"]["local_shape"] == (2, 16, 16)


def test_get_states_gathers_the_blocks(ranks, both):
    """`get_states` all-gathers each rank's blocks into the full stack."""
    models = both[0]
    for r in range(WORLD):
        for name, model in (("mlp_dp_pp", "mlp4"), ("mlp_pp", "mlp8"),
                            ("gpt_pp", "gpt8")):
            after = ranks[r][name]["after"]
            for k, v in models[model]["states"].items():
                assert after[k].shape == v.shape, (name, k)


def test_parameter_bytes_are_the_shard(ranks, both):
    """`step_memory_analysis`'s parameter bytes are what the rank holds:
    a quarter of the GPT's stacked blocks on the pp-only mesh."""
    full = sum(v.size * 4 for v in both[0]["gpt8"]["states"].values())
    for r in range(WORLD):
        got = ranks[r]["gpt_pp"]
        assert got["parameter_bytes"] == got["local_bytes"] < full


def test_pp_single_device_is_scan(reference, both):
    """Outside the pipe axis the stacked weights run as a loop over the
    blocks; the loss falls over 10 steps, as the reference's does."""
    got = single_device("mlp", both[0]["mlp4"], 10, MLP_SGD)
    close(got, reference["mlp4"]["losses"], "single-device losses")
    assert got[-1] < got[0]


def test_pp_microbatch_divisibility(ranks):
    for r in range(WORLD):
        assert "micro" in ranks[r]["micro3"]["error"]


def test_n_blocks_guard(ranks):
    """6 blocks over a pipe axis of 4: the reference's refusal, before
    any block is placed."""
    for r in range(WORLD):
        msg = ranks[r]["uneven"]["error"]
        assert "PipelineStack(n_blocks=6) does not divide evenly over the " \
               "'pipe' mesh axis (size 4)" in msg


def test_clip_norm_on_the_pipe_axis_matches_single_device(ranks, reference):
    """F10's pspec-aware clip sums the pipe-sharded stack's square sums
    over the pipe axis: the clipped pp run equals the single device's."""
    held(ranks, reference["clip"], "clip")
    clipped = ranks[0]["clip"]["losses"]
    plain = ranks[0]["mlp_dp_pp"]["losses"][:3]
    assert not np.allclose(clipped[1:], plain[1:], rtol=1e-4)


def test_gpt_pp_matches_single_device(ranks, reference):
    """A GPT whose decoder is a PipelineTransformerStack on (data 2, pipe
    2): losses and gathered states equal the single device's."""
    held(ranks, reference["gpt4"], "gpt_dp_pp", steps=4)


def test_gpt_pp_only_mesh(ranks, reference):
    held(ranks, reference["gpt8"], "gpt_pp")


def test_gpt_pp_block_weights_sharded(ranks):
    for r in range(WORLD):
        got = ranks[r]["gpt_dp_pp"]
        assert got["pspecs"]["w_qkv"] == ("pipe", None, None)
        assert got["pspecs"]["ln2_o"] == ("pipe", None)
        assert got["local_shape"] == (2, 16, 48)
        assert got["slots"] == {}  # plain SGD keeps no slots


def test_gpt_pp_trains(reference, both):
    got = single_device("gpt", both[0]["gpt4"], 8, GPT_SGD)
    close(got, reference["gpt4"]["losses"], "single-device losses")
    assert got[-1] < got[0]


def test_world4_two_micro_does_not_hang(ranks):
    """Pipe 4 with 2 microbatches: ranks idle on most ticks and rank 0
    drops the buffers it receives, yet every rank's backward posts the
    same exchanges, so the spawn ends within its deadline with finite
    losses."""
    for r in range(WORLD):
        assert np.all(np.isfinite(ranks[r]["gpt_pp"]["losses"]))


@pytest.mark.parametrize("kw,match", [
    (dict(tp_axis="model"), "pp_axis"),
    (dict(seq_axis="sp"), "plain data parallelism"),
    (dict(moe_experts=4), "plain data parallelism"),
    (dict(dropout=0.1), "dropout"),
    (dict(scan_blocks=True), "scan_blocks"),
])
def test_gpt_pp_conflicts_raise(kw, match):
    from singa_tpu_torch.models.gpt import GPT

    kw.setdefault("dropout", 0.0)
    with pytest.raises(NotImplementedError, match=match):
        GPT(vocab_size=64, d_model=16, num_layers=2, num_heads=4,
            max_len=16, pp_axis="pipe", device="cpu", **kw)


def test_pp_decode_refusal_points_at_serving():
    """A pipelined GPT refuses cached decoding, naming the serving path
    (the reference's tests/test_gpt.py case)."""
    from singa_tpu_torch.models.gpt import gpt_small

    m = gpt_small(pp_axis="pipe", dropout=0.0, device="cpu")
    with pytest.raises(NotImplementedError, match="serving|ServingEngine"):
        m.generate(np.arange(4, dtype=np.int32), n_new=2, window=16)


def test_pp_states_load_into_the_scanned_gpt(both):
    """The pipelined stack keeps the scanned stack's names and layouts,
    so a pp model's states load into `GPT(scan_blocks=True)` (the
    decoder the refusal above points at) and score the same."""
    from singa_tpu_torch.models.gpt import GPT

    c = both[0]["gpt4"]
    scanned = GPT(vocab_size=64, d_model=16, num_layers=4, num_heads=4,
                  max_len=16, dropout=0.0, scan_blocks=True, device="cpu")
    scanned.set_states(c["states"])
    pp = port_pp_model("gpt", "pipe", 4, 2)
    pp.set_states(c["states"])
    x = torch.from_numpy(c["x"]).long()
    with torch.no_grad():
        close(scanned.eval()(x).numpy(), pp.eval()(x).numpy(),
              "scanned vs pipelined logits", 1e-5)
