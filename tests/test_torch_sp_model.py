"""Model-level sequence parallelism of the port against singa_tpu: the
seven cases of the reference's `tests/test_sp_model.py` and the scanned
stack's pipelined ring (`tests/test_scan_overlap.py::
test_overlap_seq_matches_unrolled`).

`GPT(seq_axis=)` and `BertForClassification(seq_axis=)` train through
the ordinary `train_one_batch` over a (data, seq) mesh of 4 gloo ranks
(one spawn for the file, `helper_torch_parity.run_ranks`): the
distributed step cuts the global batch's rows over the data axis and
the token arguments' dim 1 over the seq axis, the attention runs as a
ring (or Ulysses) over the seq axis, and DistOpt averages the gradients
over the seq axis before its data-axis sync. Each run carries the
reference model's seeded weights and is held:

- against the port's own single-device run of the same weights and
  batch (plain SGD, no mesh);
- against singa_tpu's single-device losses from those weights, computed
  in a process of its own (`helper_torch_parity.run_reference`),

at the reference's tolerance, 2e-4 (relative and absolute). The bf16
wire is held to the fp32 one at the reference's 5e-2. The scanned
stack's overlap case is held, as the reference holds it, to the
unrolled single-device decoder on the same weights at 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import (_rank_many, port_sp_model, run_ranks,  # noqa: E402
                                 run_reference, sp_train)
from singa_tpu_torch import layer, opt  # noqa: E402
from singa_tpu_torch.models.gpt import GPT, unstack_params  # noqa: E402

WORLD = 4
GPT_KW = dict(vocab_size=32, d_model=32, num_layers=2, num_heads=4,
              max_len=16, dropout=0.0)
#: a GPT whose head dim (32) the flash kernels take, for ring_flash
FLASH_KW = dict(vocab_size=32, d_model=64, num_layers=2, num_heads=2,
                max_len=16, dropout=0.0)
BERT_KW = dict(num_classes=4, vocab_size=64, d_model=32, num_layers=2,
               num_heads=4, max_len=16, dropout=0.0)
#: tests/helper_scan3d.py's GPT
SCAN_KW = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4,
               max_len=32, dropout=0.0)
GPT_STEPS, BERT_STEPS, SCAN_STEPS = 4, 3, 3
TOL = 2e-4


def gpt_batch(t=16):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 32, (4, t)).astype(np.int64),
            rng.integers(0, 32, (4, t)).astype(np.int64))


def bert_batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, 64, (4, 16)).astype(np.int64),
            (np.arange(4) % 4).astype(np.int64))


def scan_batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 64, (8, 16)).astype(np.int64),
            rng.integers(0, 64, (8, 16)).astype(np.int64))


def _ref_run(kind, kw, x, y, steps, lr, momentum):
    """The reference's single-device run from `set_seed(0)`: its
    initial parameters and losses."""
    from singa_tpu import opt as ref_opt
    from singa_tpu import tensor

    tensor.set_seed(0)
    if kind == "gpt":
        from singa_tpu.models.gpt import GPT as RefGPT

        m = RefGPT(**kw)
    else:
        from singa_tpu.models.transformer import BertForClassification

        m = BertForClassification(**kw)
    m.set_optimizer(ref_opt.SGD(lr=lr, momentum=momentum))
    tx = tensor.from_numpy(x.astype(np.int32))
    ty = tensor.from_numpy(y.astype(np.int32))
    m.compile([tx], is_train=True, use_graph=True)
    params = {k: np.asarray(v.data) for k, v in m.get_params().items()}
    losses = [float(np.asarray(m.train_one_batch(tx, ty)[1].data))
              for _ in range(steps)]
    return params, losses


def reference_side():
    """singa_tpu's single-device runs of the three models (run in a
    process of its own)."""
    return {"gpt": _ref_run("gpt", GPT_KW, *gpt_batch(), GPT_STEPS, 0.1,
                            0.9),
            "flash": _ref_run("gpt", FLASH_KW, *gpt_batch(), GPT_STEPS,
                              0.1, 0.9),
            "bert": _ref_run("bert", BERT_KW, *bert_batch(), BERT_STEPS,
                             0.05, 0.0)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_sp_model", "reference_side",
                         tmp_path_factory.mktemp("reference"))


def scan_params():
    """The scanned GPT's own seeded parameters (the port's init)."""
    m = GPT(**SCAN_KW, scan_blocks=True, device="cpu")
    return {k: v.detach().numpy().copy() for k, v in m.get_params().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    """One spawn of 4 gloo ranks for the file: every case."""
    gpt_p, flash_p, bert_p = (reference[k][0] for k in ("gpt", "flash",
                                                        "bert"))
    x, y = gpt_batch()
    gpt = dict(kind="gpt", params=gpt_p, kw=GPT_KW, x=x, y=y,
               steps=GPT_STEPS, lr=0.1, momentum=0.9)
    calls = [
        ("dp2_sp2", "_rank_sp", dict(gpt, mesh_shape=(2, 2))),
        ("dp1_sp4", "_rank_sp", dict(gpt, mesh_shape=(1, 4))),
        ("ulysses", "_rank_sp", dict(gpt, mesh_shape=(2, 2),
                                     kw=dict(GPT_KW, seq_impl="ulysses"))),
        ("half", "_rank_sp", dict(gpt, mesh_shape=(2, 2),
                                  dist_option="half")),
        ("ring_flash", "_rank_sp", dict(
            gpt, params=flash_p, mesh_shape=(2, 2),
            kw=dict(FLASH_KW, ring_flash=True, remat=True))),
        ("undivisible", "_rank_sp", dict(
            gpt, kw=dict(GPT_KW, max_len=18), x=gpt_batch(18)[0],
            y=gpt_batch(18)[1], params=dict(
                gpt_p, **{"pos.table": np.zeros((18, 32), np.float32)}),
            mesh_shape=(1, 4), steps=1)),
        ("bert", "_rank_sp", dict(kind="bert", params=bert_p, kw=BERT_KW,
                                  x=bert_batch()[0], y=bert_batch()[1],
                                  steps=BERT_STEPS, lr=0.05,
                                  mesh_shape=(2, 2))),
    ]
    sx, sy = scan_batch()
    for remat in ("none", "per_block", "dots_saveable"):
        calls.append((f"scan_{remat}", "_rank_sp", dict(
            kind="gpt", params=scan_params(), x=sx, y=sy, steps=SCAN_STEPS,
            lr=0.1, mesh_shape=(2, 2), seq_axis="sp",
            kw=dict(SCAN_KW, scan_blocks=True, remat_policy=remat,
                    overlap=True))))
    return run_ranks(_rank_many, WORLD, tmp_path_factory.mktemp("ranks"),
                     timeout=110, calls=calls)


def single(kind, params, kw, x, y, steps, lr, momentum=0.0):
    """The port's single-device run of the same weights."""
    m = port_sp_model(kind, params, **kw)
    return sp_train(m, opt.SGD(lr=lr, momentum=momentum), x, y, steps)


def same_on_every_rank(runs, key):
    losses = [r[key]["losses"] for r in runs]
    for other in losses[1:]:
        np.testing.assert_allclose(other, losses[0], rtol=1e-6, atol=1e-6)
    return losses[0]


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("key", ["dp2_sp2", "dp1_sp4", "ulysses"])
def test_gpt_seq_parallel_matches_single_device(runs, reference, key):
    """test_gpt_seq_parallel_matches_single_device, test_gpt_seq_only_mesh
    and test_gpt_ulysses_model_path: (2, 2) and (1, 4) rings, (2, 2)
    Ulysses."""
    params, ref_losses = reference["gpt"]
    sp = same_on_every_rank(runs, key)
    port = single("gpt", params, GPT_KW, *gpt_batch(), GPT_STEPS, 0.1, 0.9)
    close(sp, port, "against the port's single-device run")
    close(sp, ref_losses, "against singa_tpu's single-device run")
    close(port, ref_losses, "the port's single device against singa_tpu's")


def test_gpt_ring_flash_matches_single_device(runs, reference):
    """ring_flash=True: every ring block through the head-split flash
    kernels' plain versions, merged by lse."""
    params, ref_losses = reference["flash"]
    sp = same_on_every_rank(runs, "ring_flash")
    port = single("gpt", params, FLASH_KW, *gpt_batch(), GPT_STEPS, 0.1,
                  0.9)
    close(sp, port, "against the port's single-device run")
    close(sp, ref_losses, "against singa_tpu's single-device run")


def test_gpt_sp_half_wire(runs):
    plain = same_on_every_rank(runs, "dp2_sp2")
    half = same_on_every_rank(runs, "half")
    np.testing.assert_allclose(plain, half, atol=5e-2, rtol=5e-2)
    assert not np.array_equal(plain, half)


def test_gpt_sp_grad_axes_registered(runs):
    for r in runs:
        assert r["dp2_sp2"]["grad_axes"] == ["data", "seq"]


def test_seq_arg_validation(runs):
    for r in runs:
        assert "divisible" in r["undivisible"]["error"]
        assert "'seq' axis size 4" in r["undivisible"]["error"]


def test_bert_seq_parallel_matches_single_device(runs, reference):
    """Token argument sharded, per-example labels data-sharded only, CLS
    broadcast from shard 0."""
    params, ref_losses = reference["bert"]
    sp = same_on_every_rank(runs, "bert")
    x, y = bert_batch()
    port = single("bert", params, BERT_KW, x, y, BERT_STEPS, 0.05)
    close(sp, port, "against the port's single-device run")
    close(sp, ref_losses, "against singa_tpu's single-device run")


@pytest.mark.parametrize("remat", ["none", "per_block", "dots_saveable"])
def test_overlap_seq_matches_unrolled(runs, remat):
    """The scanned stack's pipelined ring on (data 2, sp 2) against the
    unrolled single-device decoder on the same weights."""
    sharded = same_on_every_rank(runs, f"scan_{remat}")
    oracle = single("gpt", unstack_params(scan_params()), SCAN_KW,
                    *scan_batch(), SCAN_STEPS, 0.1)
    np.testing.assert_allclose(sharded, oracle, atol=1e-4, rtol=1e-4)


def test_declared_schedule_counts_the_ring_hops():
    from singa_tpu_torch import layer
    from singa_tpu_torch.parallel import mesh as mesh_module

    mesh = mesh_module.get_mesh((1, 1), ("data", "sp"))
    serial = layer.ScanTransformerStack(2, 4, seq_axis="sp", d_model=32,
                                        device="cpu")
    overlapped = layer.ScanTransformerStack(2, 4, seq_axis="sp",
                                            overlap=True, d_model=32,
                                            device="cpu")
    want = {"n_blocks": 2, "per_block": {("ppermute", "sp"): 2}}
    assert serial.declared_schedule(mesh) == want
    assert overlapped.declared_schedule(mesh) == want
    assert layer.ScanTransformerStack(
        2, 4, d_model=32, device="cpu").declared_schedule(mesh) == {
            "n_blocks": 2, "per_block": {}}


def test_outside_the_axis_the_models_compute_the_dense_function():
    """The seq options change nothing outside a distributed step: the
    same weights give the dense models' logits bitwise."""
    params = scan_params()
    x = torch.from_numpy(scan_batch()[0])
    dense = port_sp_model("gpt", params, **SCAN_KW, scan_blocks=True)
    for kw in (dict(seq_axis="sp"), dict(seq_axis="sp", overlap=True)):
        m = port_sp_model("gpt", params, **SCAN_KW, scan_blocks=True, **kw)
        with torch.no_grad():
            assert torch.allclose(m(x), dense(x), rtol=1e-6, atol=1e-6)
    unrolled = unstack_params(params)
    dense = port_sp_model("gpt", unrolled, **SCAN_KW)
    for kw in (dict(seq_axis="sp", ring_flash=True),
               dict(seq_axis="sp", seq_impl="ulysses", remat=True)):
        m = port_sp_model("gpt", unrolled, **SCAN_KW, **kw)
        with torch.no_grad():
            assert torch.equal(m(x), dense(x))


@pytest.mark.parametrize("kw,item", [
    # GPipe is ported (tests/test_torch_pipeline.py): what raises now are
    # the reference's own refusals of pp_axis beside other axes
    (dict(tp_axis="model", pp_axis="pipe"), "plain data parallelism"),
    (dict(moe_experts=4, pp_axis="pipe"), "plain data parallelism"),
    (dict(pp_axis="pipe"), None),
    (dict(scan_blocks=True, zero3_axis="data", pp_axis="pipe"),
     "scan_blocks"),
])
def test_the_unported_axes_still_raise(kw, item):
    if item is None:  # plain pp_axis builds the pipelined decoder
        m = GPT(**GPT_KW, device="cpu", **kw)
        assert isinstance(m.decoder, layer.PipelineTransformerStack)
        assert m.decoder.pipe_axis == "pipe"
        return
    with pytest.raises(NotImplementedError, match=item):
        GPT(**GPT_KW, device="cpu", **kw)
