"""The native training step on the port (singa_tpu_torch.native:
`HloGraphBuilder` over `native/hlo_core.cc`, `hlo_bridge`, the StableHLO
runtime `hlo_runtime`) against the reference's (singa_tpu.native,
tests/test_hlo_native.py's CPU tests), on the CPU.

The reference's side runs in a process of its own
(`helper_torch_parity.run_reference`) and executes its emitted text
through jax's `compile_and_load` on the CPU, as tests/test_hlo_native.py
does:

- the port's text equals the reference's character for character: the
  tape forward (Linear + bias, ReLU, Linear + bias on 4 x 8) and the SGD
  training step of `MLP(24, 10)` on 16 x 12 at 1 and 2 replicas, on the
  fp32 and the bf16 wire;
- the runtime's outputs equal jax's for the builder's forward MLP, the
  unary ops, transpose, a one-replica all_reduce and the bf16
  `reduce_max` literal (`dense<0xFF80>`);
- the reference MLP's seeded weights, carried into the port's with
  `load_singa_tpu_params`, give both lowerings equal arguments; three
  native steps (6 `dot_general`: 2 forward, 4 backward) match the port's
  eager SGD loop and the reference's native losses within rtol 2e-4,
  atol 2e-5;
- an op outside the lowering (`Gelu`, `LayerNormalization`, `Softmax`)
  raises by name, a shape error from C++ surfaces as ValueError, the
  runtime refuses an op outside its vocabulary naming its line and a
  module of 2 replicas in a process of one, and runs an edited text as
  edited;
- `autograd.TapeRecorder` leaves the forward's values and the Device
  seam's op count as they are, and no export trace starts inside it;
- no fallback: the runtime is on the card unless asked for the CPU, and
  a missing or refusing g++ raises `NativeBuildError`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from helper_torch_parity import run_reference
from singa_tpu_torch import autograd, native, opt
from singa_tpu_torch.models import MLP
from singa_tpu_torch.native import hlo_bridge
from singa_tpu_torch.native.hlo_runtime import HloRuntime

#: the training comparison's shapes (tests/test_hlo_native.py:207)
STEPS, BATCH, IN_DIM, LR = 3, 16, 12, 0.1
#: the step texts compared: (replicas, wire)
STEP_TEXTS = [(1, "fp32"), (1, "bf16"), (2, "fp32"), (2, "bf16")]


def batches():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((STEPS, BATCH, IN_DIM)).astype(np.float32)
    onehots = np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (STEPS, BATCH))]
    return x, onehots


def operands():
    """The builder tests' inputs: (forward MLP args, unary input,
    transpose input, all_reduce input, bf16 reduce_max input as f32)."""
    rng = np.random.default_rng(0)
    mlp = [rng.standard_normal(s).astype(np.float32)
           for s in ((4, 8), (8, 16), (16,), (16, 3), (3,))]
    unary = np.linspace(-2, 2, 12, dtype=np.float32).reshape(2, 6)
    tr = np.arange(15, dtype=np.float32).reshape(3, 5)
    ar = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    rmax = np.linspace(-4, 4, 32, dtype=np.float32).reshape(4, 8)
    return mlp, unary, tr, ar, rmax


def builder_texts(b_cls):
    """{name: module text} of the builder tests, from either package's
    builder (the same calls)."""
    out = {}
    b = b_cls()
    x, w1, b1 = b.param((4, 8)), b.param((8, 16)), b.param((16,))
    w2, b2 = b.param((16, 3)), b.param((3,))
    h = b.relu(b.add_bias(b.dot(x, w1), b1))
    out["mlp"] = b.emit(b.add_bias(b.dot(h, w2), b2))
    b.close()
    b = b_cls()
    x = b.param((2, 6))
    out["unary"] = b.emit(b.mul(b.tanh(x), b.logistic(x)))
    b.close()
    b = b_cls()
    out["transpose"] = b.emit(b.transpose(b.param((3, 5))))
    b.close()
    b = b_cls()
    out["all_reduce"] = b.emit(b.all_reduce_sum(b.param((2, 4)), 1))
    b.close()
    b = b_cls()
    out["reduce_max_bf16"] = b.emit(b.reduce_max(b.param_t((4, 8), "bf16"),
                                                 1))
    b.close()
    return out


def reference_side():
    """The reference's texts, its jax outputs, its MLP's seeded weights,
    its step's arguments and its native losses."""
    import ml_dtypes
    from jax._src import xla_bridge

    from singa_tpu import autograd as rag
    from singa_tpu import device, layer, model, models
    from singa_tpu import native as rnative
    from singa_tpu import tensor as tm
    from singa_tpu.native.hlo_bridge import (compile_stablehlo,
                                             lower_tape, lower_train_step)
    from singa_tpu.tensor import Tensor

    assert rnative.lib() is not None
    cpu = xla_bridge.get_backend("cpu")
    devs = cpu.local_devices()

    def run(text, args, bf16=False):
        exe = compile_stablehlo(cpu, text, devs[:1])
        bufs = [cpu.buffer_from_pyval(
            np.asarray(a, np.float32).astype(ml_dtypes.bfloat16) if bf16
            else np.asarray(a, np.float32), devs[0]) for a in args]
        return [np.asarray(o, np.float32) for o in exe.execute(bufs)]

    texts = builder_texts(rnative.HloGraphBuilder)
    mlp, unary, tr, ar, rmax = operands()
    outs = {"mlp": run(texts["mlp"], mlp)[0],
            "unary": run(texts["unary"], [unary])[0],
            "transpose": run(texts["transpose"], [tr])[0],
            "all_reduce": run(texts["all_reduce"], [ar])[0],
            "reduce_max_bf16": run(texts["reduce_max_bf16"], [rmax],
                                   bf16=True)[0]}

    class M(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(3)

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

    rag.set_autocast(False)
    rag.training = True
    tm.set_seed(0)
    m = M()
    m(Tensor(data=mlp[0]))  # build the layers
    m.set_params(tape_params())
    tape_text, _ = lower_tape(m(Tensor(data=mlp[0])))

    x, onehots = batches()
    dev = device.create_cpu_device()
    step_texts, losses = {}, None
    for n, wire in STEP_TEXTS:
        tm.set_seed(3)
        mlp_m = models.MLP(perceptron_size=24, num_classes=10)
        mlp_m.dropout.training = False
        x0 = Tensor(data=x[0], device=dev)
        loss = rag.softmax_cross_entropy(mlp_m.forward(x0), onehots[0])
        params = {k: np.asarray(v.data, np.float32)
                  for k, v in mlp_m.get_params().items()}
        step = lower_train_step(loss, list(mlp_m.get_params().values()), LR,
                                inputs=[x0], n_replicas=n, wire=wire)
        step_texts[n, wire] = step.text
        if n == 1 and wire == "fp32":
            step_args = [np.asarray(a, np.float32) for a in step.args]
            args = list(step_args)
            losses = []
            for i in range(STEPS):
                args[step.input_idx[0]] = x[i]
                args[step.target_idx] = onehots[i]
                got = run(step.text, args)
                losses.append(float(got[0]))
                for slot, new in zip(step.param_idx, got[1:]):
                    args[slot] = new
    return {"builder": texts, "outs": outs, "tape": tape_text,
            "steps": step_texts, "losses": losses, "params": params,
            "args": step_args}


def tape_params():
    """The tape test's weights (fc1 8 -> 16, fc2 16 -> 3), seeded."""
    rng = np.random.default_rng(5)
    return {"fc1.W": rng.standard_normal((8, 16)).astype(np.float32),
            "fc1.b": rng.standard_normal(16).astype(np.float32),
            "fc2.W": rng.standard_normal((16, 3)).astype(np.float32),
            "fc2.b": rng.standard_normal(3).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__name__, "reference_side",
                         tmp_path_factory.mktemp("ref"))


def _recorded_step(n=1, wire="fp32", params=None):
    """(the port's MLP, its NativeTrainStep), at `params` (the
    reference's names) or the port's seeded draws."""
    from singa_tpu_torch.model import load_singa_tpu_params

    x, onehots = batches()
    m = MLP(24, 10, in_features=IN_DIM, device="cpu",
            generator=torch.Generator().manual_seed(3))
    if params is not None:
        load_singa_tpu_params(m, params)
    m.dropout.training = False
    x0 = torch.from_numpy(x[0])
    with autograd.TapeRecorder():
        loss = autograd.softmax_cross_entropy(m.forward(x0), onehots[0])
    return m, hlo_bridge.lower_train_step(
        loss, list(m.get_params().values()), LR, inputs=[x0],
        n_replicas=n, wire=wire)


def _tape_model():
    from singa_tpu_torch import layer, model
    from singa_tpu_torch.model import load_singa_tpu_params

    class M(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(16, in_features=8, device="cpu")
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(3, in_features=16, device="cpu")

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

    m = M()
    load_singa_tpu_params(m, tape_params())
    return m


def test_tape_text_equals_the_reference(reference):
    m = _tape_model()
    x = torch.from_numpy(operands()[0][0])
    with autograd.TapeRecorder():
        out = m(x)
    text, leaves = hlo_bridge.lower_tape(out)
    assert text == reference["tape"]
    assert text.count("stablehlo.dot_general") == 2
    got = HloRuntime("cpu")
    h = got.compile_mlir(text)
    np.testing.assert_allclose(got.run_f32(h, leaves, tuple(out.shape)),
                               out.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hlo_bridge.run_native(out, device="cpu"),
                               out.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,wire", STEP_TEXTS)
def test_step_text_equals_the_reference(reference, n, wire):
    _, step = _recorded_step(n, wire, reference["params"])
    assert step.text == reference["steps"][n, wire]
    for got, want in zip(step.args, reference["args"]):
        np.testing.assert_array_equal(got, want)
    assert (step.param_idx, step.input_idx, step.target_idx) == (
        [1, 2, 3, 4], [0], 5)
    assert step.declared_hlo_census() == {"all_reduce": 4 if n > 1 else 0}
    assert step.text.count('"stablehlo.all_reduce"') == (4 if n > 1 else 0)
    assert f"mhlo.num_replicas = {n} : i32" in step.text
    assert ("tensor<12x24xbf16>" in step.text) == (n > 1 and wire == "bf16")


@pytest.mark.parametrize("name", ["mlp", "unary", "transpose", "all_reduce",
                                  "reduce_max_bf16"])
def test_runtime_outputs_equal_jax(reference, name):
    texts = builder_texts(native.HloGraphBuilder)
    assert texts[name] == reference["builder"][name]
    mlp, unary, tr, ar, rmax = operands()
    args = {"mlp": mlp, "unary": [unary], "transpose": [tr],
            "all_reduce": [ar], "reduce_max_bf16": [rmax]}[name]
    rt = HloRuntime("cpu")
    h = rt.compile_mlir(texts[name])
    want = reference["outs"][name]
    got = rt.run_f32(h, args, want.shape)
    if name == "mlp":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif name == "unary":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:  # moves and exact reductions
        np.testing.assert_array_equal(got, want)
    if name == "reduce_max_bf16":
        assert "dense<0xFF80>" in texts[name]
        rounded = torch.from_numpy(rmax).bfloat16().float().numpy()
        np.testing.assert_array_equal(got, rounded.max(1))


def test_three_native_steps_match_the_eager_loop_and_the_reference(
        reference):
    m, step = _recorded_step(params=reference["params"])
    assert "stablehlo.reduce" in step.text and "stablehlo.select" in step.text
    assert step.text.count("stablehlo.dot_general") == 6
    x, onehots = batches()
    native_losses = step.run_steps(
        [([x[i]], onehots[i]) for i in range(STEPS)], device="cpu")
    m.set_optimizer(opt.SGD(lr=LR))  # plain: p <- p - lr * g
    m.compile([torch.from_numpy(x[0])], is_train=True, use_graph=False)
    m.dropout.training = False
    eager = [float(m(torch.from_numpy(x[i]), torch.from_numpy(onehots[i]))
                   [1].detach()) for i in range(STEPS)]
    # training is real: batch 0's loss falls after the three steps (the
    # steps' own losses are on three different random batches)
    run = step.runner("cpu")
    for i in range(STEPS):
        run.step([x[i]], onehots[i])
    again = float(run.step([x[0]], onehots[0])[0])
    assert again < native_losses[0], (again, native_losses)
    np.testing.assert_allclose(native_losses, eager, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(native_losses, reference["losses"],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["Gelu", "LayerNormalization", "Softmax"])
def test_an_op_outside_the_lowering_raises_by_name(kind):
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    with autograd.TapeRecorder():
        if kind == "Gelu":
            y = autograd.gelu(x)
        elif kind == "Softmax":
            y = autograd.softmax(x)
        else:
            y = autograd.layernorm(x, torch.ones(4), torch.zeros(4))
    with pytest.raises(NotImplementedError, match=f"'{kind}'"):
        hlo_bridge.lower_tape(y)


def test_the_loss_must_be_recorded_and_params_leaves():
    m, _ = _recorded_step()
    x, onehots = batches()
    loss = autograd.softmax_cross_entropy(m(torch.from_numpy(x[0])),
                                          onehots[0])
    with pytest.raises(ValueError, match="TapeRecorder"):
        hlo_bridge.lower_train_step(loss, list(m.parameters()), LR)
    with autograd.TapeRecorder():
        loss = autograd.softmax_cross_entropy(
            m.forward(torch.from_numpy(x[0])), onehots[0])
    with pytest.raises(ValueError, match="not a leaf"):
        hlo_bridge.lower_train_step(loss, [torch.zeros(3)], LR)


def test_shape_error_surfaces():
    b = native.HloGraphBuilder()
    x, w = b.param((4, 8)), b.param((9, 16))  # mismatched contraction
    with pytest.raises(ValueError, match="hlo_dot"):
        b.dot(x, w)
    b.close()


def test_the_runtime_refuses_an_op_outside_its_vocabulary():
    text = builder_texts(native.HloGraphBuilder)["unary"]
    line = next(i + 1 for i, ln in enumerate(text.splitlines())
                if "stablehlo.tanh" in ln)
    bad = text.replace("stablehlo.tanh", "stablehlo.sine")
    with pytest.raises(NotImplementedError,
                       match=f"line {line}: stablehlo.sine"):
        HloRuntime("cpu").compile_mlir(bad)
    bad = text.replace("stablehlo.tanh %arg0", "stablehlo.tanh %arg0 "
                       "{result_accuracy = 1}")
    with pytest.raises(NotImplementedError, match=f"line {line}: "
                       "stablehlo.tanh with attributes"):
        HloRuntime("cpu").compile_mlir(bad)


def test_the_runtime_runs_the_text_as_edited():
    """An edited text runs as edited: the lr constant's literal changed
    in the text moves the update by that much."""
    _, step = _recorded_step()
    lit = "%.9e" % LR  # the lr constant as the C++ prints it
    assert step.text.count(f"dense<{lit}>") == 4
    x, onehots = batches()
    batch = [([x[0]], onehots[0])]
    runs = {}
    for lr, text in ((LR, step.text), (2 * LR, step.text.replace(
            lit, "%.9e" % (2 * LR)))):
        run = dataclasses.replace(step, text=text).runner("cpu")
        run.step(*batch[0])
        runs[lr] = [p.clone() for p in run.params()]
    for p, a, b in zip(step.param_idx, runs[LR], runs[2 * LR]):
        p0 = torch.from_numpy(step.args[p])
        torch.testing.assert_close(b - p0, 2 * (a - p0), rtol=1e-5,
                                   atol=1e-7)


def test_a_module_of_two_replicas_refuses_a_process_of_one():
    _, step = _recorded_step(2)
    with pytest.raises(ValueError, match="num_replicas = 2 but the process "
                       "group has 1 rank"):
        HloRuntime("cpu").compile_mlir(step.text)


def test_no_fallback(tmp_path, monkeypatch):
    """The runtime is on the card unless asked for the CPU; with g++
    missing, and with g++ refusing the source, a builder raises
    NativeBuildError."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HloRuntime()
    rt = HloRuntime("cpu")
    assert (rt.platform(), rt.device_kind(), rt.num_devices(),
            rt.memory_stats()) == ("cpu", "cpu", 1, {})
    before = native.native_call_count()
    native.HloGraphBuilder().close()
    assert native.native_call_count() == before + 1
    monkeypatch.setattr(native, "_hlo_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match=r"g\+\+ not found"):
        native.HloGraphBuilder()
    monkeypatch.undo()
    bad = tmp_path / "hlo_core.cc"
    bad.write_text('extern "C" { long hlo_new( }\n')
    monkeypatch.setattr(native, "_hlo_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "HLO_SOURCE", bad)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.HloGraphBuilder()


def test_the_recorder_leaves_the_forward_as_it_runs():
    """Under a TapeRecorder the forward gives the same values and counts
    the same ops on the Device seam; its outputs carry tape nodes (the
    loss its one-hot target), and an export trace cannot start inside
    it."""
    from singa_tpu_torch import device

    m, _ = _recorded_step()
    x, onehots = batches()
    xt = torch.from_numpy(x[1])
    dev = device.create_cpu_device()
    dev.reset_op_count()
    plain = autograd.softmax_cross_entropy(m.forward(xt), onehots[1])
    n_plain = dev.op_count
    dev.reset_op_count()
    with autograd.TapeRecorder():
        with pytest.raises(RuntimeError, match="already running"):
            autograd.ExportTrace([xt]).__enter__()
        taped = autograd.softmax_cross_entropy(m.forward(xt), onehots[1])
    assert dev.op_count == n_plain > 0
    assert torch.equal(plain, taped)
    assert autograd.tape_node(plain) is None
    node = autograd.tape_node(taped)
    assert node.kind == "SoftMaxCrossEntropy"
    np.testing.assert_array_equal(node.aux, onehots[1])
    assert autograd.tape_node(node.inputs[0]).kind == "Linear"
