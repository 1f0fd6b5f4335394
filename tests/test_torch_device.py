"""The port's `Device` classes, factories, exec seam and `RunConfig`
(singa_tpu_torch.device, singa_tpu_torch.config) against singa_tpu's
contract (`tests/test_tensor.py:165-186`,
`tests/test_amp_profiler.py:79-89`).

The one difference on purpose: with no accelerator the reference warns
and falls back to the host (`TpuDevice()`, `get_default_device()`),
where the port raises; the host is used only when asked for.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from singa_tpu import config as ref_config  # noqa: E402
from singa_tpu import device as ref_device  # noqa: E402
from singa_tpu import tensor as ref_tensor  # noqa: E402
from singa_tpu_torch import autograd, device, layer, tensor  # noqa: E402
from singa_tpu_torch.config import RunConfig  # noqa: E402
from singa_tpu_torch.models.gpt import GPT  # noqa: E402

CARD_FACTORIES = [device.get_default_device, device.create_tpu_device,
                  device.create_cuda_gpu, lambda: device.create_cuda_gpu_on(0),
                  device.create_opencl_device, device.CudaGPU,
                  device.TpuDevice, device.OpenclGPU]


@pytest.fixture
def one_card(monkeypatch):
    """A process that sees one CUDA device (the objects are built; no
    kernel runs)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_the_module_exports_the_reference_names():
    assert set(ref_device.__all__) <= set(device.__all__)
    for name in ref_device.__all__:
        assert callable(getattr(device, name)), name


def test_the_classes_are_the_reference_hierarchy_turned_toward_the_card():
    """CppCPU is the host and CudaGPU the card; TpuDevice and OpenclGPU
    are aliases of the card (the reference's CudaGPU and OpenclGPU are
    aliases of its TPU)."""
    assert issubclass(ref_device.CudaGPU, ref_device.TpuDevice)
    for cls in (device.TpuDevice, device.OpenclGPU):
        assert issubclass(cls, device.CudaGPU)
    for cls in (device.CppCPU, device.CudaGPU):
        assert issubclass(cls, device.Device)
    assert not issubclass(device.CppCPU, device.CudaGPU)


@pytest.mark.parametrize("make", CARD_FACTORIES)
def test_the_card_raises_where_the_reference_falls_back(monkeypatch, make):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert ref_device.TpuDevice().platform == "cpu"
    assert any("falling back" in str(w.message) for w in caught)
    assert isinstance(ref_device.get_default_device(), ref_device.CppCPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("make,cls", [
    (device.get_default_device, device.CudaGPU),
    (device.create_cuda_gpu, device.CudaGPU),
    (lambda: device.create_cuda_gpu_on(0), device.CudaGPU),
    (device.create_tpu_device, device.TpuDevice),
    (device.create_opencl_device, device.OpenclGPU)])
def test_the_factories_make_the_card(one_card, make, cls):
    d = make()
    assert type(d) is cls
    assert d.torch_device == torch.device("cuda", 0)
    assert d.platform == "gpu" and d.id == 0
    assert device.resolve(d) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="does not exist"):
        device.create_cuda_gpu_on(1)


def test_the_host_device_keeps_the_reference_surface():
    ref, d = ref_device.CppCPU(), device.create_cpu_device()
    assert isinstance(d, device.CppCPU) and d.kind == ref.kind
    assert d.platform == ref.platform == "cpu"
    assert d.memory_stats() == ref.memory_stats() == {}
    info = d.device_info()
    assert set(info) == set(ref.device_info())
    assert (info["device_kind"], info["platform"]) == ("cpu", "cpu")
    d.sync()
    d.Sync()
    d.EnableGraph(True)
    assert d.graph_enabled
    x = torch.ones(2)
    assert d.put(x) is x
    assert torch.equal(d.put(np.ones(2, np.float32)), x)
    assert d == device.CppCPU() and hash(d) == hash(device.CppCPU())
    device.enable_lazy_stats(True)


def test_dispatch_counts_ops(cpu_dev):
    """The reference's TestDevice.test_dispatch_counts_ops: two module
    ops on the host count at least two (here exactly two) on its
    device."""
    cpu_dev.reset_op_count()
    t = ref_tensor.from_numpy(np.ones((2, 2), np.float32), dev=cpu_dev)
    ref_tensor.add(t, t)
    ref_tensor.exp(t)
    assert cpu_dev.op_count >= 2

    d = device.create_cpu_device()
    d.reset_op_count()
    t = tensor.from_numpy(np.ones((2, 2), np.float32), dev=d)
    tensor.add(t, t)
    tensor.exp(t)
    assert d.op_count == 2
    # every Device of the host shares its count (a tensor knows only its
    # torch.device)
    assert device.of(t).op_count == device.CppCPU().op_count == 2
    assert device.of(1.0) is None


def test_the_autograd_ops_and_operators_dispatch_through_exec():
    d = device.create_cpu_device()
    x = torch.randn(3, 4)
    w = torch.randn(4, 2, requires_grad=True)
    d.reset_op_count()
    autograd.relu(autograd.linear(x, w))
    assert d.op_count == 2
    f = autograd.Function(lambda a: a * 2.0)
    f(x)
    assert d.op_count == 3


def test_a_model_step_counts_the_same_ops_each_eager_call():
    """On the host a graph-mode step runs uncaptured, so each call counts
    its ops again (a replay of the captured step on the card adds none:
    chip_smoke's devices phase)."""
    from singa_tpu_torch import opt

    d = device.create_cpu_device()
    m = GPT(vocab_size=16, d_model=32, num_layers=1, num_heads=2,
            max_len=8, dropout=0.0, device=d)
    m.set_optimizer(opt.SGD(lr=0.1))
    x = torch.randint(0, 16, (2, 8))
    m.compile([x], is_train=True, use_graph=True)
    counts = []
    for _ in range(3):
        before = d.op_count
        m(x, x)
        counts.append(d.op_count - before)
    assert counts[0] > 0 and counts[1] == counts[2] == counts[0]


def test_entry_points_take_a_device_object():
    d = device.create_cpu_device()
    assert device.resolve(d) == torch.device("cpu")
    dev, gen = layer._setup(d, None)
    assert dev == torch.device("cpu") and isinstance(gen, torch.Generator)
    assert layer.Linear(3, in_features=2, device=d).W.device.type == "cpu"
    assert tensor.zeros((2,), dev=d).device.type == "cpu"


def test_run_config_has_the_reference_fields():
    assert [(f.name, f.default) for f in dataclasses.fields(RunConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(ref_config.RunConfig)]


def test_run_config_apply():
    """The reference's test_run_config_apply, on the port."""
    cfg = RunConfig(precision="bf16", seed=7, device="cpu")
    cfg.apply()
    try:
        assert autograd.autocast_enabled()
    finally:
        autograd.set_autocast(False)
    dev = cfg.make_device()
    assert dev.platform == "cpu" and isinstance(dev, device.CppCPU)
    mesh = cfg.make_mesh()
    assert "data" in mesh.shape and mesh.shape == {"data": 1}
    a = tensor.gaussian(tensor.zeros((4,), dev="cpu"), 0.0, 1.0).clone()
    RunConfig(seed=7).apply()
    assert not autograd.autocast_enabled()
    b = tensor.gaussian(tensor.zeros((4,), dev="cpu"), 0.0, 1.0)
    cfg.apply()
    autograd.set_autocast(False)
    assert torch.equal(a, tensor.gaussian(tensor.zeros((4,), dev="cpu"),
                                          0.0, 1.0))
    assert torch.equal(a, b)


def test_run_config_devices(monkeypatch, one_card):
    assert isinstance(RunConfig(device="tpu").make_device(),
                      device.TpuDevice)
    assert isinstance(RunConfig().make_device(), device.CudaGPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RunConfig(device=name).make_device()


def test_run_config_mesh_shapes():
    cfg = RunConfig(mesh_shape=(1, 1), mesh_axes=("data", "sp"))
    assert cfg.make_mesh().shape == {"data": 1, "sp": 1}
    with pytest.raises(ValueError, match="does not match"):
        RunConfig(mesh_shape=(2,)).make_mesh()
