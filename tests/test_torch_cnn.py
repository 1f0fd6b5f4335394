"""Port's CNN layers (singa_tpu_torch.layer, .autograd, .layout) against
the reference's on the same seeded weights and inputs, in both image
layouts.

Inputs are NCHW numpy arrays. The reference's layers take them
transposed to NHWC under "NHWC"; the port's take the same logical NCHW
tensor in channels-last memory (`layout.from_nchw`). Each test compares
the output (in NCHW order), the gradient of a seeded cotangent with
respect to the input and to every parameter, and, for BatchNorm, the
running statistics after the call. fp32 on both sides; absolute
tolerances are stated per test (1e-5 or 1e-6 where only the summation
order of a reduction differs, 1e-4 for convolutions, with longer sums),
beside a relative 1e-5 for the sums of many terms (the gradients of
`scale`, `offset` and `W`).
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu import layer as jax_layer
from singa_tpu import layout as jax_layout
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import autograd, layer, layout
from singa_tpu_torch.model import load_singa_tpu_states
from singa_tpu_torch.ops import max_pool
from tests.helper_torch_parity import rand, randomize_params

LAYOUTS = ["NCHW", "NHWC"]


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    jax_autograd.training = False
    max_pool.set_pool_kernel_enabled(False)


def _to(a, lay):
    """An NCHW array in the reference's layout `lay`."""
    return a if lay == "NCHW" or a.ndim != 4 else np.ascontiguousarray(
        a.transpose(0, 2, 3, 1))


def _from(a, lay):
    return a if lay == "NCHW" or a.ndim != 4 else a.transpose(0, 3, 1, 2)


def _ref(lyr, x, dy, lay, train=True, states=None):
    """Initialize the reference layer on x (without moving any state),
    give it `states`, then run it on x and backpropagate dy; returns the
    output and {"x" or param name: grad}, in NCHW order."""
    with jax_layout.use_image_layout(lay):
        if getattr(lyr, "training", None) is not None:
            lyr.training = False
        lyr(from_numpy(_to(x, lay)))
        if states is None:
            states = randomize_params(lyr, 7)
            for name, buf in lyr.get_buffers().items():
                states[name] = np.asarray(rand(buf.shape, 8, 0.2)) + (
                    1.0 if name.endswith("var") else 0.0)
                buf.copy_from(states[name])
        if getattr(lyr, "training", None) is not None:
            lyr.training = train
        xt = from_numpy(_to(x, lay))
        xt.stores_grad = True
        jax_autograd.training = True
        y = lyr(xt)
        names = {id(t): n for n, t in lyr.get_params().items()}
        names[id(xt)] = "x"
        grads = {names[id(p)]: np.asarray(g.data) for p, g in
                 jax_autograd.backward(y, from_numpy(_to(dy, lay)))}
        grads["x"] = _from(grads["x"], lay)  # weights are OIHW in both
    return _from(np.asarray(y.data), lay), grads, states


def _port(lyr, x, dy, lay, states, train=True):
    load_singa_tpu_states(lyr, states)
    lyr.train(train)
    with layout.use_image_layout(lay):
        xt = layout.from_nchw(torch.from_numpy(x)).requires_grad_()
        y = lyr(xt)
        named = [("x", xt), *lyr.named_parameters()]
        gs = torch.autograd.grad(y, [t for _, t in named],
                                 torch.from_numpy(dy))
    if lay == "NHWC" and y.dim() == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
    return (y.detach().numpy(),
            {n: g.numpy() for (n, _), g in zip(named, gs)})


def _compare(ref, port, atol):
    (y_want, g_want), (y_got, g_got) = ref, port
    np.testing.assert_allclose(y_got, y_want, atol=atol, rtol=1e-5)
    assert sorted(g_got) == sorted(g_want)
    for k in g_want:
        np.testing.assert_allclose(g_got[k], g_want[k], atol=atol,
                                   rtol=1e-5, err_msg=k)


CONVS = [  # cin, cout, kernel, stride, padding, bias, hw
    (3, 8, 3, 1, 1, True, 10),
    (3, 8, 7, 2, 3, False, 16),   # the ResNet stem
    (8, 16, 1, 2, 0, False, 9),   # a projection shortcut
]


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("cin,cout,k,s,p,bias,hw", CONVS)
def test_conv2d_matches_reference(lay, cin, cout, k, s, p, bias, hw):
    x = rand((2, cin, hw, hw), 0)
    oh = (hw + 2 * p - k) // s + 1
    dy = rand((2, cout, oh, oh), 1)
    y, g, st = _ref(jax_layer.Conv2d(cout, k, stride=s, padding=p,
                                     bias=bias), x, dy, lay)
    port = layer.Conv2d(cin, cout, k, stride=s, padding=p, bias=bias,
                        device="cpu")
    _compare((y, g), _port(port, x, dy, lay, st), atol=1e-4)


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_reference(lay, train):
    """Training mode: batch statistics (E[x^2] - E[x]^2 in fp32), and the
    running statistics move with the biased variance at momentum 0.9.
    Eval mode: the running statistics, which stay."""
    x = rand((4, 6, 5, 5), 2, scale=2.0) + 0.5
    dy = rand((4, 6, 5, 5), 3)
    ref = jax_layer.BatchNorm2d()
    y, g, st = _ref(ref, x, dy, lay, train=train)
    port = layer.BatchNorm2d(6, device="cpu")
    _compare((y, g), _port(port, x, dy, lay, st, train=train), atol=1e-5)
    for name in ("running_mean", "running_var"):
        want = np.asarray(getattr(ref, name).data)
        np.testing.assert_allclose(getattr(port, name).numpy(), want,
                                   atol=1e-6, err_msg=name)
        assert np.array_equal(want, st[name]) != train  # moved iff train


@pytest.mark.parametrize("lay", LAYOUTS)
def test_batchnorm_degenerate_guard_matches_reference(lay):
    """N*H*W = 8 < 16: both normalize with the running statistics, update
    them from the batch moments held without gradient, and warn."""
    x = rand((2, 4, 2, 2), 4) + 0.3
    dy = rand((2, 4, 2, 2), 5)
    ref = jax_layer.BatchNorm2d()
    with pytest.warns(UserWarning, match="degenerate"):
        y, g, st = _ref(ref, x, dy, lay)
    port = layer.BatchNorm2d(4, device="cpu")
    with pytest.warns(UserWarning, match="degenerate"):
        got = _port(port, x, dy, lay, st)
    _compare((y, g), got, atol=1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name).data),
                                   atol=1e-6, err_msg=name)


POOLS = [  # kind, kernel, stride, padding, hw
    ("max", 3, 2, 1, 12),  # the ResNet stem's
    ("max", 2, 2, 0, 8),   # VGG's, alexnet_cifar's
    ("max", 3, 2, 0, 13),  # the ImageNet AlexNet's
    ("avg", 3, 2, 1, 9),   # padding excluded from the average
    ("avg", 2, 2, 0, 8),
]


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("kind,k,s,p,hw", POOLS)
def test_pool_matches_reference(lay, kind, k, s, p, hw):
    """Under NHWC the port's max-pool goes through maxpool2d_nhwc with
    the kernel switched on (its plain version here); ReLU-clamped inputs
    tie at zeros. Values agree to 1e-6."""
    max_pool.set_pool_kernel_enabled(True)
    x = np.maximum(rand((2, 4, hw, hw), 6), 0.0)
    oh = (hw + 2 * p - k) // s + 1
    dy = rand((2, 4, oh, oh), 7)
    cls = (jax_layer.MaxPool2d, layer.MaxPool2d) if kind == "max" else (
        jax_layer.AvgPool2d, layer.AvgPool2d)
    y, g, st = _ref(cls[0](k, stride=s, padding=p), x, dy, lay)
    got = _port(cls[1](k, stride=s, padding=p), x, dy, lay, st)
    _compare((y, g), got, atol=1e-6)
    np.testing.assert_array_equal(got[1]["x"] != 0, g["x"] != 0)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_global_avg_pool_and_flatten_match_reference(lay):
    """Global average pooling reduces in fp32; Flatten gives the NCHW
    feature order in both layouts (the reference rotates NHWC back)."""
    x = rand((2, 5, 3, 4), 8)
    for ref, port, dy in (
            (jax_layer.GlobalAvgPool2d(), layer.GlobalAvgPool2d(),
             rand((2, 5), 9)),
            (jax_layer.Flatten(), layer.Flatten(), rand((2, 60), 10))):
        y, g, st = _ref(ref, x, dy, lay)
        _compare((y, g), _port(port, x, dy, lay, st), atol=1e-6)


def test_layout_keeps_the_logical_shape():
    x = torch.from_numpy(rand((2, 3, 4, 5), 11))
    with layout.use_image_layout("NHWC"):
        assert layout.image_layout() == "NHWC"
        cl = layout.from_nchw(x)
        assert cl.shape == x.shape and torch.equal(cl, x)
        assert cl.is_contiguous(memory_format=torch.channels_last)
        assert layout.to_nchw(cl).is_contiguous()
        assert layout.channel_axis(4) == 1 and layout.spatial_axes() == (2, 3)
    assert layout.image_layout() == "NCHW"
    assert layout.from_nchw(x) is x
    with pytest.raises(ValueError, match="image layout"):
        layout.set_image_layout("CHWN")


def test_load_singa_tpu_states_checks_names_and_shapes():
    bn = layer.BatchNorm2d(3, device="cpu")
    states = {"scale": np.full(3, 2.0, np.float32),
              "offset": np.zeros(3, np.float32),
              "running_mean": np.arange(3, dtype=np.float32),
              "running_var": np.full(3, 4.0, np.float32)}
    load_singa_tpu_states(bn, states)
    assert bn.running_mean.tolist() == [0.0, 1.0, 2.0]
    assert bn.scale.tolist() == [2.0, 2.0, 2.0]
    with pytest.raises(KeyError, match="missing"):
        load_singa_tpu_states(bn, {k: v for k, v in states.items()
                                   if k != "running_var"})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_singa_tpu_states(bn, {**states, "offset": np.zeros(4)})


def test_conv_under_bf16_autocast_keeps_bf16_activations():
    """precision="bf16": conv operands in bf16, the bf16 result flows on;
    batch norm keeps fp32 statistics and returns bf16; the max-pool
    kernel's plain version takes and returns bf16."""
    max_pool.set_pool_kernel_enabled(True)
    seq = layer.Sequential(layer.Conv2d(3, 8, 3, padding=1, device="cpu"),
                           layer.BatchNorm2d(8, device="cpu"),
                           layer.ReLU(), layer.MaxPool2d(3, 2, 1))
    x = torch.from_numpy(rand((2, 3, 8, 8), 12)).requires_grad_()
    with autograd.autocast(), layout.use_image_layout("NHWC"):
        y = seq(layout.from_nchw(x))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 8, 4, 4)
    y.float().sum().backward()
    assert seq.layers[0].W.grad.dtype == torch.float32
    assert torch.isfinite(x.grad).all()
    assert torch.isfinite(seq.layers[1].running_var).all()


def test_cifar_trainer_lowers_the_loss(capsys):
    """The trainer on the CPU, resnet20_cifar, 2 epochs of 64 batches of
    32 synthetic CIFAR-10 images: the loss sanity check passes."""
    from singa_tpu_torch.examples import cnn_cifar10

    rc = cnn_cifar10.main(["--device", "cpu", "--model", "resnet",
                           "--epochs", "2", "--batch", "32"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "loss sanity" in out and "ok" in out.splitlines()[-1], out


@pytest.mark.parametrize("flag", [
    ["--dist"], ["--dist-option", "half"], ["--spars", "0.1"],
    ["--checkpoint", "ckpt.zip"], ["--virtual-devices", "8"],
    ["--loader", "prefetch"]])
def test_cifar_trainer_refuses_unported_options(flag):
    from singa_tpu_torch.examples import cnn_cifar10

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cnn_cifar10.main(["--device", "cpu", "--epochs", "1", *flag])


@pytest.mark.parametrize("k2a", [False, True])
@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("k,p", [(2, 2), (3, 2), (1, 1)])
def test_pools_take_padding_over_half_the_window(k2a, lay, kind, k, p):
    """Pads over half the window, which PyTorch's pools refuse: the port
    pads explicitly and matches the reference's `lax.reduce_window`,
    -inf (max) and NaN (average) included where a window lies wholly in
    padding (every k 1, p 1 border window). Stride 1 on (2, 3, 8, 8)."""
    max_pool.set_pool_kernel_enabled(k2a)
    x = rand((2, 3, 8, 8), 11)
    oh = 8 + 2 * p - k + 1
    dy = rand((2, 3, oh, oh), 12)
    cls = (jax_layer.MaxPool2d, layer.MaxPool2d) if kind == "max" else (
        jax_layer.AvgPool2d, layer.AvgPool2d)
    y, g, st = _ref(cls[0](k, stride=1, padding=p), x, dy, lay)
    got = _port(cls[1](k, stride=1, padding=p), x, dy, lay, st)
    assert got[0].shape == (2, 3, oh, oh)
    if k == 1:
        border = ~np.isfinite(y)
        assert border[..., 0, :].all() and border[..., 1:-1, 1:-1].sum() == 0
        assert (np.isneginf(y) if kind == "max" else np.isnan(y))[
            border].all()
    _compare((y, g), got, atol=1e-6)
