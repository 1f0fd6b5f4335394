"""The rest of the layer surface against singa_tpu.layer, on the same
seeded weights and inputs: `SeparableConv2d`, `LeakyReLU`, `Sigmoid`,
`SoftMax`, `Cat`, `Add` and grouped `Conv2d(group=)`, forward and the
gradients of a seeded cotangent with respect to the input and every
weight, within 1e-6 of each tensor's max|value| (relative; only the
summation order differs), in both image layouts where the layer has an
image axis (`tests/test_torch_cnn.py`'s `_ref` and `_port` run the two
sides). Then `autograd.conv2d`'s string padding: "same" and "valid" at
strides 1 and 2, odd and even sizes, kernels 1, 2, 3 and 5, dilation 2
and groups = channels, against `singa_tpu.autograd.conv2d` (XLA puts the
odd pad cell at the end); its export (`auto_pad` with zero pads, as the
reference writes it) and import; and the ONNX nodes of the new layers
(LeakyRelu, Sigmoid, Softmax, Concat, Add), exported and read back.

Axes are logical NCHW ones in the port in both layouts; the reference's
`Cat` and `SoftMax` act on the raw NHWC array under "NHWC", where axis 1
is the height, so those two are held in NCHW and, under NHWC, to the
reference's NCHW result.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu import layer as jax_layer
from singa_tpu import layout as jax_layout
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import autograd, layer, layout, model, sonnx
from tests.helper_torch_parity import rand
from tests.test_torch_cnn import _from, _port, _ref, _to

LAYOUTS = ["NCHW", "NHWC"]


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    jax_autograd.training = False


def _close(got, want, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale,
                               err_msg=what)


def _compare(ref, port):
    (y_want, g_want), (y_got, g_got) = ref, port
    _close(y_got, y_want, "y")
    assert sorted(g_got) == sorted(g_want)
    for k in g_want:
        _close(g_got[k], g_want[k], k)


SEPARABLE = [  # cin, cout, kernel, stride, padding, bias, hw
    (4, 8, 3, 1, 1, False, 9),
    (6, 5, 3, 2, 1, True, 10),
    (4, 8, 3, 2, "same", False, 9),
    (4, 8, 5, 1, "valid", True, 9),
]


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("cin,cout,k,s,p,bias,hw", SEPARABLE)
def test_separable_conv_matches_reference(lay, cin, cout, k, s, p, bias,
                                          hw):
    x = rand((2, cin, hw, hw), 0)
    with torch.no_grad():
        probe = layer.SeparableConv2d(cout, k, s, p, bias, in_channels=cin,
                                      device="cpu")
        oh = probe(torch.from_numpy(x)).shape[-1]
    dy = rand((2, cout, oh, oh), 1)
    y, g, st = _ref(jax_layer.SeparableConv2d(cout, k, stride=s, padding=p,
                                              bias=bias), x, dy, lay)
    port = layer.SeparableConv2d(cout, k, stride=s, padding=p, bias=bias,
                                 device="cpu")  # made at the first call
    assert not list(port.parameters())
    with layout.use_image_layout(lay), torch.no_grad():
        port(layout.from_nchw(torch.from_numpy(x)))
    assert port.depthwise.group == cin
    assert tuple(port.depthwise.W.shape) == (cin, 1, k, k)
    assert sorted(st) == sorted(port.get_states())
    _compare((y, g), _port(port, x, dy, lay, st))


GROUPED = [  # cin, cout, kernel, stride, padding, group, hw
    (8, 12, 3, 1, 1, 2, 9),
    (8, 8, 3, 2, 1, 8, 10),
    (6, 12, 1, 1, 0, 3, 7),
]


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("cin,cout,k,s,p,group,hw", GROUPED)
def test_grouped_conv_matches_reference(lay, cin, cout, k, s, p, group, hw):
    x = rand((2, cin, hw, hw), 2)
    oh = (hw + 2 * p - k) // s + 1
    dy = rand((2, cout, oh, oh), 3)
    y, g, st = _ref(jax_layer.Conv2d(cout, k, stride=s, padding=p,
                                     group=group), x, dy, lay)
    port = layer.Conv2d(cout, k, stride=s, padding=p, group=group,
                        in_channels=cin, device="cpu")
    assert tuple(port.W.shape) == (cout, cin // group, k, k)
    _compare((y, g), _port(port, x, dy, lay, st))


ELEMENTWISE = [
    ("leakyrelu", lambda: jax_layer.LeakyReLU(0.2),
     lambda: layer.LeakyReLU(0.2)),
    ("leakyrelu_default", jax_layer.LeakyReLU, layer.LeakyReLU),
    ("sigmoid", jax_layer.Sigmoid, layer.Sigmoid),
]


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("name,jax_ctor,ctor", ELEMENTWISE,
                         ids=[e[0] for e in ELEMENTWISE])
def test_activation_matches_reference(lay, name, jax_ctor, ctor):
    x = rand((2, 3, 5, 5), 4)
    x[0, 0, 0, :3] = 0.0  # the slope at 0: 1, as jax.nn.leaky_relu's
    dy = rand((2, 3, 5, 5), 5)
    y, g, st = _ref(jax_ctor(), x, dy, lay, states={})
    _compare((y, g), _port(ctor(), x, dy, lay, st))


@pytest.mark.parametrize("shape,axis,lay", [
    ((4, 7), -1, "NCHW"), ((4, 7), 0, "NCHW"), ((2, 3, 4, 5), 1, "NCHW"),
    ((2, 3, 4, 5), -1, "NCHW"), ((2, 3, 4, 5), 1, "NHWC")])
def test_softmax_matches_reference(shape, axis, lay):
    """Held to the reference's NCHW result in both layouts."""
    x, dy = rand(shape, 6, 3.0), rand(shape, 7)
    y, g, st = _ref(jax_layer.SoftMax(axis), x, dy, "NCHW", states={})
    _compare((y, g), _port(layer.SoftMax(axis), x, dy, lay, st))


def _two_input(jax_lyr, port_lyr, xs, dy, lay):
    """A two-input layer on both sides: (y, {"x0", "x1": grads}) each,
    the reference in NCHW."""
    ts = [from_numpy(a) for a in xs]
    for t in ts:
        t.stores_grad = True
    jax_autograd.training = True
    yr = jax_lyr(*ts)
    names = {id(t): f"x{i}" for i, t in enumerate(ts)}
    want = {names[id(p)]: np.asarray(gr.data) for p, gr in
            jax_autograd.backward(yr, from_numpy(dy))}
    with layout.use_image_layout(lay):
        pts = [layout.from_nchw(torch.from_numpy(a)).requires_grad_()
               for a in xs]
        yp = port_lyr(*pts)
        gs = torch.autograd.grad(yp, pts, torch.from_numpy(dy))
    got = {f"x{i}": gr.numpy() for i, gr in enumerate(gs)}
    return (np.asarray(yr.data), want), (yp.detach().numpy(), got)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_cat_joins_channels_like_the_reference(lay):
    xs = [rand((2, 3, 4, 4), 8), rand((2, 5, 4, 4), 9)]
    dy = rand((2, 8, 4, 4), 10)
    ref, port = _two_input(jax_layer.Cat(1), layer.Cat(1), xs, dy, lay)
    _compare(ref, port)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_add_matches_reference(lay):
    xs = [rand((2, 3, 4, 4), 11), rand((2, 3, 4, 4), 12)]
    dy = rand((2, 3, 4, 4), 13)
    ref, port = _two_input(jax_layer.Add(), layer.Add(), xs, dy, lay)
    _compare(ref, port)


PADDED = [  # cin, cout, kernel, stride, padding, dilation, groups, hw
    (3, 4, 3, 1, "same", 1, 1, 7),
    (3, 4, 3, 2, "same", 1, 1, 8),
    (3, 4, 3, 2, "same", 1, 1, 7),
    (3, 4, 2, 1, "same", 1, 1, 8),
    (3, 4, 2, 2, "SAME", 1, 1, 7),
    (3, 4, 5, 2, "same", 1, 1, 8),
    (3, 4, 1, 2, "same", 1, 1, 7),
    (3, 4, 3, 1, "same", 2, 1, 9),
    (4, 4, 3, 2, "same", 1, 4, 8),
    (4, 8, 5, 2, "same", 1, 4, 9),
    (3, 4, 3, 2, "valid", 1, 1, 8),
    (3, 4, 2, 1, "VALID", 2, 1, 7),
    (4, 4, 3, 1, "valid", 1, 4, 6),
]


def _ref_conv(x, w, b, stride, padding, dilation, groups, dy, lay):
    with jax_layout.use_image_layout(lay):
        xt, wt, bt = (from_numpy(_to(x, lay)), from_numpy(w),
                      from_numpy(b))
        for t in (xt, wt, bt):
            t.stores_grad = True
        jax_autograd.training = True
        y = jax_autograd.conv2d(xt, wt, bt, stride=stride, padding=padding,
                                dilation=dilation, groups=groups)
        names = {id(xt): "x", id(wt): "W", id(bt): "b"}
        grads = {names[id(p)]: np.asarray(g.data) for p, g in
                 jax_autograd.backward(y, from_numpy(_to(dy, lay)))}
    grads["x"] = _from(grads["x"], lay)
    return _from(np.asarray(y.data), lay), grads


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("cin,cout,k,s,p,d,groups,hw", PADDED)
def test_conv2d_string_padding_matches_reference(lay, cin, cout, k, s, p, d,
                                                 groups, hw):
    x = rand((2, cin, hw, hw), 14)
    w = rand((cout, cin // groups, k, k), 15, 0.3)
    b = rand((cout,), 16)
    oh = (-(-hw // s) if p.lower() == "same"
          else (hw - (k - 1) * d - 1) // s + 1)
    dy = rand((2, cout, oh, oh), 17)
    want = _ref_conv(x, w, b, s, p, d, groups, dy, lay)
    with layout.use_image_layout(lay):
        xt = layout.from_nchw(torch.from_numpy(x)).requires_grad_()
        wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
        y = autograd.conv2d(xt, wt, bt, s, p, d, groups)
        gs = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(dy))
    if lay == "NHWC":
        assert y.is_contiguous(memory_format=torch.channels_last)
    got = (y.detach().numpy(), dict(zip(("x", "W", "b"),
                                        (g.numpy() for g in gs))))
    assert got[0].shape == (2, cout, oh, oh)
    _compare(want, got)


def test_conv2d_refuses_an_unknown_padding_word():
    with pytest.raises(ValueError, match="unknown padding"):
        autograd.conv2d(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3),
                        padding="full")


class _Surface(model.Model):
    """Every new layer, and a stride-2 "same" conv, in one forward."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.sep = layer.SeparableConv2d(6, 3, stride=2, padding="same",
                                         in_channels=4, device="cpu",
                                         generator=gen)
        self.conv = layer.Conv2d(6, 3, stride=2, padding="same",
                                 in_channels=4, device="cpu", generator=gen)
        self.leaky = layer.LeakyReLU(0.1)
        self.sigmoid = layer.Sigmoid()
        self.add = layer.Add()
        self.cat = layer.Cat(1)
        self.softmax = layer.SoftMax(1)

    def forward(self, x):
        a = self.leaky(self.sep(x))
        c = self.sigmoid(self.conv(x))
        return self.softmax(self.cat(self.add(a, c), c))


@pytest.mark.parametrize("lay", LAYOUTS)
def test_new_layers_export_and_import(lay):
    m = _Surface()
    m.set_image_layout(lay)
    x = rand((2, 4, 9, 9), 18)
    want = m.eval()(torch.from_numpy(x)).numpy()
    blob = sonnx.proto.encode_model(sonnx.to_onnx(m, [torch.from_numpy(x)]))
    nodes = sonnx.proto.decode_model(blob).graph.node
    kinds = [n.op_type for n in nodes]
    for kind in ("LeakyRelu", "Sigmoid", "Softmax", "Concat", "Add"):
        assert kind in kinds, kinds
    convs = [{a.name: a for a in n.attribute} for n in nodes
             if n.op_type == "Conv"]
    same = [c for c in convs if c["auto_pad"].s == b"SAME"]
    assert len(convs) == 3 and len(same) == 2  # the pointwise one: pads 0
    assert all(list(c["pads"].ints) == [0, 0, 0, 0] for c in convs)
    (got,) = sonnx.prepare(blob, device="cpu").run([x])
    assert got.shape == (2, 12, 5, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
