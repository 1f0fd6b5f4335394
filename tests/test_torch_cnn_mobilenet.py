"""The port's `mobilenet_v1_cifar` (singa_tpu_torch.models.mobilenet),
the CIFAR-10 trainer's MobileNetV1 (stride-1 stem, alpha 0.5), against
the reference's, in both image layouts; `test_torch_cnn_mobilenet_full.py`
holds the full structure at a narrow width.

Seeded states are carried over with `load_singa_tpu_states` (the
reference's `get_states()` names, `blocks.layers.0.dw.W` among them), on
2 images of 16 px; SGD with momentum 0.9 and weight decay 5e-4 at lr
0.01 for one step (`helper_torch_parity.check_cnn_training` says what is
compared). fp32 on both sides: the eval-mode logits (against the
reference's NCHW ones: the function is the same in both layouts), the
state after compile, the first step's logits and loss, the gradients
and the state after the step agree within 1e-4, absolute and relative
(the convolutions sum in another order). The depthwise convs are
grouped `Conv2d`s (groups = channels) on both sides, and the last units
(2 x 1 x 1 values a channel) take the degenerate-statistics BatchNorm.

Why 16 px: the BatchNorm moments are E[x] and E[x^2] in fp32 in both
packages, and a depthwise conv of a ReLU output has a large mean beside
its spread, so var = E[x^2] - E[x]^2 loses digits. The reference's
CPU reductions sum in order (1.9e-6 relative error on 2048 values a
channel, against 1.1e-7 for PyTorch's), and at 32 px its first units'
gradients part from their fp64 values by up to 1e-2 (measured; the
port's stay within 3e-5). At 16 px the stem's channels hold 512 values.

Then the ONNX round trip (the port's export, its own codec, its import:
every depthwise conv a grouped `Conv` node), a unit built without its
width, and the trainer for one epoch on a slice of the synthetic CIFAR
set.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu.models import mobilenet as jax_mobilenet
from singa_tpu_torch import autograd, sonnx
from singa_tpu_torch.models import mobilenet
from tests.helper_torch_parity import (check_cnn_eval, check_cnn_training,
                                       ref_cnn_case, set_ref_states)

LAYOUTS = ["NCHW", "NHWC"]


def _port():
    return mobilenet.mobilenet_v1_cifar(device="cpu")


@pytest.fixture(autouse=True)
def _flags():
    yield
    autograd.training = False
    jax_autograd.training = False


@pytest.fixture(scope="module")
def case():
    return ref_cnn_case(jax_mobilenet.mobilenet_v1_cifar, (2, 3, 16, 16), 2)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_scores_like_the_reference(case, lay):
    _, states, x, _, want = case
    check_cnn_eval(states, _port, x, want, lay, 1e-4)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_trains_like_the_reference(case, lay):
    ref, states, x, y, _ = case
    set_ref_states(ref, states)
    losses = check_cnn_training(ref, states, _port, x, y, lay, lr=0.01,
                                tol=1e-4, tol_steps=1e-4, steps=1)
    assert np.isfinite(losses).all()


def test_unit_without_its_width_makes_the_depthwise_conv_at_first_call():
    """The reference's `initialize(x)`: the depthwise conv follows the
    input width, on the unit's device and from its generator."""
    unit = mobilenet._SepBlock(16, stride=2, device="cpu")
    assert not hasattr(unit, "dw")
    y = unit(torch.zeros(2, 12, 8, 8))
    assert tuple(y.shape) == (2, 16, 4, 4)
    assert tuple(unit.dw.W.shape) == (12, 1, 3, 3) and unit.dw.group == 12
    assert sorted(unit.get_params()) == [
        "bn_dw.offset", "bn_dw.scale", "bn_pw.offset", "bn_pw.scale",
        "dw.W", "pw.W"]


def test_onnx_round_trip(case):
    _, states, x, _, want = case
    m = check_cnn_eval(states, _port, x, want, "NHWC", 1e-4)
    blob = sonnx.proto.encode_model(sonnx.to_onnx(m, [torch.from_numpy(x)]))
    convs = [n for n in sonnx.proto.decode_model(blob).graph.node
             if n.op_type == "Conv"]
    groups = [next((a.i for a in n.attribute if a.name == "group"), 1)
              for n in convs]
    assert len(convs) == 27 and sum(g > 1 for g in groups) == 13
    (got,) = sonnx.prepare(blob, device="cpu").run([x])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_trainer_runs_an_epoch(monkeypatch, capsys):
    from singa_tpu_torch.examples import cnn_cifar10

    full = cnn_cifar10.data.load_cifar10
    monkeypatch.setattr(cnn_cifar10.data, "load_cifar10",
                        lambda: full(n_train=128, n_val=32))
    rc = cnn_cifar10.main(["--device", "cpu", "--model", "mobilenet",
                           "--epochs", "1", "--batch", "32"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "epoch 0: loss" in out, out
