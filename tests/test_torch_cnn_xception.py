"""The port's `xception_cifar` (singa_tpu_torch.models.xception), the
CIFAR-10 trainer's Xception (stride-1 stem, 4 middle blocks), against
the reference's, in both image layouts, on 2 images of 16 px: the exit
flow's separable units see 2 x 1 x 1 values a channel, so their
BatchNorms take the degenerate-statistics path (N*H*W < 16) in both
packages. `test_torch_cnn_xception_stats.py` holds an input whose exit
flow does not, and `test_torch_cnn_xception_full.py` the full structure
at a narrow width.

Seeded states are carried over with `load_singa_tpu_states` (the
reference's names, `entry.layers.0.seps.1.layers.0.depthwise.W` among
them); SGD with momentum 0.9 and weight decay 5e-4 at lr 0.01 for one
step (`helper_torch_parity.check_cnn_training` says what is compared).
fp32 on both sides: the eval-mode logits (against the reference's NCHW
ones), the state after compile, the first step's logits and loss, the
gradients and the state after the step agree within 1e-4, absolute and
relative (the convolutions sum in another order). Under NHWC the four
max-pools a step run through the port's max-pool with its kernel
switched on (the plain version here), the reference's in interpret
mode. Why small images: `test_torch_cnn_mobilenet.py`.

Then the ONNX round trip, a block built without its width, and the
trainer for one epoch on a slice of the synthetic CIFAR set.
"""

import importlib

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu_torch import autograd, sonnx
from singa_tpu_torch.ops import max_pool
from tests.helper_torch_parity import (check_cnn_eval, check_cnn_training,
                                       ref_cnn_case, set_ref_states)

LAYOUTS = ["NCHW", "NHWC"]
# the packages' `models.xception` names the constructor, so the modules
# are imported by their full names
jax_xception = importlib.import_module("singa_tpu.models.xception")
xception = importlib.import_module("singa_tpu_torch.models.xception")


def _port():
    return xception.xception_cifar(device="cpu")


@pytest.fixture(autouse=True)
def _flags():
    max_pool.set_pool_kernel_enabled(True)
    yield
    max_pool.set_pool_kernel_enabled(False)
    autograd.training = False
    jax_autograd.training = False


@pytest.fixture(scope="module")
def case():
    return ref_cnn_case(jax_xception.xception_cifar, (2, 3, 16, 16), 6)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_scores_like_the_reference(case, lay):
    _, states, x, _, want = case
    check_cnn_eval(states, _port, x, want, lay, 1e-4)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_trains_like_the_reference(case, lay):
    ref, states, x, y, _ = case
    set_ref_states(ref, states)
    with pytest.warns(UserWarning, match="degenerate"):
        losses = check_cnn_training(ref, states, _port, x, y, lay, lr=0.01,
                                    tol=1e-4, tol_steps=1e-4, steps=1)
    assert np.isfinite(losses).all()


def test_block_without_its_width_makes_its_units_at_first_call():
    """The reference's `initialize(x)`: the separable units and the
    shortcut follow the input width; `short` is None where the shape is
    kept, and `relus` hold no parameters."""
    grow = xception._XBlock(24, 2, stride=2, device="cpu")
    keep = xception._XBlock(16, 3, device="cpu")
    assert not hasattr(grow, "seps") and not hasattr(keep, "seps")
    assert tuple(grow(torch.zeros(2, 16, 8, 8)).shape) == (2, 24, 4, 4)
    assert tuple(keep(torch.zeros(2, 16, 8, 8)).shape) == (2, 16, 8, 8)
    assert keep.short is None and grow.short is not None
    assert tuple(grow.seps[0].layers[0].depthwise.W.shape) == (16, 1, 3, 3)
    assert tuple(grow.seps[1].layers[0].depthwise.W.shape) == (24, 1, 3, 3)
    assert sorted(grow.get_params())[:3] == [
        "seps.0.layers.0.depthwise.W", "seps.0.layers.0.pointwise.W",
        "seps.0.layers.1.offset"]
    assert not list(keep.relus.parameters())


def test_onnx_round_trip(case):
    _, states, x, _, want = case
    m = check_cnn_eval(states, _port, x, want, "NHWC", 1e-4)
    blob = sonnx.proto.encode_model(sonnx.to_onnx(m, [torch.from_numpy(x)]))
    kinds = [n.op_type for n in sonnx.proto.decode_model(blob).graph.node]
    # one Add a block (3 entry, 4 middle, the exit block) and fc's bias
    assert kinds.count("MaxPool") == 4 and kinds.count("Add") == 9
    (got,) = sonnx.prepare(blob, device="cpu").run([x])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_trainer_runs_an_epoch(monkeypatch, capsys):
    from singa_tpu_torch.examples import cnn_cifar10

    full = cnn_cifar10.data.load_cifar10
    monkeypatch.setattr(cnn_cifar10.data, "load_cifar10",
                        lambda: full(n_train=64, n_val=16))
    rc = cnn_cifar10.main(["--device", "cpu", "--model", "xception",
                           "--epochs", "1", "--batch", "16"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "epoch 0: loss" in out, out
