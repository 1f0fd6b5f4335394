"""Port's ResNets (singa_tpu_torch.models.resnet) train like the
reference's (singa_tpu.models.resnet), in both image layouts.

`ResNet(Bottleneck, [1, 1, 1, 1], 10)`, the ImageNet ResNet at its
smallest depth, on a seeded batch of 2 images of 32 px: the stem
max-pool runs on (2, 16, 16, 64) (under NHWC through the port's
max-pool with its kernel switched on, the plain version here), and the
BatchNorms of stages 3 and 4 (2 x 2 x 2 and 2 x 1 x 1 elements per
channel) take the degenerate-statistics guard. Seeded states are
carried over with
`load_singa_tpu_states`; SGD with momentum 0.9 and weight decay 5e-4
for 3 steps at lr 0.01 (`helper_torch_parity.check_cnn_training` says
what is compared). fp32 on both sides. The state after compile, the
first step's logits and loss and the gradients agree within 1e-4
(measured: at most 8e-6 relative; the convolutions sum in another
order); the later losses and the state after 3 steps within 1e-3
(measured: at most 2e-6 here, 2.7e-4 for resnet20_cifar in
`test_torch_cnn_resnet20.py`), because a ReLU input that lies within
rounding of 0 can take another side in the two packages, and the steps
carry that on.
"""

import numpy as np
import pytest

from singa_tpu import autograd as jax_autograd
from singa_tpu.models.resnet import Bottleneck as JaxBottleneck
from singa_tpu.models.resnet import ResNet as JaxResNet
from singa_tpu_torch import autograd
from singa_tpu_torch.models.resnet import Bottleneck, ResNet
from singa_tpu_torch.ops import max_pool
from tests.helper_torch_parity import check_cnn_training, rand, ref_cnn

LAYOUTS = ["NCHW", "NHWC"]


@pytest.fixture(autouse=True)
def _flags():
    max_pool.set_pool_kernel_enabled(True)
    yield
    max_pool.set_pool_kernel_enabled(False)
    autograd.training = False
    jax_autograd.training = False


def _batch(n, seed):
    return rand((n, 3, 32, 32), seed), (np.arange(n) % 10).astype(np.int32)


@pytest.fixture(scope="module")
def small():
    x, y = _batch(2, 0)
    ref = JaxResNet(JaxBottleneck, [1, 1, 1, 1], 10)
    return ref, ref_cnn(ref, x, 1), x, y


def test_names_are_the_reference_names(small):
    _, states, _, _ = small
    port = ResNet(Bottleneck, [1, 1, 1, 1], 10, device="cpu")
    own = [n for n, _ in port.named_parameters()]
    own += [n for n, _ in port.named_buffers()]
    assert sorted(own) == sorted(states)
    assert "layer1.layers.0.conv1.layers.0.W" in own
    assert "layer4.layers.0.downsample.layers.1.running_var" in own


@pytest.mark.parametrize("lay", LAYOUTS)
def test_small_resnet_trains_like_the_reference(small, lay):
    ref, states, x, y = small
    before = max_pool.MAX_POOL_BWD_LAUNCHES
    with pytest.warns(UserWarning, match="degenerate"):
        losses = check_cnn_training(
            ref, states, lambda: ResNet(Bottleneck, [1, 1, 1, 1], 10,
                                        device="cpu"),
            x, y, lay, lr=0.01, tol=1e-4, tol_steps=1e-3)
    assert np.isfinite(losses).all()
    assert max_pool.MAX_POOL_BWD_LAUNCHES == before  # CPU: plain version


def test_eval_uses_running_statistics_and_records_no_tape(small):
    """In eval mode a call scores with the running statistics (they do
    not move) and keeps no tape; the output is the same in both
    layouts."""
    _, states, x, _ = small
    from singa_tpu_torch.model import load_singa_tpu_states
    import torch

    outs = []
    for lay in LAYOUTS:
        m = ResNet(Bottleneck, [1, 1, 1, 1], 10, device="cpu")
        load_singa_tpu_states(m, states)
        m.set_image_layout(lay)
        m.eval()
        out = m(torch.from_numpy(x))
        assert not out.requires_grad
        np.testing.assert_array_equal(m.bn1.running_mean.numpy(),
                                      states["bn1.running_mean"])
        outs.append(out.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)
