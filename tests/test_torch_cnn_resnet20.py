"""Port's `resnet20_cifar` (the CIFAR-10 trainer's resnet) trains like
the reference's, in both image layouts.

Seeded states are carried over with `load_singa_tpu_states`; 2 images
of 32 px; SGD with momentum 0.9 and weight decay 5e-4 for 3 steps at lr
0.01 (`helper_torch_parity.check_cnn_training` says what is compared).
fp32 on both sides. The state after compile, the first step's logits
and loss and the gradients agree within 1e-4 (measured: at most 7e-6
relative; the convolutions sum in another order); the later losses and
the state after 3 steps within 1e-3 (measured: at most 2.7e-4), because a ReLU input that lies within rounding of 0 can take
another side in the two packages, and the steps carry that on. (With 4
images such a ReLU already parts the first step's gradients, by up to
2e-3 relative in the first stages.)
"""

import numpy as np
import pytest

from singa_tpu import autograd as jax_autograd
from singa_tpu.models.resnet import resnet20_cifar as jax_resnet20_cifar
from singa_tpu_torch import autograd
from singa_tpu_torch.models.resnet import resnet20_cifar
from tests.helper_torch_parity import check_cnn_training, rand, ref_cnn


@pytest.fixture(autouse=True)
def _flags():
    yield
    autograd.training = False
    jax_autograd.training = False


@pytest.fixture(scope="module")
def cifar():
    x = rand((2, 3, 32, 32), 2)
    ref = jax_resnet20_cifar()
    return ref, ref_cnn(ref, x, 3), x, np.array([0, 1], np.int32)


@pytest.mark.parametrize("lay", ["NCHW", "NHWC"])
def test_resnet20_cifar_trains_like_the_reference(cifar, lay):
    ref, states, x, y = cifar
    losses = check_cnn_training(ref, states,
                                lambda: resnet20_cifar(device="cpu"), x, y,
                                lay, lr=0.01, tol=1e-4, tol_steps=1e-3)
    assert losses[-1] < losses[0]
