"""Two of the port's CIFAR-10 trainer models (singa_tpu_torch.models)
against the reference's, in both image layouts: `vgg16_cifar` and
`alexnet_cifar` score in eval mode and take one training step, with
dropout at p=0 in both packages (the two draw other dropout masks).
`test_torch_cnn_resnet20.py` trains the third, `resnet20_cifar`. Both VGG and AlexNet max-pool without padding ((2, 2)
windows, stride 2), under NHWC through the port's max-pool with its
kernel switched on (the plain version here).

Seeded states are carried over with `load_singa_tpu_states`, on 2
images of 32 px; SGD with momentum 0.9 and weight decay 5e-4 at lr
0.01 (`helper_torch_parity.check_cnn_training` says what is compared).
fp32 on both sides: the eval-mode logits, the state after compile, the
first step's logits and loss, the gradients and the state after the
step agree within 1e-4 (the convolutions sum in another order). That
holds for inputs where no ReLU input and no gap between a window's two
largest values lies within rounding: where one does, the two packages
can take another side of it, and the gradients below it part by up to
~2e-3 (seen on other seeded inputs, with a ReLU input at 3e-7).
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu import models as jax_models
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import autograd, layer, models
from singa_tpu_torch.model import load_singa_tpu_states
from singa_tpu_torch.ops import max_pool
from tests.helper_torch_parity import (check_cnn_training, rand, ref_cnn,
                                       set_ref_states)

LAYOUTS = ["NCHW", "NHWC"]


@pytest.fixture(autouse=True)
def _flags():
    max_pool.set_pool_kernel_enabled(True)
    yield
    max_pool.set_pool_kernel_enabled(False)
    autograd.training = False
    jax_autograd.training = False


def _batch(seed):
    return rand((2, 3, 32, 32), seed), np.array([3, 7], np.int32)


def _no_dropout(model, dropout_type):
    for lyr in model.classifier.layers:
        if isinstance(lyr, dropout_type):
            lyr.p = 0.0
    return model


@pytest.fixture(scope="module")
def zoo():
    """name -> (reference model, seeded states, x, y, port constructor)"""
    out = {}
    for seed, (name, jax_ctor, ctor) in enumerate([
            ("vgg16_cifar", jax_models.vgg16_cifar, models.vgg16_cifar),
            ("alexnet_cifar", jax_models.alexnet_cifar,
             models.alexnet_cifar)]):
        x, y = _batch(2 * seed + 2)
        ref = jax_ctor()
        out[name] = (ref, ref_cnn(ref, x, 2 * seed + 3), x, y, ctor)
    return out


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("name", ["vgg16_cifar", "alexnet_cifar"])
def test_scores_and_steps_like_the_reference(zoo, name, lay):
    ref, states, x, y, ctor = zoo[name]
    set_ref_states(ref, states)
    ref.set_image_layout(lay)
    ref.eval()
    want = np.asarray(ref(from_numpy(x)).data)
    port = ctor(device="cpu")
    load_singa_tpu_states(port, states)
    port.set_image_layout(lay)
    port.eval()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)

    import singa_tpu.layer as jax_layer
    _no_dropout(ref, jax_layer.Dropout)
    check_cnn_training(ref, states,
                       lambda: _no_dropout(ctor(device="cpu"),
                                           layer.Dropout),
                       x, y, lay, lr=0.01, tol=1e-4, tol_steps=1e-4,
                       steps=1)
