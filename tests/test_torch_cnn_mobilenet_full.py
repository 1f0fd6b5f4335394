"""The full MobileNetV1 structure (stride-2 stem, 13 units) at a narrow
width, `MobileNetV1(10, alpha=0.25)`, against the reference's in both
image layouts, on 2 images of 32 px (16 px after the stem): the
comparisons and tolerances of `test_torch_cnn_mobilenet.py`."""

import numpy as np
import pytest

from singa_tpu import autograd as jax_autograd
from singa_tpu.models import mobilenet as jax_mobilenet
from singa_tpu_torch import autograd
from singa_tpu_torch.models import mobilenet
from tests.helper_torch_parity import (check_cnn_eval, check_cnn_training,
                                       ref_cnn_case, set_ref_states)

LAYOUTS = ["NCHW", "NHWC"]


def _port():
    return mobilenet.MobileNetV1(10, alpha=0.25, device="cpu")


@pytest.fixture(autouse=True)
def _flags():
    yield
    autograd.training = False
    jax_autograd.training = False


@pytest.fixture(scope="module")
def case():
    return ref_cnn_case(lambda: jax_mobilenet.MobileNetV1(10, alpha=0.25),
                        (2, 3, 32, 32), 4)


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
