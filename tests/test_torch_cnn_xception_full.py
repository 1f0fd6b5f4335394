"""The full Xception structure (stride-2 stem, entry, middle and exit
flows at their published widths) with one middle block,
`Xception(10, middle_reps=1)`, against the reference's in both image
layouts, on 2 images of 32 px (16 px after the stem): the comparisons
and tolerances of `test_torch_cnn_xception.py`."""

import importlib

import numpy as np
import pytest

from singa_tpu import autograd as jax_autograd
from singa_tpu_torch import autograd
from singa_tpu_torch.ops import max_pool
from tests.helper_torch_parity import (check_cnn_eval, check_cnn_training,
                                       ref_cnn_case, set_ref_states)

LAYOUTS = ["NCHW", "NHWC"]
jax_xception = importlib.import_module("singa_tpu.models.xception")
xception = importlib.import_module("singa_tpu_torch.models.xception")


def _port():
    return xception.Xception(10, middle_reps=1, device="cpu")


@pytest.fixture(autouse=True)
def _flags():
    max_pool.set_pool_kernel_enabled(True)
    yield
    max_pool.set_pool_kernel_enabled(False)
    autograd.training = False
    jax_autograd.training = False


@pytest.fixture(scope="module")
def case():
    return ref_cnn_case(lambda: jax_xception.Xception(10, middle_reps=1),
                        (2, 3, 32, 32), 10)


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
