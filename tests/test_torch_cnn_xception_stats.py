"""`xception_cifar` against the reference on an input whose every
BatchNorm takes batch statistics: 16 images of 16 px, so the exit
flow's units see 16 x 1 x 1 values a channel (not below
DEGENERATE_STAT_COUNT); `test_torch_cnn_xception.py`'s input takes the
degenerate path.

The eval-mode logits, the state after compile and the first step's
logits and loss agree within 1e-4, as there. The gradients cannot: an
exit flow of 16 values a channel means 4096 at the stem, and there the
reference's fp32 sums on the CPU (in order: 1.9e-6 relative error on
2048 values, against PyTorch's 1.1e-7) part its stem gradients from
their fp64 values by up to 2.5e-2 beyond 1e-4 * (1 + |g|) (measured),
while the port's stay within that 1e-4. So the port's fp32 gradients are
held to its fp64 ones within 1e-4, and to the reference's within 3e-2
(the state after the step, lr 0.01, within 1e-3)."""

import importlib
import warnings

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu_torch import autograd
from singa_tpu_torch.model import load_singa_tpu_states
from singa_tpu_torch.ops import max_pool
from tests.helper_torch_parity import (check_cnn_eval, check_cnn_training,
                                       ref_cnn_case, set_ref_states)

LAYOUTS = ["NCHW", "NHWC"]
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
    return ref_cnn_case(jax_xception.xception_cifar, (16, 3, 16, 16), 8)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_scores_like_the_reference(case, lay):
    _, states, x, _, want = case
    check_cnn_eval(states, _port, x, want, lay, 1e-4)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_trains_like_the_reference_on_batch_statistics(case, lay):
    ref, states, x, y, _ = case
    set_ref_states(ref, states)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        losses = check_cnn_training(ref, states, _port, x, y, lay, lr=0.01,
                                    tol=1e-4, tol_steps=1e-3, steps=1,
                                    tol_grads=3e-2)
    assert not [w for w in seen if "degenerate" in str(w.message)]
    assert np.isfinite(losses).all()


def test_port_gradients_hold_to_float64(case):
    _, states, x, y, _ = case

    def grads(dtype):
        m = _port()
        load_singa_tpu_states(m, states)
        m.to(dtype).train()
        xt = torch.from_numpy(x).to(dtype)
        with torch.no_grad():
            m.forward(xt)  # compile's forward: the statistics move once
        loss = autograd.softmax_cross_entropy(m.forward(xt),
                                              torch.from_numpy(y).long())
        names = {id(p): n for n, p in m.named_parameters()}
        return {names[id(p)]: g.double().numpy()
                for p, g in autograd.grad_pairs(loss)}

    g32, g64 = grads(torch.float32), grads(torch.float64)
    assert sorted(g32) == sorted(g64)
    for k, v in g64.items():
        np.testing.assert_allclose(g32[k], v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
