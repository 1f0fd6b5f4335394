"""Port's NHWC max-pool (singa_tpu_torch.ops.max_pool) against the
reference's (singa_tpu.ops.max_pool) on the same seeded inputs.

The reference runs its Pallas backward in interpret mode where its
`_pick_cblock` takes the shape, and XLA's select-and-scatter where it
falls back; the port runs the kernel's plain version (`_max_pool_bwd_plain`,
what its wrapper runs on CPU tensors). The inputs are ReLU-clamped, so
windows tie at exact zeros. Held: the same selected positions (equal
nonzero patterns) and the values within 1e-6 in fp32 and 1e-2 in bf16
(the port sums in fp32 where XLA's scatter adds in the operand dtype),
as `tests/test_max_pool_kernel.py` holds the reference's kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import max_pool as jax_mp
from singa_tpu_torch.ops import max_pool as mp
from tests.helper_torch_parity import rand

# the reference's CASES (tests/test_max_pool_kernel.py), dtypes by name
CASES = [
    ((2, 16, 16, 8), (3, 3), (2, 2), (1, 1), "float32"),
    ((2, 15, 17, 8), (3, 3), (2, 2), (1, 1), "float32"),
    ((2, 16, 16, 8), (2, 2), (2, 2), (0, 0), "bfloat16"),
    ((1, 9, 11, 4), (3, 2), (1, 2), (1, 0), "float32"),
    ((2, 12, 12, 8), (3, 3), (1, 1), (1, 1), "float32"),
    ((2, 16, 16, 16), (3, 3), (2, 2), (1, 1), "float32"),
    ((1, 14, 16, 8), (3, 3), (2, 2), (1, 1), "bfloat16"),
    ((2, 16, 16, 64), (3, 3), (2, 2), (1, 1), "bfloat16"),
]
TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.fixture
def kernel_on():
    """Both switches on, and off again after the test."""
    jax_mp.set_pool_kernel_enabled(True)
    mp.set_pool_kernel_enabled(True)
    yield
    jax_mp.set_pool_kernel_enabled(False)
    mp.set_pool_kernel_enabled(False)


def _inputs(shape, win, strd, pad, seed=0):
    """ReLU-clamped x and a dy of the pooled shape, fp32 numpy."""
    x = np.maximum(rand(shape, seed), 0.0)
    oh = (shape[1] + 2 * pad[0] - win[0]) // strd[0] + 1
    ow = (shape[2] + 2 * pad[1] - win[1]) // strd[1] + 1
    return x, rand((shape[0], oh, ow, shape[3]), seed + 1)


def _jax(x, dy, win, strd, pad, dt):
    xj = jnp.asarray(x).astype(dt)
    dyj = jnp.asarray(dy).astype(dt)

    def loss(a):
        y = jax_mp.maxpool2d_nhwc(a, win, strd, pad)
        return jnp.vdot(y.astype(jnp.float32), dyj.astype(jnp.float32))

    y = jax_mp.maxpool2d_nhwc(xj, win, strd, pad)
    g = jax.grad(loss)(xj)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(g.astype(jnp.float32)))


def _port(x, dy, win, strd, pad, dt):
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    y = mp.maxpool2d_nhwc(xt, win, strd, pad)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(dy).to(dt))
    assert g.dtype == dt
    return y.detach().float().numpy(), g.float().numpy()


@pytest.mark.parametrize("shape,win,strd,pad,dt", CASES)
def test_grad_matches_reference_kernel(kernel_on, shape, win, strd, pad,
                                       dt):
    x, dy = _inputs(shape, win, strd, pad)
    before = mp.MAX_POOL_BWD_LAUNCHES
    y_want, g_want = _jax(x, dy, win, strd, pad, getattr(jnp, dt))
    y_got, g_got = _port(x, dy, win, strd, pad, getattr(torch, dt))
    assert mp.MAX_POOL_BWD_LAUNCHES == before  # CPU: the plain version
    np.testing.assert_array_equal(y_got, y_want)
    np.testing.assert_array_equal(g_got != 0, g_want != 0)
    np.testing.assert_allclose(g_got, g_want, rtol=TOL[dt], atol=TOL[dt])


def test_disabled_by_default_and_then_pytorch_backward():
    """Off by default (the reference's default). Off, the gradient is
    PyTorch's max-pool backward, which picks the same positions as the
    plain version on ties."""
    assert not mp.pool_kernel_enabled() and not jax_mp.pool_kernel_enabled()
    x, dy = _inputs((2, 16, 16, 8), (3, 3), (2, 2), (1, 1), seed=3)
    xt = torch.from_numpy(x).requires_grad_()
    y = mp.maxpool2d_nhwc(xt, (3, 3), (2, 2), (1, 1))
    assert "MaxPool2DWithIndices" in type(y.grad_fn.next_functions[0][0]
                                          ).__name__
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    plain = mp._max_pool_bwd_plain(xt.detach(), y.detach(),
                                   torch.from_numpy(dy), (3, 3), (2, 2),
                                   (1, 1))
    np.testing.assert_array_equal(g.numpy() != 0, plain.numpy() != 0)
    np.testing.assert_allclose(g.numpy(), plain.numpy(), atol=1e-6)


def test_forward_is_reduce_window():
    x = rand((2, 8, 8, 4), 4)
    want = jax_mp._rw_fwd(jnp.asarray(x), (3, 3), (2, 2), (1, 1))
    got = mp.maxpool2d_nhwc(torch.from_numpy(x), (3, 3), (2, 2), (1, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_takes_strided_operands(kernel_on):
    """A channels-last view as x and a transposed, non-contiguous dy give
    the same dx as contiguous copies (the kernel reads the strides)."""
    x, dy = _inputs((2, 12, 10, 8), (3, 3), (2, 2), (1, 1), seed=5)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    y = mp._fwd(xt, (3, 3), (2, 2), (1, 1))
    dyt = torch.from_numpy(dy).transpose(1, 2).contiguous().transpose(1, 2)
    assert not dyt.is_contiguous()
    got = mp._max_pool_bwd(xt, y, dyt, (3, 3), (2, 2), (1, 1))
    want = mp._max_pool_bwd(xt.contiguous(), y.contiguous(),
                            dyt.contiguous(), (3, 3), (2, 2), (1, 1))
    assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 8, 4)
    y = torch.zeros(1, 4, 4, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mp._max_pool_bwd(x, y, y.double(), (3, 3), (2, 2), (1, 1))
    with pytest.raises(ValueError, match="must be"):
        mp._max_pool_bwd(x, y[:, :3], y[:, :3], (3, 3), (2, 2), (1, 1))
    with pytest.raises(ValueError, match=r"\(N, H, W, C\)"):
        mp._max_pool_bwd(x[0], y, y, (3, 3), (2, 2), (1, 1))
