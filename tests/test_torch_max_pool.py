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

Tie-heavy inputs (x rounded to a few levels, so windows hold plateaus of
equal maxima) exercise the first-match rule where windows overlap, and a
PyTorch emulation of the CUDA kernel's algorithm (csrc/max_pool_bwd.cu:
dx in tiles; each window covering a tile decided once, its first
maximum's offset kept; then each dx element gathers dy from the covering
windows it won, chunk by chunk) is held against the plain version and
the reference.
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


# tie-heavy cases: (shape, window, strides, pads, dtype, levels); x is
# rounded to multiples of 1/levels (levels 0: one constant plateau)
TIE_CASES = [
    ((2, 12, 12, 8), (3, 3), (1, 1), (1, 1), "float32", 2),
    ((2, 11, 13, 8), (3, 3), (2, 2), (1, 1), "float32", 1),
    ((1, 9, 11, 4), (3, 2), (1, 2), (1, 0), "float32", 2),
    ((2, 10, 9, 8), (2, 3), (1, 1), (0, 1), "float32", 0),
    ((2, 12, 12, 8), (3, 3), (1, 1), (1, 1), "bfloat16", 2),
    ((2, 16, 16, 16), (2, 2), (2, 2), (0, 0), "bfloat16", 1),
]


def _plateau_inputs(shape, win, strd, pad, levels, seed=7):
    x, dy = _inputs(shape, win, strd, pad, seed)
    x = np.round(x * levels) / levels if levels else np.ones_like(x)
    return x.astype(np.float32), dy


def _first_cover(i, k, s, p):
    """First window (along one axis) that covers position i."""
    t = i + p - k + 1
    return 0 if t <= 0 else -(-t // s)


def _kernel_emulation(x, y, dy, window, strides, pads, tile, chunk):
    """dx as csrc/max_pool_bwd.cu computes it, over all (n, c) at once:
    tiles of tile = (bh, bw) dx positions; for each chunk (ca, cb) of the
    windows that cover a tile, phase 1 keeps each window's first offset
    whose x equals y (-1 if none) and its dy, phase 2 adds to every dx
    position of the tile dy of the chunk's covering windows whose offset
    is its own, in fp32."""
    n, h, w, c = x.shape
    oh, ow = y.shape[1:3]
    (kh, kw), (sh, sw), (ph, pw) = window, strides, pads
    (bh, bw), (ca, cb) = tile, chunk
    xf, yf, dyf = x.float(), y.float(), dy.float()
    dx = torch.zeros((n, h, w, c))
    for h0 in range(0, h, bh):
        for w0 in range(0, w, bw):
            h1, w1 = min(h, h0 + bh) - 1, min(w, w0 + bw) - 1
            a0 = _first_cover(h0, kh, sh, ph)
            a1 = min(oh - 1, (h1 + ph) // sh)
            b0 = _first_cover(w0, kw, sw, pw)
            b1 = min(ow - 1, (w1 + pw) // sw)
            for ac in range(a0, a1 + 1, ca):
                for bc in range(b0, b1 + 1, cb):
                    wins = [(a, b) for a in range(ac, min(ac + ca, a1 + 1))
                            for b in range(bc, min(bc + cb, b1 + 1))]
                    off = {}
                    for a, b in wins:  # phase 1
                        o = torch.full((n, c), -1)
                        for dr in range(kh):
                            for dq in range(kw):
                                r, q = a * sh - ph + dr, b * sw - pw + dq
                                if 0 <= r < h and 0 <= q < w:
                                    hit = (o < 0) & (xf[:, r, q]
                                                     == yf[:, a, b])
                                    o[hit] = dr * kw + dq
                        off[a, b] = o
                    for hh in range(h0, h1 + 1):  # phase 2
                        for ww in range(w0, w1 + 1):
                            for a, b in wins:
                                dr, dq = hh + ph - a * sh, ww + pw - b * sw
                                if 0 <= dr < kh and 0 <= dq < kw:
                                    won = off[a, b] == dr * kw + dq
                                    dx[:, hh, ww] += torch.where(
                                        won, dyf[:, a, b], 0.0)
    return dx.to(x.dtype)


@pytest.mark.parametrize("shape,win,strd,pad,dt,levels", TIE_CASES)
def test_tie_plateaus_match_reference(kernel_on, shape, win, strd, pad,
                                      dt, levels):
    """Plateaus of equal maxima under overlapping or padded windows: the
    port's backward picks the reference's positions (select-and-scatter's
    first match in row-major window order). Values: on a plateau one
    position can win up to k^2 windows, and XLA's scatter adds those in
    the operand dtype, the port in fp32; so in bf16 the values are held
    against the reference run in fp32 on the same bf16 values, its dx
    rounded once to bf16."""
    x, dy = _plateau_inputs(shape, win, strd, pad, levels)
    tdt = getattr(torch, dt)
    _, g_got = _port(x, dy, win, strd, pad, tdt)
    _, g_want = _jax(x, dy, win, strd, pad, getattr(jnp, dt))
    np.testing.assert_array_equal(g_got != 0, g_want != 0)
    xs, dys = (torch.from_numpy(a).to(tdt).float().numpy() for a in (x, dy))
    _, g_fp32 = _jax(xs, dys, win, strd, pad, jnp.float32)
    g_fp32 = torch.tensor(g_fp32).to(tdt).float().numpy()
    np.testing.assert_allclose(g_got, g_fp32, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("tile,chunk", [((4, 4), (2, 2)),
                                        ((3, 16), (9, 9)),
                                        ((16, 1), (1, 3))])
@pytest.mark.parametrize("shape,win,strd,pad,dt,levels", TIE_CASES)
def test_kernel_algorithm_matches_plain_and_reference(
        kernel_on, shape, win, strd, pad, dt, levels, tile, chunk):
    """The kernel's algorithm, at several tile and chunk sizes (windows
    straddling tiles are decided by each), gives the plain version's dx
    and the reference's positions."""
    x, dy = _plateau_inputs(shape, win, strd, pad, levels)
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    dyt = torch.from_numpy(dy).to(getattr(torch, dt))
    y = mp._fwd(xt, win, strd, pad)
    got = _kernel_emulation(xt, y, dyt, win, strd, pad, tile, chunk)
    plain = mp._max_pool_bwd_plain(xt, y, dyt, win, strd, pad)
    assert torch.equal(got != 0, plain != 0)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=TOL[dt], atol=TOL[dt])
    _, g_want = _jax(x, dy, win, strd, pad, getattr(jnp, dt))
    np.testing.assert_array_equal(got.float().numpy() != 0, g_want != 0)
