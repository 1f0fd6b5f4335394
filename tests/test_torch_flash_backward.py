"""Port's flash-attention gradients (singa_tpu_torch.ops.flash_attention)
against `jax.vjp` of the reference (singa_tpu.ops.flash_attention, Pallas
in interpret mode with mxu_bf16=False) on the same seeded inputs and
cotangents.

On the CPU the port's backward runs the kernels' plain version
(`_flash_bwd_plain`); the CUDA kernels are held against it on the card by
chip_smoke.py. Tolerance: fp32 on both sides, atol 1e-5 on gradients of
order 1 (the two sides only sum in another order); the mxu_bf16 case is
held at 2e-2 (a p or dS that rounds to the other bf16 neighbour after a
last-bit difference in exp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.parallel.ring import full_attention
from tests.helper_torch_parity import jax_flash, rand, to_torch

ATOL = 1e-5

SHAPES = [
    (2, 3, 64, 64, 32),    # block-aligned
    (1, 2, 100, 100, 32),  # T not a block multiple
    (2, 2, 37, 53, 64),    # Tq != Tk, bottom-right causal
    (1, 1, 200, 160, 32),  # Tq > Tk: causal rows with an empty set
]


@pytest.fixture(autouse=True)
def _no_launches():
    counts = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
              fa.FLASH_BWD_DKV_LAUNCHES)
    yield
    assert counts == (0, 0, 0) == (
        fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
        fa.FLASH_BWD_DKV_LAUNCHES), "no kernel runs on the CPU"


def _leaves(*arrays):
    return [to_torch(a).requires_grad_() for a in arrays]


def _ref_vjp(fn, primals, cotangent):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in primals))
    return [np.asarray(g) for g in vjp(cotangent)]


def _close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), w, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_grads_match_reference(shape, causal):
    b, h, tq, tk, d = shape
    q, k, v = (rand((b, h, tq, d), 0), rand((b, h, tk, d), 1),
               rand((b, h, tk, d), 2))
    g = rand((b, h, tq, d), 3)
    want = _ref_vjp(lambda *a: jax_flash().flash_attention(
        *a, causal=causal, interpret=True, mxu_bf16=False),
        (q, k, v), jnp.asarray(g))
    tq_, tk_, tv_ = _leaves(q, k, v)
    out = fa.flash_attention(tq_, tk_, tv_, causal=causal)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), to_torch(g))
    _close(got, want)
    if causal and tq > tk:  # rows that see no key: dq is exactly 0
        assert torch.all(got[0][:, :, :tq - tk] == 0)


def test_lse_cotangent_matches_reference():
    b, h, tq, tk, d = 2, 2, 37, 53, 64
    q, k, v = (rand((b, h, tq, d), 10), rand((b, h, tk, d), 11),
               rand((b, h, tk, d), 12))
    g, g_lse = rand((b, h, tq, d), 13), rand((b, h, tq), 14)
    want = _ref_vjp(lambda *a: jax_flash().flash_attention(
        *a, causal=True, interpret=True, mxu_bf16=False, return_lse=True),
        (q, k, v), (jnp.asarray(g), jnp.asarray(g_lse)))
    leaves = _leaves(q, k, v)
    o, lse = fa.flash_attention(*leaves, causal=True, return_lse=True)
    got = torch.autograd.grad((o, lse), leaves,
                              (to_torch(g), to_torch(g_lse)))
    _close(got, want)
    # the lse cotangent alone (O unused) reaches the inputs too
    _, lse = fa.flash_attention(*leaves, causal=True, return_lse=True)
    only = torch.autograd.grad(lse, leaves, to_torch(g_lse))
    want_only = _ref_vjp(lambda *a: jax_flash().flash_attention(
        *a, causal=True, interpret=True, mxu_bf16=False,
        return_lse=True)[1], (q, k, v), jnp.asarray(g_lse))
    _close(only, want_only)


@pytest.mark.parametrize("t,causal", [(256, True), (256, False),
                                      (100, True), (100, False)])
def test_flash_attention_qkv_grads_match_reference(t, causal):
    heads, hd = 4, 32
    qkv = rand((2, t, 3 * heads * hd), 20)
    g = rand((2, t, heads * hd), 21)
    want = _ref_vjp(lambda a: jax_flash().flash_attention_qkv(
        a, heads, causal=causal, interpret=True, mxu_bf16=False),
        (qkv,), jnp.asarray(g))
    (leaf,) = _leaves(qkv)
    out = fa.flash_attention_qkv(leaf, heads, causal=causal)
    got = torch.autograd.grad(out, leaf, to_torch(g))
    assert got[0].shape == qkv.shape
    _close(got, want)


@pytest.mark.parametrize("t,causal", [(256, True), (100, True),
                                      (100, False)])
def test_attention_qkv_grads_match_reference(t, causal):
    """The dispatcher: at T=256 causal both sides take the fused flash
    path; at T=100 both split heads into full_attention."""
    heads, hd = 4, 32
    qkv = rand((2, t, 3 * heads * hd), 30)
    g = rand((2, t, heads * hd), 31)
    want = _ref_vjp(lambda a: jax_flash().attention_qkv(
        a, heads, causal=causal), (qkv,), jnp.asarray(g))
    (leaf,) = _leaves(qkv)
    got = torch.autograd.grad(
        fa.attention_qkv(leaf, heads, causal=causal), leaf, to_torch(g))
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_full_attention(causal):
    q, k, v = _leaves(rand((2, 2, 40, 32), 40), rand((2, 2, 56, 32), 41),
                      rand((2, 2, 56, 32), 42))
    g = to_torch(rand((2, 2, 40, 32), 43))
    scale = 32 ** -0.5
    o, lse = fa._flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                 causal, scale, False)
    delta = (g * o).sum(-1)
    got = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), g, lse,
                              delta, causal, scale, False)
    want = torch.autograd.grad(full_attention(q, k, v, causal=causal),
                               (q, k, v), g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL)


def test_mxu_bf16_grads_match_reference():
    """bf16 operands, fp32 accumulation, one block on both sides (so both
    round the same p and dS)."""
    q, k, v = (rand((1, 2, 100, 64), 50 + i) for i in range(3))
    g = rand((1, 2, 100, 64), 53)
    want = _ref_vjp(lambda *a: jax_flash().flash_attention(
        *a, causal=True, interpret=True, mxu_bf16=True),
        (q, k, v), jnp.asarray(g))
    leaves = _leaves(q, k, v)
    got = torch.autograd.grad(
        fa.flash_attention(*leaves, causal=True, mxu_bf16=True), leaves,
        to_torch(g))
    _close(got, want, atol=2e-2)
    exact = torch.autograd.grad(fa.flash_attention(*leaves, causal=True),
                                leaves, to_torch(g))
    assert not torch.equal(got[0], exact[0])  # the rounding really happened


def test_bf16_grads_keep_their_dtype():
    q, k, v = (to_torch(rand((1, 2, 70, 32), 60 + i)).bfloat16()
               .requires_grad_() for i in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert all(x.dtype == torch.bfloat16 for x in grads)
    ref = [x.float().detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(full_attention(*ref, causal=True).sum(), ref)
    for x, y in zip(grads, want):
        np.testing.assert_allclose(x.float().numpy(), y.numpy(), atol=5e-2)


def test_incoming_gradient_of_any_layout():
    """An expanded zero, a transposed view and a missing cotangent all
    reach the backward; it takes them without refusing."""
    q, k, v = _leaves(*(rand((1, 2, 16, 32), 70 + i) for i in range(3)))
    o = fa.flash_attention(q, k, v, causal=True)
    zero = torch.zeros(()).expand(o.shape)
    assert all(torch.all(x == 0) for x in
               torch.autograd.grad(o, (q, k, v), zero, retain_graph=True))
    gt = to_torch(rand((1, 2, 32, 16), 74)).transpose(-1, -2)
    got = torch.autograd.grad(o, (q, k, v), gt, retain_graph=True)
    want = torch.autograd.grad(o, (q, k, v), gt.contiguous())
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    _, lse = fa.flash_attention(q, k, v, return_lse=True)
    only_lse = torch.autograd.grad(lse.sum(), (q, k, v))  # no O cotangent
    assert all(torch.isfinite(x).all() for x in only_lse)


def test_flash_backward_wrapper_refuses_bad_operands():
    q, k, v = (to_torch(rand((1, 2, 16, 32), i)) for i in range(3))
    lse = torch.zeros(1, 2, 16)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="delta"):
        fa._flash_bwd(q, k, v, q, lse, lse[..., :8], dq, dk, dv, True,
                      0.1, False)
    with pytest.raises(TypeError, match="do"):
        fa._flash_bwd(q, k, v, q.double(), lse, lse, dq, dk, dv, True,
                      0.1, False)
