"""Port's flash-attention forward (singa_tpu_torch.ops.flash_attention)
against the reference (singa_tpu.ops.flash_attention, Pallas in
interpret mode) and the reference attention `full_attention`.

On the CPU the port's wrapper runs the kernel's plain version
(`_flash_fwd_plain`); the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py. Tolerance: fp32 with mxu_bf16 off
on both sides, atol 1e-5 (the two sides only sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.parallel.ring import full_attention as jax_full_attention
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
    before = fa.FLASH_FWD_LAUNCHES
    yield
    assert fa.FLASH_FWD_LAUNCHES == before == 0, "no kernel runs on CPU"


def _qkv(b, h, tq, tk, d, seed=0):
    return (rand((b, h, tq, d), seed), rand((b, h, tk, d), seed + 1),
            rand((b, h, tk, d), seed + 2))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_reference(shape, causal):
    q, k, v = _qkv(*shape)
    want_o, want_lse = jax_flash().flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, mxu_bf16=False, return_lse=True)
    got_o, got_lse = fa.flash_attention(
        to_torch(q), to_torch(k), to_torch(v), causal=causal,
        return_lse=True)
    assert got_lse.dtype == torch.float32 and got_lse.shape == shape[:3]
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=1e-6)
    oracle = jax_full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(oracle), atol=ATOL)


def test_empty_rows_are_exact_zero():
    q, k, v = (to_torch(a) for a in _qkv(1, 2, 12, 5, 32, seed=6))
    empty = 12 - 5  # causal, bottom-right: the first Tq-Tk rows see nothing
    o = fa.flash_attention(q, k, v, causal=True)
    ref = full_attention(q, k, v, causal=True)
    assert torch.all(o[:, :, :empty] == 0)
    assert torch.all(ref[:, :, :empty] == 0)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_reference(causal):
    q, k, v = _qkv(2, 2, 24, 40, 32, seed=3)
    mask = np.random.default_rng(9).random((24, 40)) > 0.3
    mask[5] = False  # a row the mask empties: exact 0 on both sides
    want = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, mask=jnp.asarray(mask))
    got = full_attention(to_torch(q), to_torch(k), to_torch(v),
                         causal=causal, mask=to_torch(mask))
    assert torch.all(got[:, :, 5] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_qkv_matches_reference(causal):
    b, t, h, hd = 2, 100, 4, 32
    qkv = rand((b, t, 3 * h * hd), 11)
    want = jax_flash().flash_attention_qkv(
        jnp.asarray(qkv), h, causal=causal, interpret=True, mxu_bf16=False)
    got = fa.flash_attention_qkv(to_torch(qkv), h, causal=causal)
    assert got.shape == (b, t, h * hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("heads,t,causal", [
    (4, 256, True),    # fused-layout kernel path on both sides
    (3, 256, True),    # odd H: the reference splits heads, the port does not
    (3, 64, False),    # under the threshold: split heads, full_attention
    (2, 512, False),   # non-causal fused threshold
])
def test_attention_qkv_matches_reference(heads, t, causal):
    qkv = rand((1, t, 3 * heads * 32), 21)
    want = jax_flash().attention_qkv(jnp.asarray(qkv), heads, causal=causal)
    got = fa.attention_qkv(to_torch(qkv), heads, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("t,causal", [(64, True), (256, True), (300, False)])
def test_attention_dispatcher_matches_reference(t, causal):
    q, k, v = _qkv(1, 2, t, t, 32, seed=30)
    want = jax_flash().attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    got = fa.attention(to_torch(q), to_torch(k), to_torch(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dispatch_thresholds_are_the_reference_values():
    ref = jax_flash()
    for name in ("FLASH_MIN_SEQ", "FLASH_MIN_SEQ_CAUSAL",
                 "FUSED_QKV_MIN_SEQ", "FUSED_QKV_MIN_SEQ_CAUSAL"):
        assert getattr(fa, name) == getattr(ref, name), name


def test_flash_switch_routes_to_full_attention(monkeypatch):
    calls = []
    real = fa._flash_fwd
    monkeypatch.setattr(fa, "_flash_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    qkv = to_torch(rand((1, 256, 3 * 64), 40))
    on = fa.attention_qkv(qkv, 2, causal=True)
    assert calls == [1]
    fa.set_flash_enabled(False)
    try:
        off = fa.attention_qkv(qkv, 2, causal=True)
    finally:
        fa.set_flash_enabled(True)
    assert calls == [1] and fa.flash_enabled()
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=ATOL)


def test_mxu_bf16_matches_reference():
    """bf16 operands, fp32 accumulation, one K block on both sides (so
    both round the same p); atol 1e-2 covers a p that rounds to the
    other bf16 neighbour after a last-bit difference in exp."""
    q, k, v = _qkv(1, 2, 100, 100, 64, seed=50)
    want = jax_flash().flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True, mxu_bf16=True)
    got = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                             causal=True, mxu_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    exact = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                               causal=True)
    assert not torch.equal(got, exact)  # the rounding really happened


def test_bf16_inputs_keep_their_dtype():
    q, k, v = (to_torch(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 70, 70, 32, seed=60))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = full_attention(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(), atol=2e-2)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "shape",
                                 "align"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (to_torch(a) for a in _qkv(1, 2, 16, 16, 32))
    if bad == "head_dim":
        q, k, v = (x[..., :16].contiguous() for x in (q, k, v))
    elif bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "stride":
        q = to_torch(rand((1, 2, 16, 64), 1))[..., ::2]
    elif bad == "shape":
        k = k[:, :1]
    else:  # rows that do not start on a 16-byte boundary
        q = torch.empty(q.numel() + 1)[1:].view(q.shape).copy_(q)
    with pytest.raises((ValueError, TypeError)) as info:
        fa.flash_attention(q, k, v)
    if bad == "align":
        assert "16-byte-aligned" in str(info.value)


@pytest.mark.parametrize("hd", [16, 96])
def test_dispatchers_route_head_dims_the_kernel_lacks(hd, monkeypatch):
    """Causal T 256 clears both thresholds, but the kernels are built for
    head dims (32, 64, 128): the dispatchers send hd 16 (`gpt_draft`'s)
    and 96 to `full_attention` instead of raising, and match the
    reference, whose kernel takes every head dim."""
    calls = []
    real = fa._flash_fwd
    monkeypatch.setattr(fa, "_flash_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    heads = 4
    qkv = rand((2, 256, 3 * heads * hd), 70 + hd)
    want = jax_flash().attention_qkv(jnp.asarray(qkv), heads, causal=True)
    got = fa.attention_qkv(to_torch(qkv), heads, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    q, k, v = _qkv(1, heads, 256, 256, hd, seed=80 + hd)
    want = jax_flash().attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True)
    got = fa.attention(to_torch(q), to_torch(k), to_torch(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert calls == []


def test_dispatcher_copies_misaligned_rows_for_the_kernel(monkeypatch):
    """A head-split q whose rows start 4 bytes past a 16-byte boundary
    (a view into wider rows) takes the kernel path through an aligned
    copy, and matches the reference."""
    seen = []
    real = fa._flash_fwd
    monkeypatch.setattr(fa, "_flash_fwd",
                        lambda q, *a: seen.append(q) or real(q, *a))
    wide = torch.from_numpy(rand((1, 2, 300, 129), 90))
    q = wide[..., 1:]
    assert q.data_ptr() % 16 and q.stride()[:3] == (77400, 38700, 129)
    k, v = (to_torch(a) for a in _qkv(1, 2, 300, 300, 128, seed=91)[1:])
    want = jax_flash().attention(jnp.asarray(q.numpy()), jnp.asarray(
        k.numpy()), jnp.asarray(v.numpy()), causal=True)
    got = fa.attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert len(seen) == 1 and seen[0].data_ptr() % 16 == 0
    assert seen[0].is_contiguous()
