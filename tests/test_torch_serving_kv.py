"""The serving engine's KV storage against the reference's.

- `tensor.quantize_int8_rows`, `dequantize_int8_rows`, `paged_gather`
  and the four `layer.paged_kv_*` ops equal singa_tpu's on the same
  arrays: exactly for fp32 data, to one int8 step for the quanta (the
  division may round the other way at a half) and the round trip's
  scale/2 bound; the port's writes go in place;
- the capacity math and `pool_bytes=` admission of
  tests/test_serving_int8.py;
- the bf16 and int8 engines' decode logits stay within that file's
  tolerance (0.15) of the fp32 engine's on the same requests, and the
  int8 engine tracks the fp32 greedy streams at its match rate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import layer as jax_layer
from singa_tpu import tensor as jax_tensor
from singa_tpu_torch import layer, tensor
from singa_tpu_torch.serving import (
    OutOfBlocksError, Request, ServingEngine, kv_block_bytes)
from tests.helper_torch_parity import rand, serving_gpt_pair

_VOCAB = 61
_W = 64
_HEADS, _HD, _LAYERS = 4, 12, 2


@pytest.fixture(scope="module")
def model():
    return serving_gpt_pair(vocab=_VOCAB, max_len=_W)[1]


def _prompt(rng, n):
    return rng.integers(0, _VOCAB, size=n).astype(np.int32)


# -- the primitives against singa_tpu -----------------------------------------


def test_quantize_rows_match_reference():
    x = rand((5, 7, 4, 12), 2, scale=3.0)
    x[1, 2] = 0.0                      # an all-zero row: the scale guard
    x[3, 4, 0, 0] = 127 * 0.25         # a row whose quanta hit halves
    x[3, 4, 1:] = 0.125 * np.arange(-23, 24)[:36].reshape(3, 12)
    qw, sw = jax_tensor.quantize_int8_rows(jnp.asarray(x))
    q, s = tensor.quantize_int8_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (5, 7)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sw))
    assert np.abs(q.numpy().astype(int) - np.asarray(qw).astype(int)
                  ).max() <= 1
    assert (q[1, 2] == 0).all() and float(s[1, 2]) == np.float32(1e-30) \
        / np.float32(127.0)
    err = (tensor.dequantize_int8_rows(q, s) - torch.from_numpy(x)).abs()
    assert (err <= s[..., None, None] / 2 + 1e-6).all()
    np.testing.assert_array_equal(
        tensor.dequantize_int8_rows(q, s).numpy(),
        np.asarray(jax_tensor.dequantize_int8_rows(jnp.asarray(q.numpy()),
                                                   sw)))


def test_paged_gather_and_kv_gather_match_reference():
    pool = rand((9, 4, 3, 5), 3)
    pt = np.array([[3, 1, 8], [0, 0, 0], [5, 2, 7]], np.int32)
    np.testing.assert_array_equal(
        tensor.paged_gather(torch.from_numpy(pool), torch.from_numpy(pt)),
        np.asarray(jax_tensor.paged_gather(jnp.asarray(pool), pt)))
    np.testing.assert_array_equal(
        layer.paged_kv_gather(torch.from_numpy(pool),
                              torch.from_numpy(pt)),
        np.asarray(jax_layer.paged_kv_gather(jnp.asarray(pool), pt)))


@pytest.mark.parametrize("op", ["token", "window", "pages", "scales"])
def test_paged_writes_match_reference_in_place(op):
    """Slot 1's row is trash (0), slot 2 overhangs the window: both land
    in block 0 on both sides. The port writes the pool it was given."""
    pool = rand((9, 4, 3, 5), 4)
    pt = np.array([[3, 1, 8], [0, 0, 0], [5, 2, 7]], np.int32)
    if op == "token":
        pos = np.array([6, 2, 11], np.int32)
        kv = rand((3, 3, 5), 5)
        args = (pt, pos, kv)
        jfn, tfn = jax_layer.paged_kv_token_write, layer.paged_kv_token_write
    elif op in ("window", "scales"):
        pos = np.array([2, 0, 9], np.int32)
        kv = rand((3, 4, 3, 5), 6)
        if op == "scales":
            pool, kv = pool[..., 0, 0].copy(), kv[..., 0, 0].copy()
        args = (pt, pos, kv)
        jfn = jax_layer.paged_kv_window_write
        tfn = layer.paged_kv_window_write
    else:
        pages = np.array([[4, 6, 0], [2, 0, 0]], np.int32)
        kv = rand((2, 3, 4, 3, 5), 7)
        args = (pages, kv)
        jfn, tfn = jax_layer.paged_kv_pages_write, layer.paged_kv_pages_write
    want = np.asarray(jfn(jnp.asarray(pool), *map(jnp.asarray, args)))
    got = torch.from_numpy(pool.copy())
    out = tfn(got, *(torch.from_numpy(a).long() if a.dtype == np.int32
                     else torch.from_numpy(a) for a in args))
    assert out is got
    keep = np.ones(len(pool), bool)
    keep[0] = False   # trash: colliding writes, any winner
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])


# -- capacity -----------------------------------------------------------------


def test_kv_block_bytes_capacity_math():
    fp = kv_block_bytes(_LAYERS, _HEADS, _HD, 16, "fp32")
    bf = kv_block_bytes(_LAYERS, _HEADS, _HD, 16, "bf16")
    i8 = kv_block_bytes(_LAYERS, _HEADS, _HD, 16, "int8")
    assert fp == 2 * _LAYERS * 16 * _HEADS * _HD * 4
    assert bf == fp // 2
    assert i8 == 2 * _LAYERS * (16 * _HEADS * _HD + 16 * 4)
    assert fp / i8 >= 1.9 and bf / i8 >= 1.8
    with pytest.raises(ValueError, match="storage format"):
        kv_block_bytes(_LAYERS, _HEADS, _HD, 16, "fp8")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_admission_capacity_at_equal_pool_bytes(model, kv_dtype):
    budget = 8 * kv_block_bytes(_LAYERS, _HEADS, _HD, 16, "fp32")

    def fill(dtype):
        eng = ServingEngine(model, slots=40, block_size=16, window=_W,
                            pool_bytes=budget, kv_dtype=dtype)
        rng = np.random.default_rng(0)
        admitted = 0
        try:
            while True:
                eng.admit(Request(admitted, _prompt(rng, 4), 8))
                admitted += 1
        except OutOfBlocksError as e:
            assert "bytes" in str(e)
        assert eng.pool_bytes == 2 * _LAYERS * eng.allocator.num_blocks * (
            16 * _HEADS * _HD * {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
            + (16 * 4 if dtype == "int8" else 0))
        return admitted, eng.allocator.capacity

    fp_admits, fp_blocks = fill("fp32")
    got, _ = fill(kv_dtype)
    assert fp_admits == fp_blocks == 7
    assert got >= (1.9 if kv_dtype == "int8" else 1.7) * fp_admits


def test_num_blocks_and_pool_bytes_are_exclusive(model):
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(model, slots=1, window=_W, num_blocks=4,
                      pool_bytes=1 << 20)
    with pytest.raises(ValueError, match="storage format"):
        ServingEngine(model, slots=1, window=_W, kv_dtype="fp8")


# -- bounded divergence -------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_quantized_logit_divergence_bounded(model, kv_dtype):
    """The fp32 engine and a quantized engine admit identical requests;
    the decode logits (`peek_logits`, which leaves the pools as they
    were) stay within the reference's 0.15."""
    rng = np.random.default_rng(9)
    prompts = [_prompt(rng, n) for n in (5, 30, 12)]

    def boot(dtype):
        eng = ServingEngine(model, slots=3, block_size=16, window=_W,
                            kv_dtype=dtype)
        for i, p in enumerate(prompts):
            eng.admit(Request(i, p.copy(), 16))
        return eng

    fp = boot("fp32")
    ref = fp.peek_logits()
    before = fp._kdata.clone()
    np.testing.assert_array_equal(fp.peek_logits(), ref)
    assert torch.equal(fp._kdata, before)  # peek restored its rows
    eng = boot(kv_dtype)
    got = eng.peek_logits()
    delta = float(np.abs(got - ref).max())
    assert 0 < delta < 0.15, delta
    # a step then continues from the same state both engines hold
    for e in (fp, eng):
        e.step()
    delta = float(np.abs(eng.peek_logits() - fp.peek_logits()).max())
    assert delta < 0.15, delta


@pytest.mark.parametrize("block_size", [16, 64])
def test_int8_staggered_streams_track_fp32(model, block_size):
    rng = np.random.default_rng(7)
    eng = ServingEngine(model, slots=4, block_size=block_size, window=_W,
                        kv_dtype="int8")
    reqs = {rid: Request(rid, _prompt(rng, n), m) for rid, (n, m) in {
        "a": (5, 20), "b": (30, 16), "c": (37, 20), "d": (12, 8),
        "e": (22, 10)}.items()}
    eng.admit(reqs["a"])
    eng.admit(reqs["b"])
    for _ in range(3):
        eng.step()
    eng.admit(reqs["c"])
    for _ in range(4):
        eng.step()
    eng.cancel("b")
    eng.admit(reqs["d"])
    eng.admit(reqs["e"])
    while eng.n_active:
        eng.step()
    for rid, req in reqs.items():
        want = model.generate(req.prompt, req.max_new, window=_W)[
            0, len(req.prompt):]
        got = np.asarray(req.tokens, np.int32)
        rate = float((got == want[:got.size]).mean())
        assert rate >= 0.9, (rid, rate)
    assert eng.decode_compiles == 1
