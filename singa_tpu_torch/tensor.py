"""Tensor helpers (counterpart of singa_tpu/tensor.py), three functions
only: the int8 row quantization and the paged gather that the serving
engine's KV pools use (`singa_tpu/tensor.py:882-931`). They take and
return `torch.Tensor`s.

The rest of the reference module, the SINGA `Tensor` wrapper and its
~150 ops, is still to be ported (ROADMAP queue 1 item 3); in the port
that surface is a veneer over `torch.Tensor`, and no path that runs on
the card needs it yet.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8_rows", "dequantize_int8_rows", "paged_gather"]


def quantize_int8_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization for the serving KV pools: a
    "row" is one token's K (or V) across every head, the trailing two
    dims (H, hd), so x (..., H, hd) gives (q (..., H, hd) int8,
    scale (...) float32) with x ~= q * scale and scale = max|row| / 127.
    An all-zero row gets the reference's scale guard (1e-30 / 127), so
    its quanta are 0, not NaN. `torch.round` rounds half to even, as
    `jnp.round` does. Row granularity lets the paged cache quantize one
    new token row per decode step without re-quantizing the rows
    already in its block."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor):
    """Inverse of `quantize_int8_rows`: q (..., H, hd) int8 and scale
    (...) -> float32. Max absolute error per element is scale/2 =
    max|row|/254."""
    return q.float() * scale[..., None, None]


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor):
    """Block-indexed cache read: `pool` (NB, bs, ...) holds NB blocks of
    bs rows, `page_table` (S, P) maps each of S slots to its P blocks.
    Returns (S, P*bs, ...): slot s's pages concatenated in table order,
    the contiguous view a dense per-slot cache would hold. Logical
    position p of slot s lives at pool[page_table[s, p // bs], p % bs].
    Pure data movement, so values are bitwise the dense layout's."""
    idx = torch.as_tensor(page_table, device=pool.device).long()
    s, p = idx.shape
    got = pool.index_select(0, idx.reshape(-1))  # (S*P, bs, ...)
    return got.reshape((s, p * pool.shape[1]) + tuple(pool.shape[2:]))
