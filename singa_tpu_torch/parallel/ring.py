"""Reference attention (counterpart of singa_tpu/parallel/ring.py:66-101).

`full_attention` is the plain single-device attention the flash kernel
is held against, and the attention of `GPT.generate`'s prefill and
window steps. Its semantics are the reference's, exactly:

- masked scores are `_NEG = -1e30` (not -inf, so `exp` stays NaN-free);
- the causal mask is aligned bottom-right: query i sees keys
  `k <= i + (Tk - Tq)`;
- rows with an empty attention set output an exact 0.

Layout: (B, H, T, D). Ring (sequence-parallel) attention itself belongs
to the distributed slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from singa_tpu_torch import autograd

__all__ = ["full_attention"]

_NEG = -1e30


def _dot(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum under the autocast policy (bf16 operands when it is on)."""
    a, b = autograd._mxu_cast(a, b)
    return autograd._mxu_result(torch.einsum(spec, a, b))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device reference attention; q (B,H,Tq,D), k/v (B,H,Tk,D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = _dot("bhqd,bhkd->bhqk", q, k) * scale
    valid = None
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        allowed = torch.ones(tq, tk, dtype=torch.bool,
                             device=scores.device).tril(tk - tq)
        scores = scores.masked_fill(~allowed, _NEG)
        valid = allowed
    if mask is not None:
        m = mask.to(torch.bool)
        scores = torch.where(m, scores, torch.full_like(scores, _NEG))
        valid = m if valid is None else valid & m
    p = torch.softmax(scores, dim=-1)
    out = _dot("bhqk,bhkd->bhqd", p, v)
    if valid is not None:
        # rows with an EMPTY attention set output exact 0, matching the
        # flash kernel's l == 0 convention
        out = out.masked_fill(~valid.any(dim=-1, keepdim=True), 0.0)
    return out
