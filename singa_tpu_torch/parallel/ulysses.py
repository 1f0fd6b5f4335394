"""Ulysses (all-to-all) sequence parallelism (counterpart of
singa_tpu/parallel/ulysses.py), the second long-context strategy beside
ring attention (`parallel/ring.py`).

Each rank of the sequence axis holds a SEQUENCE shard of Q/K/V. One
all-to-all per tensor turns the sequence shards into HEAD shards, every
rank runs ordinary attention over the whole sequence for its own heads
(causal masking needs no cross-rank bookkeeping), and one all-to-all
turns the output back. The exchange is `dist.all_to_all_single` over
the axis's process group inside a `torch.autograd.Function` whose
backward is the inverse exchange. At an axis of one rank nothing moves.
The head count must divide by the axis size.

Layout, as `ring_attention`: (B, H_total, T_local, D) in and out.

`all_to_all` is the same exchange on a leading (world, ...) dim, the
MoE FFN's dispatch and return (`parallel/moe.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from singa_tpu_torch.analysis import trace as _trace
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["ulysses_attention", "all_to_all"]


def _exchange(x: torch.Tensor, group, world: int, to_heads: bool,
              axis: str) -> torch.Tensor:
    """(B, H, T, D) -> (B, H/W, W*T, D) when `to_heads` (scatter the
    heads, gather the sequence in rank order), else the inverse."""
    _trace.record("all_to_all", x, axis=axis, group=group)
    b, h, t, d = x.shape
    if to_heads:  # chunk j of the heads goes to rank j
        send = x.reshape(b, world, h // world, t, d).movedim(1, 0)
    else:  # chunk j of the sequence goes back to rank j
        send = x.reshape(b, h, world, t // world, d).movedim(2, 0)
    send = send.contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    if to_heads:  # got[i]: rank i's sequence shard of my heads
        return got.movedim(0, 2).reshape(b, h // world, world * t, d)
    # got[i]: my sequence shard of rank i's heads
    return got.movedim(0, 1).reshape(b, world * h, t // world, d)


class _SeqHeads(torch.autograd.Function):
    """The all-to-all between sequence and head shards; its backward is
    the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, world, to_heads, axis):
        ctx.cfg = (group, world, to_heads, axis)
        return _exchange(x, group, world, to_heads, axis)

    @staticmethod
    def backward(ctx, g):
        group, world, to_heads, axis = ctx.cfg
        return (_exchange(g, group, world, not to_heads, axis), None, None,
                None, None)


def _swap(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    _trace.record("all_to_all", x, axis=axis, group=group)
    send = x.contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return got


class _AllToAll(torch.autograd.Function):
    """The exchange of leading-dim chunks: chunk j goes to rank j, and
    row i of the result is rank i's chunk for this rank. The exchange
    is its own transpose, so the backward runs it on the cotangent."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _swap(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, ctx.group, ctx.axis), None, None


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The all-to-all of `x` (world, ...) over a live mesh axis
    (`lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`):
    differentiable; at an axis of one rank nothing moves. The MoE FFN's
    dispatch and its return (`parallel/moe.py`)."""
    world = mesh_module.axis_size(axis_name)
    if x.shape[0] != world:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not "
                         f"the {world} ranks of axis {axis_name!r}")
    if world == 1:
        _trace.record("all_to_all", x, axis=axis_name,
                      group=mesh_module.axis_group(axis_name), ran=False)
        return x
    return _AllToAll.apply(x, mesh_module.axis_group(axis_name), axis_name)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, causal: bool = False,
                      scale: Optional[float] = None,
                      use_flash: bool = False, remat: bool = False
                      ) -> torch.Tensor:
    """Exact attention over sequence shards on the live mesh axis
    `axis_name` by head re-sharding (the DeepSpeed-Ulysses
    formulation). q/k/v: (B, H, T_local, D), this rank's shard with all
    H heads; H must divide by the axis size. Returns the (B, H, T_local,
    D) output of the local queries over the GLOBAL sequence.
    `use_flash=True` attends through the head-split flash kernels,
    otherwise `full_attention`; `remat=True` checkpoints the attention,
    so the backward recomputes it."""
    world = mesh_module.axis_size(axis_name)
    h = q.shape[1]
    if h % world != 0:
        raise ValueError(
            f"ulysses_attention: {h} heads do not divide over "
            f"{world}-way axis {axis_name!r}")
    group = mesh_module.axis_group(axis_name)

    def seq_to_heads(x):
        return _one_rank(x) if world == 1 else _SeqHeads.apply(
            x, group, world, True, axis_name)

    def heads_to_seq(x):
        return _one_rank(x) if world == 1 else _SeqHeads.apply(
            x, group, world, False, axis_name)

    def _one_rank(x):  # nothing moves; the reference's exchange is there
        _trace.record("all_to_all", x, axis=axis_name, group=group,
                      ran=False)
        return x

    if use_flash:
        from singa_tpu_torch.ops import flash_attention as fa

        def attend(qa, ka, va):
            return fa.flash_attention(fa._aligned(qa), fa._aligned(ka),
                                      fa._aligned(va), causal=causal,
                                      scale=scale)
    else:
        from singa_tpu_torch.parallel.ring import full_attention

        def attend(qa, ka, va):
            return full_attention(qa, ka, va, causal=causal, scale=scale)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        o = checkpoint(attend, qh, kh, vh, use_reentrant=False)
    else:
        o = attend(qh, kh, vh)
    return heads_to_seq(o)
