"""Tensor (model) parallelism: Megatron's sharded matmul pairs
(counterpart of singa_tpu/parallel/tp.py).

A column-parallel matmul splits W on its output dim: each rank computes
its slice of the output, with no collective. A row-parallel matmul
splits W on its input dim: each rank contracts its slice of the input,
and one all-reduce over the axis restores the full output. A column ->
row pair (the transformer's MLP and attention) costs one all-reduce.

The reference runs these inside `shard_map`, where a chip's block of a
replicated weight arrives by `dynamic_slice` and shard_map's transpose
rules fix the adjoints of replicated inputs and outputs. Here each rank
is one process over the mesh's process groups (`mesh.axis_group`), and
the adjoints are explicit: with the loss replicated over the axis and
counted once, every rank gets the gradient of its own block.

- "g" (`psum_identity_bwd`): all-reduce forward, identity backward, after
  a row-parallel product;
- "f" (`identity_psum_bwd`): identity forward, all-reduce backward,
  before a column-parallel product, so layers upstream see the full
  gradient of a replicated input (the reference's comment at
  singa_tpu/layer.py:1304-1310: a bare all-reduce would scale
  cotangents by the world).

`row_linear` closes with "g", and the composites (`tp_mlp`,
`tp_attention_qkv`) open with "f"; `col_linear` alone has no collective,
so its input gradient is this rank's part. `gather_cols` all-gathers a
column-parallel output; its backward slices this rank's columns.
Outside the axis (`not mesh.in_axis(axis)`) every function is its dense
form: the shard of a full weight is the weight, and no collective runs.
Inside it, the collectives run over the axis's group at any size, one
rank included (on the card the captured steps record them, so a group's
NCCL communicator must exist before a capture begins).

`COUNTS` counts the forward all-reduces of "g" and the backward ones of
"f" by (kind, axis): the tests hold a block's "g" count to
`PSUMS_PER_BLOCK`. Every product is `torch.matmul`, as the reference's
are XLA's, outside any kernel.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

from singa_tpu_torch.analysis import trace as _trace
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = [
    "PSUMS_PER_BLOCK", "LOGITS_GATHERS_PER_STEP", "COUNTS",
    "psum_identity_bwd", "identity_psum_bwd", "shard_col", "shard_row",
    "col_linear", "row_linear", "tp_mlp", "tp_attention_qkv",
    "tp_attention_out", "interleave_qkv_shards", "deinterleave_qkv_shards",
    "split_interleaved_qkv", "gather_cols",
]

#: Megatron's identity: one column -> row pair per attention sub-block
#: and one per FFN sub-block, so two forward "g" all-reduces per
#: transformer block (and two backward "f" ones)
PSUMS_PER_BLOCK = 2

#: the sharded serving step's LM head: column-parallel over the vocab,
#: then one all-gather of the logits row per step
LOGITS_GATHERS_PER_STEP = 1

#: collectives run, by (kind, axis): "g" forward all-reduces, "f"
#: backward all-reduces, "gather" all-gathers
COUNTS: collections.Counter = collections.Counter()


def _group(axis: str):
    """The axis's process group when the axis is live and a group is
    initialised, else None (the dense form)."""
    if not mesh_module.in_axis(axis):
        return None
    g = mesh_module.axis_group(axis)
    if g is None or not (dist.is_available() and dist.is_initialized()):
        return None
    return g


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy, which an in-place collective may overwrite
    (autograd's inputs and incoming gradients may not be)."""
    return x.clone(memory_format=torch.contiguous_format)


class _PsumIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        return psum_in_group(_fresh(x), group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _IdentityPsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_in_group(_fresh(g), ctx.group, ctx.axis, "f"), None, None


def psum_identity_bwd(axis_name: str):
    """Megatron's "g": all-reduce over the axis forward, identity
    backward (after a row-parallel product). Outside the axis, the
    identity."""
    def g(a: torch.Tensor) -> torch.Tensor:
        group = _group(axis_name)
        if group is None:
            if mesh_module.in_axis(axis_name):  # a live axis, no group
                _trace.record("psum", a, axis=axis_name, ran=False)
            return a
        return _PsumIdentityBwd.apply(a, axis_name, group)

    return g


def identity_psum_bwd(axis_name: str):
    """Megatron's "f": identity forward, all-reduce over the axis backward
    (before a column-parallel product: each rank's input cotangent covers
    only its output columns). Outside the axis, the identity."""
    def f(a: torch.Tensor) -> torch.Tensor:
        group = _group(axis_name)
        if group is None:
            return a
        return _IdentityPsumBwd.apply(a, axis_name, group)

    return f


def _check_divisible(dim: int, world: int, what: str) -> None:
    """A shard dim must split evenly (the reference's guard: its
    dynamic_slice would clamp and drop rows silently)."""
    if dim % world:
        raise ValueError(
            f"{what} dim {dim} not divisible by axis size {world}")


def _world_and_index(axis_name: str):
    if not mesh_module.in_axis(axis_name):
        return 1, 0
    return mesh_module.axis_size(axis_name), mesh_module.axis_index(
        axis_name)


def shard_col(w: torch.Tensor, axis_name: str) -> torch.Tensor:
    """This rank's column block of a full (..., out) weight or (out,)
    bias: the output dim split over the axis."""
    world, me = _world_and_index(axis_name)
    out = w.shape[-1]
    _check_divisible(out, world, "shard_col: output")
    local = out // world
    return w.narrow(-1, me * local, local)


def shard_row(w: torch.Tensor, axis_name: str) -> torch.Tensor:
    """This rank's row block of a full (..., in, out) weight: the input
    (contraction) dim split over the axis."""
    world, me = _world_and_index(axis_name)
    inp = w.shape[-2]
    _check_divisible(inp, world, "shard_row: input")
    local = inp // world
    return w.narrow(-2, me * local, local)


def col_linear(x: torch.Tensor, w_shard: torch.Tensor,
               b_shard: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column-parallel product: x (..., in) replicated, w_shard
    (in, out/world); this rank's output slice (..., out/world), no
    collective."""
    y = torch.matmul(x, w_shard)
    return y if b_shard is None else y + b_shard


def row_linear(x_shard: torch.Tensor, w_shard: torch.Tensor,
               axis_name: str, b: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Row-parallel product: x_shard (..., in/world), w_shard
    (in/world, out); "g" over the axis gives the full (..., out) on every
    rank, and the bias is added once, after it."""
    y = psum_identity_bwd(axis_name)(torch.matmul(x_shard, w_shard))
    return y if b is None else y + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default, the tanh form
    return torch.nn.functional.gelu(x, approximate="tanh")


def tp_mlp(x, w1, b1, w2, b2, axis_name: str, act=_gelu,
           pre_sharded: bool = False) -> torch.Tensor:
    """The Megatron MLP: "f", column-parallel up-projection, activation,
    row-parallel down-projection, one all-reduce. `pre_sharded=False`
    takes full w1 (d, 4d), b1, w2 (4d, d) and slices this rank's blocks;
    `pre_sharded=True` takes the blocks."""
    if not pre_sharded:
        w1 = shard_col(w1, axis_name)
        b1 = None if b1 is None else shard_col(b1, axis_name)
        w2 = shard_row(w2, axis_name)
    x = identity_psum_bwd(axis_name)(x)
    return row_linear(act(col_linear(x, w1, b1)), w2, axis_name, b2)


def interleave_qkv_shards(w_qkv: torch.Tensor, world: int) -> torch.Tensor:
    """Reorder a fused [q | k | v] (..., 3d) weight or bias into
    [q_0|k_0|v_0 | q_1|k_1|v_1 | ...], so that a contiguous column block
    of `world` parts is part c's [q_c|k_c|v_c]. Leading (block) dims
    pass through; `world=num_heads` interleaves per head, so every axis
    size dividing the heads gets its heads' triples by a contiguous
    block."""
    d = w_qkv.shape[-1] // 3
    _check_divisible(d, world, "interleave_qkv_shards: d_model")
    local = d // world
    parts = w_qkv.split(d, dim=-1)
    return torch.cat([p.narrow(-1, c * local, local)
                      for c in range(world) for p in parts], dim=-1)


def deinterleave_qkv_shards(w_qkv: torch.Tensor, world: int
                            ) -> torch.Tensor:
    """The inverse of `interleave_qkv_shards`: the [q | k | v] layout
    back."""
    d = w_qkv.shape[-1] // 3
    _check_divisible(d, world, "deinterleave_qkv_shards: d_model")
    parts = w_qkv.split(d // world, dim=-1)  # q_0, k_0, v_0, q_1, ...
    return torch.cat([torch.cat(parts[i::3], dim=-1) for i in range(3)],
                     dim=-1)


def split_interleaved_qkv(qkv: torch.Tensor, head_dim: int):
    """Head-split (q, k, v), each (B, H, T, hd), of a head-interleaved
    projection (B, T, 3*H*hd): the full width (H = num_heads) or a
    rank's contiguous block of it (H = num_heads / world)."""
    b, t, width = qkv.shape
    if width % (3 * head_dim):
        raise ValueError(
            f"split_interleaved_qkv: width {width} is not a multiple of "
            f"3*head_dim ({3 * head_dim}) — num_heads must divide evenly "
            f"over the tp axis")
    g = qkv.view(b, t, width // (3 * head_dim), 3, head_dim)
    return tuple(g[..., i, :].transpose(1, 2) for i in range(3))


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis, group):
        ctx.index, ctx.width = dist.get_rank(group), y.shape[-1]
        return gather_cols_in_group(y, group, axis,
                                    dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.width, ctx.width), None, None


def gather_cols(y_local: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The full last dim of a column-parallel output: (..., out/world) ->
    (..., out), the blocks in axis order (undoing `shard_col`), by one
    all-gather over the axis. Its backward takes this rank's columns of
    the cotangent (the loss replicated over the axis)."""
    group = _group(axis_name)
    if group is None:
        return y_local
    return _GatherCols.apply(y_local, axis_name, group)


def tp_attention_qkv(x, w_qkv, b_qkv, num_heads: int, axis_name: str,
                     pre_sharded: bool = False):
    """Head-parallel QKV projection: "f", then this rank's heads of q, k
    and v, each (B, H/world, T, hd); attention then runs on the local
    heads with no collective. A full w_qkv (d, 3d) is [q | k | v] and
    each third is column-sliced; `pre_sharded=True` takes the local
    (d, 3d/world) [q_c | k_c | v_c] (a contiguous block of the
    `interleave_qkv_shards(w, world)` layout)."""
    d = x.shape[-1]
    hd = d // num_heads
    world = _world_and_index(axis_name)[0]
    _check_divisible(num_heads, world, "tp_attention_qkv: num_heads")
    if pre_sharded:
        ws = w_qkv.chunk(3, dim=-1)
        bs = (None,) * 3 if b_qkv is None else b_qkv.chunk(3, dim=-1)
    else:
        ws = [shard_col(w, axis_name) for w in w_qkv.chunk(3, dim=-1)]
        bs = (None,) * 3 if b_qkv is None else [
            shard_col(b, axis_name) for b in b_qkv.chunk(3, dim=-1)]
    x = identity_psum_bwd(axis_name)(x)
    b_, t = x.shape[0], x.shape[1]
    h_local = num_heads // world

    def heads(a):  # (B, T, h_local*hd) -> (B, h_local, T, hd)
        return a.reshape(b_, t, h_local, hd).transpose(1, 2)

    return tuple(heads(col_linear(x, w, b)) for w, b in zip(ws, bs))


def tp_attention_out(o_local, w_o, b_o, axis_name: str,
                     pre_sharded: bool = False) -> torch.Tensor:
    """The row-parallel output projection closing the head-parallel
    block: o_local (B, H/world, T, hd) -> (B, T, d), one all-reduce."""
    b_, h_local, t, hd = o_local.shape
    flat = o_local.transpose(1, 2).reshape(b_, t, h_local * hd)
    if not pre_sharded:
        w_o = shard_row(w_o, axis_name)
    return row_linear(flat, w_o, axis_name, b_o)


# -- the collectives without autograd ---------------------------------------------


def psum_in_group(x: torch.Tensor, group, axis_name: str,
                  kind: str = "g") -> torch.Tensor:
    """`x` summed over the axis's `group` in place (made contiguous
    first), counted in `COUNTS` under (kind, axis), without autograd: the
    serving step's "g" (on a product's fresh output, which a captured
    decode step records) and the core of the autograd "g" and "f"."""
    COUNTS[kind, axis_name] += 1
    _trace.record("psum", x, axis=axis_name, group=group)
    y = x.contiguous()
    dist.all_reduce(y, group=group)
    return y


def gather_in_group(x: torch.Tensor, group, world: int,
                    dim: int = -1, axis: Optional[str] = None
                    ) -> torch.Tensor:
    """The blocks of `x` on the `world` ranks of `group` joined along
    `dim` in rank order, by one all-gather into one tensor, without
    autograd or a count (`distributed.gather_full` and the counted
    gathers below); `axis` names the mesh axis for the shardlint
    record."""
    from singa_tpu_torch.communicator import _all_gather_into_tensor

    _trace.record("all_gather", x, axis=axis, group=group)
    y = x.contiguous()
    out = y.new_empty((world * y.shape[0],) + tuple(y.shape[1:]))
    _all_gather_into_tensor(out, y, group=group)
    return torch.cat(out.chunk(world), dim=dim)


def gather_cols_in_group(x: torch.Tensor, group, axis_name: str,
                         world: int) -> torch.Tensor:
    """The (..., n) column blocks of the `world` ranks of `group` joined
    into (..., world * n), counted under ("gather", axis), without
    autograd: the serving step's logits gather and `gather_cols`'
    forward."""
    COUNTS["gather", axis_name] += 1
    return gather_in_group(x, group, world, -1, axis=axis_name)
