"""Pipeline parallelism (GPipe) over a mesh axis (counterpart of
singa_tpu/parallel/pipeline.py).

Each rank of the "pipe" axis owns one stage (a same-shaped slice of
blocks); a batch is split into `n_micro` microbatches that stream
through the stages, each activation passed to the next rank. The
schedule has world + n_micro - 1 ticks: at tick t, rank s works on
microbatch t - s when 0 <= t - s < n_micro; rank 0 takes a fresh
microbatch and the others what arrived from the left; the last rank
collects the finished microbatches; each tick but the last ends with a
rotation to the right (`ring._Ring.post`, whose backward sends the
cotangent left: ppermute's adjoint). The bubble is the standard
(world - 1) / (n_micro + world - 1).

The reference runs the schedule as one `lax.scan`, computing the stage
on every tick and masking it (`jnp.where(active, ...)`). Here the
schedule is a Python loop and an inactive rank skips its stage,
passing its buffer through: the same values, without the wasted
products.

Every rank must post the same point-to-point exchanges in the backward,
in the same order, or the ring hangs. In JAX every received buffer and
the input stay in every chip's graph; here a rank that does not read a
buffer would drop it from the tape, and autograd would never reach that
rotation's backward while its neighbour waits in it. So:

- the first receive buffer is zeros joined (`_KeepOnly`, at a zero
  gradient) to x and to every stage weight that requires grad, so every
  tick's rotation is on the tape on every rank, and on the path to
  whatever gradient is asked for (`torch.autograd.grad(loss, [w])`
  prunes every node that does not lead to w);
- where rank 0 takes the fresh microbatch over the received buffer,
  `_KeepOnly` keeps the buffer in the graph with a zero gradient, as
  `ring._Skipped` does for K and V;
- the last tick's output joins the returned y on every rank, so the
  chain of rotations ends in the loss everywhere.

The chain makes each rotation's backward wait for the next one's, so
every rank runs them in reverse tick order. At world 1 the rotation is
the identity and issues no point-to-point exchange (the reference's
ppermute to self), so the step can be captured as a CUDA Graph.
"""

from __future__ import annotations

from typing import Callable

import torch

from singa_tpu_torch.analysis import trace as _trace
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["pipeline_apply"]


class _KeepOnly(torch.autograd.Function):
    """`value`, with each of `dropped` kept in the graph at a zero
    gradient: a rank that does not read a tensor still runs the backward
    of what made it (the rotation that brought it, the input's "f")."""

    @staticmethod
    def forward(ctx, value, *dropped):
        ctx.like = [(t.shape, t.dtype, t.device) for t in dropped]
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.like))


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


def pipeline_apply(stage_fn: Callable, params_local, x: torch.Tensor,
                   axis_name: str, n_micro: int):
    """Run the GPipe schedule over the mesh axis `axis_name` (live in the
    caller's axis context; outside it, the axis has one rank).

    stage_fn(params_local, h) -> h is this rank's stage (the same
    activation shape in and out); params_local its stage weights; x
    (B, ...) the full batch, the same on every rank, with B divisible by
    `n_micro`. Returns (y, valid): y (B, ...) the last stage's output on
    the last rank (zeros elsewhere), valid 1.0 on the last rank and 0.0
    elsewhere, so `psum(y * valid)` broadcasts the result."""
    from singa_tpu_torch.parallel.ring import _Ring, _Rotate

    live = mesh_module.in_axis(axis_name)
    world = mesh_module.axis_size(axis_name) if live else 1
    me = mesh_module.axis_index(axis_name) if live else 0
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    ring = _Ring(axis_name) if world > 1 else None
    last = world - 1
    inbuf = torch.zeros_like(micro[0])
    roots = [t for t in [x] + _tensors(params_local) if t.requires_grad]
    if ring is not None and torch.is_grad_enabled() and roots:
        inbuf = _KeepOnly.apply(inbuf, *roots)
    outs = []
    n_ticks = world + n_micro - 1
    for t in range(n_ticks):
        if 0 <= t - me < n_micro:
            h_in = micro[t] if me == 0 else inbuf
            if me == 0 and ring is not None and inbuf.requires_grad:
                h_in = _KeepOnly.apply(h_in, inbuf)
            h_out = stage_fn(params_local, h_in)
        else:
            h_out = inbuf
        if me == last and t >= last:
            outs.append(h_out)
        if t < n_ticks - 1:
            if ring is None and live:  # one rank: nothing moves
                _trace.record("ppermute", h_out, axis=axis_name,
                              group=mesh_module.axis_group(axis_name),
                              peer=(0, 0), ran=False)
            inbuf = h_out if ring is None else _Rotate.apply(ring,
                                                             h_out)[0]
    if me == last:
        y = torch.cat(outs).reshape(x.shape)
    else:
        y = torch.zeros_like(x)
        if h_out.requires_grad:
            y = _KeepOnly.apply(y, h_out)
    # a fill, not a host copy: a captured step may hold it
    return y, x.new_full((), 1.0 if me == last else 0.0)
