"""Ring attention: exact sequence-parallel attention over a mesh axis
(counterpart of singa_tpu/parallel/ring.py).

Each rank of the sequence axis holds a shard of Q/K/V, (B, H, T_local,
D). K/V blocks travel round the ring while a running online softmax
folds in one block a step, so each rank's queries attend over the
GLOBAL sequence with O(T_local) keys resident. The reference rotates
with `lax.ppermute` inside a `lax.scan`; here a rotation is one
`torch.autograd.Function` (`_Rotate`) whose forward sends the (K, V)
block to rank s+1 of the axis's process group and receives from s-1 in
one `dist.batch_isend_irecv`, and whose backward sends the cotangents
the other way (ppermute's adjoint). The loop is a Python loop over the
axis's ranks; the block index of a step is a Python int, so the causal
cases need no `switch`.

- The ring makes `rotation_steps(world)` block steps and moves the
  blocks `world - 1` times: the reference's last ppermute brings the
  blocks home and its result is never read, so it is not sent. At world
  1 nothing moves.
- `pipelined=True` posts hop s+1 before computing block s (the
  reference's double buffer): `_HopStart` posts the exchange, the
  block's matmuls run, `_HopWait` waits for it. Both orders give the
  same values.
- `remat=True` checkpoints the block update (`torch.utils.checkpoint`),
  so the backward recomputes the block scores instead of keeping W
  blocks of them.
- `use_flash=True` (`_ring_flash`) runs each block through the flash
  kernels: `flash_attention(..., return_lse=True)`, whose backward takes
  the merge's lse cotangent as `delta - g_lse`. Blocks merge in fp32 by
  lse weight. Causal blocks follow GLOBAL shard order: an earlier
  shard's block is bidirectional, the own shard's the kernel's causal
  diagonal, a later shard's is skipped with lse -1e30 (zero weight).

The running maximum of each merge is a stabiliser: the result does not
depend on it, so it is taken out of the tape (`detach`), which leaves
the gradient unchanged and saves its terms.

A skipped block still records a node (`_Skipped`) whose backward gives
its K/V zero gradients: every rank then runs every hop's backward, in
the same order, whatever blocks its queries skip (a rank whose last
block was skipped would otherwise never reach the last hop's backward
while its neighbour waits on it).

`full_attention` is the plain single-device attention the flash kernel
and the ring are held against, and the attention of `GPT.generate`'s
prefill and window steps. Its semantics are the reference's:

- masked scores are `_NEG = -1e30` (not -inf, so `exp` stays NaN-free);
- the causal mask is aligned bottom-right: query i sees keys
  `k <= i + (Tk - Tq)`;
- rows with an empty attention set output an exact 0.

Layout: (B, H, T, D).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from singa_tpu_torch import autograd
from singa_tpu_torch.analysis import trace as _trace
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["ring_attention", "full_attention", "ring_permutation",
           "rotation_steps", "KV_TENSORS_PER_HOP"]

_NEG = -1e30

#: the declared schedule's count (layer.ScanTransformerStack
#: .declared_schedule): each rotation moves TWO tensors, K and V
KV_TENSORS_PER_HOP = 2


def rotation_steps(world: int) -> int:
    """Block steps per ring attention call: one fold per shard of the
    axis (the reference's ring body count)."""
    return int(world)


def ring_permutation(world: int) -> List[Tuple[int, int]]:
    """The rotation schedule: shard i hands its K/V block to shard i+1
    (mod world), one cycle over the whole axis."""
    return [(i, (i + 1) % world) for i in range(world)]


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


# -- the rotation ------------------------------------------------------------------


class _Ring:
    """The sequence axis's process group and this rank's neighbours (as
    global ranks, which `dist.P2POp` takes)."""

    def __init__(self, axis_name: str):
        self.axis = axis_name
        self.world = mesh_module.axis_size(axis_name)
        self.index = mesh_module.axis_index(axis_name)
        self.group = mesh_module.axis_group(axis_name)
        self.ranks = dist.get_process_group_ranks(self.group) if (
            self.world > 1) else [0]
        self.next = self.ranks[(self.index + 1) % self.world]
        self.prev = self.ranks[(self.index - 1) % self.world]

    def record(self, tensors, dst: int, ran: bool = True) -> None:
        """One shardlint ppermute record a tensor sent to global rank
        `dst` (`ran=False`: a rotation the reference makes and the ring
        elides)."""
        if _trace.recording():
            peer = (self.index, self.ranks.index(dst))
            for t in tensors:
                _trace.record("ppermute", t, axis=self.axis,
                              group=self.group, peer=peer, ran=ran)

    def post(self, tensors, forward: bool):
        """Send `tensors` one step round the ring (to the next rank when
        `forward`, else to the previous one) and receive as many from the
        other side; returns (received buffers, pending works)."""
        dst, src = (self.next, self.prev) if forward else (self.prev,
                                                           self.next)
        self.record(tensors, dst)
        sent = [t.contiguous() for t in tensors]
        got = [torch.empty_like(t) for t in sent]
        ops = [dist.P2POp(dist.isend, t, dst, group=self.group)
               for t in sent]
        ops += [dist.P2POp(dist.irecv, t, src, group=self.group)
                for t in got]
        return got, (dist.batch_isend_irecv(ops), sent)


def _wait(pending) -> None:
    works, _sent = pending  # the sent tensors live until the wait
    for w in works:
        w.wait()


class _Rotate(torch.autograd.Function):
    """The tensors of rank s-1 on rank s ((K, V) here, an activation in
    `pipeline.py`); the backward sends the cotangents back (ppermute's
    adjoint)."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        got, pending = ring.post(tensors, forward=True)
        _wait(pending)
        return tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        got, pending = ctx.ring.post(grads, forward=False)
        _wait(pending)
        return (None, *got)


class _Hop:
    """The exchange in flight between `_HopStart` and `_HopWait`."""

    pending = None


class _HopStart(torch.autograd.Function):
    """Post the rotation of (K, V) and return the receive buffers, not
    yet filled: `_HopWait` makes them readable. The backward waits for
    the reverse exchange `_HopWait`'s backward posted."""

    @staticmethod
    def forward(ctx, ring, hop, k, v):
        ctx.hop = hop
        got, hop.pending = ring.post((k, v), forward=True)
        return tuple(got)

    @staticmethod
    def backward(ctx, gk, gv):
        _wait(ctx.hop.pending)
        return None, None, gk, gv


class _HopWait(torch.autograd.Function):
    """Wait for the posted rotation; the backward posts the cotangents'
    exchange and hands the receive buffers on to `_HopStart`'s backward,
    so the block's backward runs while they travel."""

    @staticmethod
    def forward(ctx, ring, hop, kn, vn):
        ctx.ring, ctx.hop = ring, hop
        _wait(hop.pending)
        return kn.view_as(kn), vn.view_as(vn)

    @staticmethod
    def backward(ctx, gk, gv):
        got, ctx.hop.pending = ctx.ring.post((gk, gv), forward=False)
        return (None, None, *got)


class _Skipped(torch.autograd.Function):
    """A fully masked block: zero output and lse -1e30 (zero merge
    weight); K and V get zero gradients, so the hop that brought them
    runs its backward on every rank."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = [(x.shape, x.dtype, x.device) for x in (q, k, v)]
        ctx.set_materialize_grads(False)
        lse = torch.full(q.shape[:-1], _NEG, dtype=torch.float32,
                         device=q.device)
        ctx.mark_non_differentiable(lse)
        return torch.zeros_like(q), lse

    @staticmethod
    def backward(ctx, go, glse):
        return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                     for shape, dtype, dev in ctx.like)


def _hops(ring: _Ring, pipelined: bool):
    """The rotation of one ring call: `start(s, kc, vc)` before block s,
    `finish()` after it, which gives the next (K, V), or None after the
    last block (nothing is sent then)."""
    state = {}

    def start(s, kc, vc):
        state["kv"] = None
        if s == ring.world - 1:
            # the reference's last ppermute brings the blocks home
            ring.record((kc, vc), ring.next, ran=False)
            return
        if pipelined:
            hop = _Hop()
            state["kv"] = (hop, *_HopStart.apply(ring, hop, kc, vc))
        else:
            state["kv"] = (None, kc, vc)

    def finish():
        if state["kv"] is None:
            return None
        hop, kc, vc = state["kv"]
        if hop is None:
            return _Rotate.apply(ring, kc, vc)
        return _HopWait.apply(ring, hop, kc, vc)

    return start, finish


# -- ring attention ------------------------------------------------------------------


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, causal: bool = False,
                   scale: Optional[float] = None, remat: bool = True,
                   use_flash: bool = False, pipelined: bool = False
                   ) -> torch.Tensor:
    """Exact attention over sequence shards on the live mesh axis
    `axis_name`: q/k/v (B, H, T_local, D), this rank's shard; returns
    the (B, H, T_local, D) output of the local queries over the GLOBAL
    sequence. See the module docstring for `remat`, `use_flash` and
    `pipelined`."""
    ring = _Ring(axis_name)
    if use_flash:
        return _ring_flash(q, k, v, ring, scale, causal, pipelined)
    world, my = ring.world, ring.index
    t_local = q.shape[-2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q_pos = my * t_local + torch.arange(t_local, device=q.device)

    def block_update(o, m, l, kc, vc, src: int):
        scores = _dot("bhqd,bhkd->bhqk", q, kc) * scale
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            allowed = k_pos[None, :] <= q_pos[:, None]  # (Tq, Tk)
            scores = scores.masked_fill(~allowed, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1)).detach()
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + _dot("bhqk,bhkd->bhqd", p, vc)
        return o, m_new, l

    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        inner = block_update

        def block_update(o, m, l, kc, vc, src: int):
            return checkpoint(inner, o, m, l, kc, vc, src,
                              use_reentrant=False)

    o = torch.zeros_like(q)
    m = torch.full(q.shape[:-1], _NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    start, finish = _hops(ring, pipelined)
    kc, vc = k, v
    for s in range(rotation_steps(world)):
        start(s, kc, vc)
        o, m, l = block_update(o, m, l, kc, vc, (my - s) % world)
        nxt = finish()
        if nxt is not None:
            kc, vc = nxt
    return o / torch.clamp(l, min=1e-30)[..., None]


def _ring_flash(q, k, v, ring: _Ring, scale: Optional[float],
                causal: bool, pipelined: bool) -> torch.Tensor:
    """Ring attention with flash-kernel blocks, merged by lse weight
    (the blockwise identity: softmax over the union is the lse-weighted
    mean of the blocks' softmaxes)."""
    from singa_tpu_torch.ops import flash_attention as fa

    hd = q.shape[-1]
    if not fa._kernel_takes(hd, q.dtype):
        raise ValueError(
            f"ring_attention(use_flash=True): the flash kernels take head "
            f"dims {fa._HEAD_DIMS} in float32 or bfloat16, got {hd} in "
            f"{q.dtype}")
    world, my = ring.world, ring.index
    q = fa._aligned(q)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    wsum = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32,
                   device=q.device)
    start, finish = _hops(ring, pipelined)
    kc, vc = k, v
    for s in range(rotation_steps(world)):
        start(s, kc, vc)
        src = (my - s) % world  # whose block this rank holds now
        if causal and src > my:
            o_b, lse_b = _Skipped.apply(q, kc, vc)
        else:
            o_b, lse_b = fa.flash_attention(
                q, fa._aligned(kc), fa._aligned(vc),
                causal=causal and src == my, scale=scale, return_lse=True)
        o_b = o_b.float()
        m_new = torch.maximum(m, lse_b).detach()
        c_prev = torch.exp(m - m_new)
        w_b = torch.exp(lse_b - m_new)
        acc = acc * c_prev[..., None] + o_b * w_b[..., None]
        wsum = wsum * c_prev + w_b
        m = m_new
        nxt = finish()
        if nxt is not None:
            kc, vc = nxt
    out = acc / torch.clamp(wsum, min=1e-30)[..., None]
    return out.to(q.dtype)
