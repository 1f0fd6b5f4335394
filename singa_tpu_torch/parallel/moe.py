"""Switch Mixture-of-Experts with expert parallelism over a mesh axis
(counterpart of singa_tpu/parallel/moe.py).

Top-1 (Switch) routing with a static per-expert capacity
`capacity = ceil(tokens / experts * capacity_factor)`: each token goes
to the expert of its largest gate probability, takes the next place in
that expert's queue (by token order), and is dropped past the capacity
(a dropped token's FFN output is zero; it rides the residual around the
layer). The auxiliary loss is Switch's load-balance term, `E * sum(mean
one-hot * mean probability)` over the experts.

Dispatch and combine by index. The reference packs the expert queues and
unpacks their outputs with one-hot einsums, (N, E, C) against (N, d);
each sum has one nonzero term, so gathering and scattering by index
gives the same values, and at gpt_medium's shape (N 4096, E 8, C 640,
d 1024) each einsum would cost about 43 GFLOP a layer a direction, as
much as half the expert FFN. Here `route_top1` gives each token its
queue slot `e * C + place` (dropped tokens the spare slot `E * C`), the
queues are an `index_add` of the tokens into (E * C + 1, d) zeros (the
kept slots are distinct, so each row gets one token or none, exactly;
the spare row is cut off) and the combine is the gate weight times a
row gather of the expert outputs. No shape depends on the data, so a
step with a MoE FFN is capturable as one CUDA Graph. `gate_top1` builds
the reference's (combine, dispatch, aux) one-hot form from the same
routing, for callers of the reference's API and for tests.

`moe_ffn` runs inside a live mesh axis: each rank gates its own tokens,
packs its (E, C, d) queues, exchanges them with one all-to-all over the
axis (`parallel.ulysses.all_to_all`; global expert e lives on rank
e // E_local), runs its E_local experts as batched products, sends the
outputs back with the inverse all-to-all, and combines. The capacity is
per sender shard. `moe_ffn_dense` is the single-device formulation, its
capacity from the global token count (so under overflow it drops other
tokens than the sharded path). The gate and the expert products are
PyTorch products in the promoted dtype of their operands, as the
reference's `jnp.matmul`s are.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from singa_tpu_torch import autograd
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["route_top1", "gate_top1", "moe_ffn", "moe_ffn_dense"]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def route_top1(x: torch.Tensor, w_gate: torch.Tensor, n_experts: int,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Switch routing of x (N, d): (slot (N,) int64, the queue slot
    `expert * capacity + place`, or `n_experts * capacity` for a dropped
    token; weight (N,), the gate probability of a kept token and 0 for a
    dropped one; aux, the load-balance loss)."""
    probs = torch.softmax(_mm(x, w_gate), dim=-1)  # (N, E)
    expert = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, n_experts)  # int64
    # the place of each token in its expert's queue, in token order
    place = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    keep = place < capacity
    slot = torch.where(keep, expert * capacity + place,
                       torch.full_like(place, n_experts * capacity))
    weight = gate * keep.to(gate.dtype)
    frac_tokens = onehot.to(probs.dtype).mean(dim=0)
    aux = n_experts * (frac_tokens * probs.mean(dim=0)).sum()
    return slot, weight, aux


def gate_top1(x: torch.Tensor, w_gate: torch.Tensor, n_experts: int,
              capacity: int):
    """The reference's Switch gating (reference :34-63): (combine (N, E,
    C), dispatch = combine != 0 as 0/1, aux), built from `route_top1`."""
    slot, weight, aux = route_top1(x, w_gate, n_experts, capacity)
    n = x.shape[0]
    flat = x.new_zeros((n, n_experts * capacity + 1), dtype=weight.dtype)
    flat = flat.scatter(1, slot[:, None], weight[:, None])
    combine = flat[:, :-1].reshape(n, n_experts, capacity)
    return combine, (combine > 0).to(combine.dtype), aux


def _dispatch(x: torch.Tensor, slot: torch.Tensor, n_slots: int
              ) -> torch.Tensor:
    """The (n_slots, d) queues: token n in row slot[n] (the spare row
    n_slots takes the dropped tokens and is cut off)."""
    q = x.new_zeros((n_slots + 1, x.shape[-1]))
    return q.index_add(0, slot, x)[:n_slots]


def _combine(out: torch.Tensor, slot: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """Each token's weighted expert output: out (n_slots, d) rows by
    slot (a dropped token reads row 0 at weight 0)."""
    n_slots = out.shape[0]
    rows = out.index_select(0, torch.where(slot < n_slots, slot,
                                           torch.zeros_like(slot)))
    return weight[:, None].to(rows.dtype) * rows


def _experts(q: torch.Tensor, w1, b1, w2, b2, act: Callable) -> torch.Tensor:
    """The stacked experts' FFNs: q (E, n, d) -> (E, n, d)."""
    h = act(_mm(q, w1) + b1[:, None, :])
    return _mm(h, w2) + b2[:, None, :]


def moe_ffn(x: torch.Tensor, w_gate, w1, b1, w2, b2, axis_name: str,
            capacity_factor: float = 1.25, act: Callable = autograd.gelu):
    """The expert-parallel MoE FFN on this rank's tokens x (N_local, d)
    over the live mesh axis `axis_name` (reference :69-115). w1, b1, w2,
    b2 are this rank's expert shard: one expert ((d, ff), ...) or a
    stack of E_local ((E_local, d, ff), ...); w_gate (d, E) is
    replicated, E = world * E_local. Returns (y (N_local, d), aux
    averaged over the axis)."""
    from singa_tpu_torch.communicator import pmean_over
    from singa_tpu_torch.parallel.ulysses import all_to_all

    world = mesh_module.axis_size(axis_name)
    n_local, d = x.shape
    if w1.dim() == 2:  # one expert a rank: a stack of one
        w1, b1, w2, b2 = w1[None], b1[None], w2[None], b2[None]
    e_local = w1.shape[0]
    n_experts = world * e_local
    cap = int(math.ceil(n_local / n_experts * capacity_factor))
    slot, weight, aux = route_top1(x, w_gate, n_experts, cap)
    queues = _dispatch(x, slot, n_experts * cap)
    # recv[peer, e]: the queue `peer` routed to my local expert e
    recv = all_to_all(queues.reshape(world, e_local, cap, d), axis_name)
    out = _experts(recv.transpose(0, 1).reshape(e_local, world * cap, d),
                   w1, b1, w2, b2, act)
    back = all_to_all(out.reshape(e_local, world, cap, -1).transpose(0, 1),
                      axis_name)
    y = _combine(back.reshape(n_experts * cap, -1), slot, weight)
    return y, pmean_over(aux, axis_name)


def moe_ffn_dense(x: torch.Tensor, w_gate, w1_all, b1_all, w2_all, b2_all,
                  n_experts: int, capacity_factor: float = 1.25,
                  act: Callable = autograd.gelu):
    """The single-device MoE FFN (reference :118-135): every expert here,
    the capacity from the global token count. Returns (y, aux)."""
    n, d = x.shape
    cap = int(math.ceil(n / n_experts * capacity_factor))
    slot, weight, aux = route_top1(x, w_gate, n_experts, cap)
    queues = _dispatch(x, slot, n_experts * cap).reshape(n_experts, cap, d)
    out = _experts(queues, w1_all, b1_all, w2_all, b2_all, act)
    return _combine(out.reshape(n_experts * cap, -1), slot, weight), aux
