"""The hand-written strategy steps (counterpart of
singa_tpu/parallel/raw_steps.py).

Five training steps with no Model / GraphStep surface: ring sequence
parallelism, Ulysses, Megatron tensor parallelism, MoE expert
parallelism and GPipe. A rank calls `build_*_step(n_devices, devs)`
inside its process group (`devs` the mesh's ranks, None for all of
them); it returns `(step, operands, mesh)`, where `operands` are this
rank's shards (cut as the reference's `in_specs` cut them) and
`step(*operands)` runs one SGD step at lr 0.1, returning (the new
operands, in the reference's `out_specs` structure, and the loss). The
operands come from the reference's numpy seeds, so both packages start
from the same values; the two BERT steps make their parameters with the
port's own draws, and a caller that wants the reference's loads them
into `operands[0]` by name (`model.load_singa_tpu_params` maps the
names one to one).

Each step reproduces the reference's gradient, adjoints included:

- `raw_sp` and `raw_ulysses` run under `shard_map`'s checked typing
  there, where the replicated parameters' gradient is the gradient of
  the mean loss; here each rank backpropagates its own mean, the ring's
  (Ulysses') exchanges send the cotangents back, and the gradients are
  averaged over the axis (`pmean_over`), which is that gradient;
- `raw_tp`, `raw_ep` and `raw_pipe` run unchecked there, where a bare
  collective transposes to its linear adjoint (psum to psum, pmean to
  pmean), so every rank's copy of the loss adds into the objective.
  Here they use `psum_over` and `pmean_over`, whose backwards are the
  same adjoints, in the same places: `raw_tp` closes its row-parallel
  product with a bare psum (not the port's "g", whose backward is the
  identity), so its sharded weights' gradients come out model-world
  times the single-device ones, as the reference's do, then takes the
  pmean over data of the loss and the gradients; `raw_ep` averages the
  gate's gradient over the expert axis and keeps each expert's;
  `raw_pipe` closes with a bare psum, so its update is pipe-world times
  the sequential gradient, as the reference's is (the Model-level
  stacks close with "g" instead and equal the single device).
"""

from __future__ import annotations

import numpy as np
import torch

from singa_tpu_torch.communicator import pmean_over, psum_over
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = [
    "build_seq_parallel_step", "build_ulysses_step",
    "build_tensor_parallel_step", "build_expert_parallel_step",
    "build_pipeline_step", "RAW_STEP_BUILDERS",
]

LR = 0.1


def _device():
    from singa_tpu_torch import device as device_module
    from singa_tpu_torch import distributed

    return distributed.device() or device_module.resolve(None)


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _bert_step(n_devices, devs, seed, **bert_kw):
    """The shared body of the two sequence-parallel BERT steps: one BERT
    block over T = 4 * n tokens cut over an n-rank "sp" axis; the loss is
    the mean of the squared sequence output, averaged over the axis."""
    from singa_tpu_torch.models.transformer import bert_small

    dev = _device()
    t_global = 4 * n_devices
    bert = bert_small(seq_axis="sp", max_len=t_global, num_layers=1,
                      dropout=0.0, device=dev, **bert_kw)
    ids = np.random.default_rng(seed).integers(
        0, 999, size=(2, t_global)).astype(np.int32)
    mesh = mesh_module.get_mesh((n_devices,), ("sp",), devices=devs)
    me = mesh.axis_index("sp")
    ids_local = _t(ids[:, me * 4:(me + 1) * 4], dev).long()
    params = bert.get_params()
    names = list(params)

    def step(pv, ids_shard):
        with torch.no_grad():
            for n in names:
                params[n].copy_(pv[n])
        with mesh_module.axes_context("sp", mesh=mesh):
            x, _ = bert.forward(ids_shard)
            local = (x.float() ** 2).mean()
            grads = torch.autograd.grad(local, [params[n] for n in names],
                                        allow_unused=True)
            # the pooler and the segment table get zeros, as in JAX
            grads = [pmean_over(torch.zeros_like(params[n]) if g is None
                                else g, "sp") for n, g in zip(names, grads)]
            loss = pmean_over(local.detach(), "sp")
        new = {n: (pv[n] - LR * g).detach() for n, g in zip(names, grads)}
        return new, loss

    pvals = {n: p.detach().clone() for n, p in params.items()}
    return step, (pvals, ids_local), mesh


def build_seq_parallel_step(n_devices: int, devs=None):
    """One step of a ring-attention BERT (d 32, 4 heads) with the
    sequence cut over an n-rank "sp" axis."""
    return _bert_step(n_devices, devs, 0, d_model=32, num_heads=4)


def build_ulysses_step(n_devices: int, devs=None):
    """One step of an Ulysses (all-to-all head re-sharding) BERT with the
    sequence cut over "sp"; the heads must divide over the axis, so
    heads = max(2, n) and d = 8 * heads."""
    heads = max(2, n_devices)
    return _bert_step(n_devices, devs, 5, seq_impl="ulysses",
                      d_model=8 * heads, num_heads=heads)


def build_tensor_parallel_step(n_devices: int, devs=None):
    """One dp x tp step on a (data, model) mesh: the Megatron MLP with w1
    and b1 cut by columns, w2 by rows over "model", the batch over
    "data", closed by a bare psum (see the module docstring)."""
    from singa_tpu_torch.parallel.tp import _gelu

    dev = _device()
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mp = n_devices // dp
    mesh = mesh_module.get_mesh((dp, mp), ("data", "model"), devices=devs)
    di, mi = mesh.axis_index("data"), mesh.axis_index("model")
    d = 4 * mp
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2 * dp, 3, d)).astype(np.float32)
    w1 = rng.standard_normal((d, 4 * d)).astype(np.float32)
    w2 = rng.standard_normal((4 * d, d)).astype(np.float32)
    cols = slice(mi * 4 * d // mp, (mi + 1) * 4 * d // mp)
    operands = (_t(x[2 * di:2 * di + 2], dev), _t(w1[:, cols], dev),
                torch.zeros(4 * d // mp, device=dev), _t(w2[cols], dev),
                torch.zeros(d, device=dev))

    def step(x, w1, b1, w2, b2):
        ws = [w.detach().requires_grad_(True) for w in (w1, b1, w2, b2)]
        with mesh_module.axes_context("data", "model", mesh=mesh):
            h = _gelu(torch.matmul(x, ws[0]) + ws[1])
            y = psum_over(torch.matmul(h, ws[2]), "model") + ws[3]
            loss = pmean_over((y ** 2).mean(), "data")
            grads = torch.autograd.grad(loss, ws)
            grads = [pmean_over(g, "data") for g in grads]
        return (tuple((w - LR * g).detach() for w, g in zip(ws, grads)),
                loss.detach())

    return step, operands, mesh


def build_expert_parallel_step(n_devices: int, devs=None):
    """One MoE step: an expert a rank over an "expert" axis, the tokens
    exchanged by all-to-all (`parallel.moe.moe_ffn`); the gate's
    gradient is averaged over the axis, each expert's stays its own."""
    from singa_tpu_torch.parallel.moe import moe_ffn

    dev = _device()
    mesh = mesh_module.get_mesh((n_devices,), ("expert",), devices=devs)
    me = mesh.axis_index("expert")
    d, ff, n = 8, 16, 4 * n_devices
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_gate = rng.standard_normal((d, n_devices)).astype(np.float32)
    w1 = rng.standard_normal((n_devices, d, ff)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((n_devices, ff, d)).astype(np.float32) * 0.1
    operands = (_t(x[4 * me:4 * me + 4], dev), _t(w_gate, dev),
                _t(w1[me:me + 1], dev), torch.zeros(1, ff, device=dev),
                _t(w2[me:me + 1], dev), torch.zeros(1, d, device=dev))

    def step(x, w_gate, w1, b1, w2, b2):
        ws = [w.detach().requires_grad_(True)
              for w in (w_gate, w1, b1, w2, b2)]
        with mesh_module.axes_context("expert", mesh=mesh):
            y, aux = moe_ffn(x, ws[0], ws[1][0], ws[2][0], ws[3][0],
                             ws[4][0], "expert")
            loss = pmean_over((y ** 2).mean(), "expert") + 0.01 * aux
            grads = list(torch.autograd.grad(loss, ws))
            grads[0] = pmean_over(grads[0], "expert")
        return (tuple((w - LR * g).detach() for w, g in zip(ws, grads)),
                loss.detach())

    return step, operands, mesh


def build_pipeline_step(n_devices: int, devs=None):
    """One GPipe step: a tanh stage a rank over a "pipe" axis, 2
    microbatches streamed between the ranks
    (`parallel.pipeline.pipeline_apply`); the loss closes with a bare
    psum (see the module docstring)."""
    from singa_tpu_torch.parallel.pipeline import pipeline_apply

    dev = _device()
    mesh = mesh_module.get_mesh((n_devices,), ("pipe",), devices=devs)
    me = mesh.axis_index("pipe")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    w = rng.standard_normal((n_devices, 8, 8)).astype(np.float32) * 0.3
    operands = (_t(x, dev), _t(w[me:me + 1], dev))

    def step(x, w_local):
        wl = w_local.detach().requires_grad_(True)
        with mesh_module.axes_context("pipe", mesh=mesh):
            y, valid = pipeline_apply(lambda p, h: torch.tanh(h @ p[0]), wl,
                                      x, "pipe", 2)
            loss = (psum_over(y * valid, "pipe") ** 2).sum()
            (g,) = torch.autograd.grad(loss, [wl])
        return (wl - LR * g).detach(), loss.detach()

    return step, operands, mesh


#: the reference's registry order: name -> build function
RAW_STEP_BUILDERS = {
    "raw_sp": build_seq_parallel_step,
    "raw_ulysses": build_ulysses_step,
    "raw_tp": build_tensor_parallel_step,
    "raw_ep": build_expert_parallel_step,
    "raw_pipe": build_pipeline_step,
}
