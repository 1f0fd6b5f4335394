"""Model API and the weight carry-over (counterpart of singa_tpu/model.py).

`Model` is an `nn.Module` with the reference's training surface
(`singa_tpu/model.py:49-261`):

    m.set_optimizer(opt.AdamW(lr=3e-4))
    m.compile([x], is_train=True, use_graph=True, precision="bf16")
    logits, loss = m(x, y)               # or m.train_one_batch(x, y)

After `compile(..., is_train=True)` a call in training mode runs the
subclass's `train_one_batch`; otherwise `m(ids)` runs `forward`, with
grad recording only while `autograd.training` is set (so scoring in eval
mode keeps no tape, as the reference records none).

`graph(True)` (the default of `compile(..., use_graph=True)`) routes the
training step through `graph.GraphStep`: on the card the whole step
(forward, backward, clipping, the optimizer update) is captured as one
CUDA Graph per input signature at its second call and replayed after
that; on the CPU the same function runs uncaptured. Calls outside
training mode take the eval step (`GraphStep(model, forward,
train_step=False)`, reference `model.py:227-250`): `forward` without a
tape, captured the same way on the card. `graph(False)` runs both
eagerly. `memory_estimate` is the native planner's verdict on the
training step, else on the eval step (`graph.py`'s memory plan).

`load_singa_tpu_params` carries a `singa_tpu` model's weights into the
port: it takes `{name: np.asarray(t.data) for name, t in
jax_model.get_params().items()}` and copies each array into the port's
parameter of the same name, in the same layout. `load_singa_tpu_states`
does the same for parameters and buffers (BatchNorm's running
statistics) together, from the reference's `get_states()`.

`set_image_layout("NHWC")` runs a CNN channels-last inside while its
inputs and outputs stay NCHW (`layout.py`). As in the reference,
`compile`'s forward runs with the layers in training mode (only the tape
is off), so a BatchNorm's running statistics take one update from it.
That forward also materialises the widths of layers built without their
input width (`layer.Layer`); `set_optimizer` names the slots once every
parameter exists, at once or after that forward.

`Model` is a `layer.Layer`, so it has the reference's state API
(`get_params`, `get_states`, `set_params`, `set_states`), and
`save_states(path, aux_states)` / `load_states(path)` write and read the
reference's single-file archive (a zip of `states/<name>.npy` and
`aux/<name>.npy`, `singa_tpu/model.py:284-337`). The reference's
`meta/pspec.json` entry is neither written nor read. A file written by
either package loads into the other.

Tensor parallelism: a model whose layers carry `pspec`s (`tp_axis=`)
holds full weights until a DistOpt over a live mesh meets it
(`set_optimizer`, or `compile` once lazy widths exist); then, before the
optimizer makes its slots, `distributed.place_model_states` cuts each
such parameter down to this rank's block. From then on `compile`'s
forward and the eval step run under the mesh's axes (every rank calls
them together: the blocks need the collectives), the distributed step
draws dropout by the rank's index over the mesh's axes other than the
tensor-parallel ones (their ranks hold the same activations), and
`get_states` / `save_states` all-gather the blocks back to full arrays,
so a checkpoint does not depend on the layout; `set_states`,
`load_states` and `load_singa_tpu_states` take full arrays and copy
each rank's block.
"""

from __future__ import annotations

import contextlib
import io
import zipfile
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from singa_tpu_torch import autograd
from singa_tpu_torch import layout as layout_module
from singa_tpu_torch.communicator import Communicator
from singa_tpu_torch.distributed import (gather_full, is_rank_local,
                                         place_model_states)
from singa_tpu_torch.graph import (GraphStep, check_param_shard_divisibility,
                                   check_pipelined_stacks,
                                   check_sharded_layers, fault_counters)
from singa_tpu_torch.layer import (Layer, _accepted_shapes, _copy_into,
                                   block_source)
from singa_tpu_torch.parallel import mesh as mesh_module

__all__ = ["Model", "load_singa_tpu_params", "load_singa_tpu_states"]


class Model(Layer):
    """Base user model; `named_parameters()` gives the reference's
    dotted parameter names. Subclasses define `forward` and
    `train_one_batch`."""

    def __init__(self):
        super().__init__()
        self._optimizer = None
        # bound user implementation, captured by graph(): its presence
        # routes training-mode calls (and direct `train_one_batch` calls)
        # to the training step
        self._user_train_one_batch = None
        self._use_graph = False
        self._train_step: Optional[GraphStep] = None
        self._eval_step: Optional[GraphStep] = None

    def _apply_opt(self, loss, dist_option: str = "plain", spars=None):
        """The reference trainers' optimizer dispatch: plain (fused
        all-reduce), half (bf16 wire), sparse-topk or sparse-thresh.
        With a plain (not distributed) optimizer every option takes a
        local step, as the reference's does; `spars=None` keeps the
        optimizer's own sparsity."""
        opt = self._optimizer
        if opt is None:
            raise RuntimeError("no optimizer: call set_optimizer() first")
        kw = {} if spars is None else {"spars": spars}
        if dist_option == "plain" or not hasattr(
                opt, "backward_and_sparse_update"):
            opt(loss)
        elif dist_option == "half":
            opt.backward_and_update_half(loss)
        elif dist_option == "sparse-topk":
            opt.backward_and_sparse_update(loss, topK=True, **kw)
        elif dist_option == "sparse-thresh":
            opt.backward_and_sparse_update(loss, topK=False, **kw)
        else:
            raise ValueError(f"unknown dist_option {dist_option!r}")

    def set_image_layout(self, img_layout: str) -> None:
        """Run this model's forward in `img_layout` ("NCHW" or "NHWC")
        while its 4-D inputs and outputs stay NCHW: under "NHWC" a 4-D
        input is copied into channels-last memory once at the boundary
        and a 4-D output back. Weights keep their OIHW shapes. Call
        before `compile()`; "NCHW" restores the default. A change drops
        the captured steps."""
        if img_layout not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown image layout {img_layout!r}")
        if getattr(self, "_img_layout", None) == img_layout:
            return
        if getattr(self, "_img_layout", None) is None:
            inner = type(self).forward.__get__(self)

            def adapt(a, convert):
                return convert(a) if getattr(a, "ndim", 0) == 4 else a

            def adapt_out(o):
                if isinstance(o, (tuple, list)):
                    return type(o)(adapt_out(v) for v in o)
                return adapt(o, layout_module.to_nchw)

            def wrapped_forward(*args, **kwargs):
                with layout_module.use_image_layout(self._img_layout):
                    out = inner(
                        *[adapt(a, layout_module.from_nchw) for a in args],
                        **{k: adapt(v, layout_module.from_nchw)
                           for k, v in kwargs.items()})
                    return adapt_out(out)

            self.forward = wrapped_forward
        self._img_layout = img_layout
        self._train_step = self._eval_step = None

    @property
    def memory_estimate(self):
        """The native planner's {"ops", "peak_bytes", "naive_bytes"} for
        the training step, else the eval step; None before a graph-mode
        step has been planned. `ops` counts PyTorch's autograd nodes."""
        for step in (self._train_step, self._eval_step):
            if step is not None and step.memory_plan is not None:
                return step.memory_plan
        return None

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def fault_counters(self) -> Optional[Dict]:
        """The resilience sentinel's skip and loss-scale counters of this
        model's optimizer, merged with the supervisor counters
        (`graph.fault_counters`, reference :265-282); None without a
        sentinel when no supervisor event has fired."""
        return fault_counters(self._optimizer)

    def set_optimizer(self, opt) -> None:
        """Use `opt` for the training step; its slots take this model's
        parameter names, now if every parameter exists, else after
        `compile`'s forward has made them (the reference names them at
        its first traced step)."""
        self._optimizer = opt
        self._train_step = None
        self._prepare_optimizer()

    def _prepare_optimizer(self) -> None:
        params = dict(self.named_parameters())
        if self._optimizer is not None and not any(
                isinstance(p, UninitializedParameter)
                for p in params.values()):
            comm = getattr(self._optimizer, "comm", None)
            if comm is not None and comm._active() and any(
                    getattr(p, "pspec", None) for p in params.values()):
                # a pipelined stack's own refusal before the generic one
                # of its stacked dims, as the reference's order gives it
                check_pipelined_stacks(self, comm.mesh)
                check_param_shard_divisibility(params, comm.mesh)
                place_model_states(comm.mesh, self)
            self._optimizer.prepare(params)

    def _placed_mesh(self):
        """The mesh this model's parameters are placed on, or None."""
        for p in self.parameters():
            placed = getattr(p, "placed", None)
            if placed is not None:
                return placed[2]
        return None

    def _tp_axes(self) -> tuple:
        """The mesh axes the placed parameters are split over."""
        axes = []
        for p in self.parameters():
            placed = getattr(p, "placed", None)
            for entry in (placed[1] if placed else ()):
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a and a not in axes:
                        axes.append(a)
        return tuple(axes)

    def _placed_axes(self):
        """A context with the axes the placed parameters are split over
        live (their blocks compute only with the collectives), else a
        no-op. The other axes of the mesh stay off: a forward outside
        the distributed step (`compile`'s, the eval step's) has its
        whole batch and sequence, as the reference's runs outside its
        SPMD step, so a sequence axis must not cut or offset it."""
        mesh = self._placed_mesh()
        if mesh is None:
            return contextlib.nullcontext()
        return mesh_module.axes_context(*self._tp_axes(), mesh=mesh)

    def compile(self, inputs: Sequence, is_train: bool = True,
                use_graph: bool = False, sequential: bool = False,
                precision: Optional[str] = None) -> None:
        """Run one forward without a tape (the reference infers shapes
        there), then set the mode and the execution mode.
        precision="bf16" turns on the autocast policy for this process
        (fp32 master weights, bf16 matrix-product operands);
        precision="fp32" turns it off."""
        if precision is not None:
            if precision not in ("fp32", "bf16"):
                raise ValueError(f"unknown precision {precision!r}")
            autograd.set_autocast(precision == "bf16")
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        with torch.no_grad(), self._placed_axes():
            self.forward(*inputs)
        self._prepare_optimizer()
        self.train(is_train)
        self.graph(use_graph, sequential)

    def graph(self, mode: bool = True, sequential: bool = False) -> None:
        """Route training-mode calls and direct `train_one_batch` calls
        to the training step, and other calls to the eval step: captured
        (`GraphStep`) when `mode`, eager otherwise. Drops the steps
        captured so far. `sequential` is accepted for the reference's
        API: the stream orders the step's kernels either way."""
        del sequential
        self._use_graph = bool(mode)
        self._train_step = self._eval_step = None
        if self._user_train_one_batch is None:
            self._user_train_one_batch = type(self).train_one_batch.__get__(
                self)
            # an instance attribute shadows the class's method: direct
            # `m.train_one_batch(x, y)` calls (the reference trainers'
            # style) take the route of `m(x, y)`, as the reference's
            # `__getattribute__` routes them
            self.train_one_batch = self._dispatch_train

    def _dist_comm(self):
        """The DistOpt communicator whose process group the step runs
        over, or None."""
        comm = getattr(self._optimizer, "comm", None)
        return comm if comm is not None and comm._active() else None

    def _seq_layout(self, comm):
        """(seq axis, its size) of a sequence-parallel model's
        distributed step: the model's `seq_axis` when the mesh has it,
        else (None, 1)."""
        ax = getattr(self, "seq_axis", None)
        mesh = comm.mesh
        if ax is None or mesh is None or ax not in mesh.axis_names:
            return None, 1
        return ax, mesh.axis_size(ax)

    def _moe_layout(self, comm):
        """(expert axis, its size) of an expert-parallel model's
        distributed step: the model's `moe_axis` when the mesh has it,
        else (None, 1)."""
        ax = getattr(self, "moe_axis", None)
        mesh = comm.mesh
        if ax is None or mesh is None or ax not in mesh.axis_names:
            return None, 1
        return ax, mesh.axis_size(ax)

    def _seq_args(self, args, world: int, check: bool) -> set:
        """The indices of the step's token arguments, cut along dim 1
        over the seq axis (reference graph.py:485-509): the model's
        `seq_sharded_args` (per method when a dict), else every tensor
        argument of ndim >= 2 whose dim 1 divides by the axis. `check`
        raises the reference's ValueError on a declared argument whose
        dim 1 does not divide."""
        declared = getattr(self, "seq_sharded_args", None)
        if isinstance(declared, dict):
            declared = declared.get("train_one_batch")
        shapes = {i: tuple(np.shape(a)) for i, a in enumerate(args)
                  if isinstance(a, (torch.Tensor, np.ndarray))}
        if declared is None:
            return {i for i, sh in shapes.items()
                    if len(sh) >= 2 and sh[1] % world == 0}
        out = set(declared) & set(shapes)
        for i in sorted(out):
            if check and (len(shapes[i]) < 2 or shapes[i][1] % world):
                raise ValueError(
                    f"seq-parallel graph mode: arg {i} (shape {shapes[i]}) "
                    f"must have dim-1 divisible by the "
                    f"'{self.seq_axis}' axis size {world}")
        return out

    def _dispatch_train(self, *args, **kwargs):
        step, args = self._train_route(args)
        if self._use_graph:
            if self._train_step is None:
                self._train_step = GraphStep(self, step, train_step=True)
            return self._train_step(*args, **kwargs)
        return step(*args, **kwargs)

    def _train_route(self, args):
        """(the step function, its arguments) of a training call: the
        user's `train_one_batch` on the arguments as they are, or, under
        a DistOpt over a live group, the distributed step on this rank's
        share of them."""
        comm = self._dist_comm()
        step = self._user_train_one_batch
        if comm is not None:
            moe_ax, ep_world = self._moe_layout(comm)
            check_sharded_layers(self, comm.mesh, moe_ax, ep_world)
            ep = None
            if ep_world > 1:
                ep = (ep_world, comm.mesh.axis_index(moe_ax))
                # each expert shard sees other tokens: the gradients of
                # replicated parameters are partial over the axis
                if moe_ax not in self._optimizer.grad_axes:
                    self._optimizer.grad_axes = tuple(
                        self._optimizer.grad_axes) + (moe_ax,)
            ax, sp_world = self._seq_layout(comm)
            seq = None
            if sp_world > 1:
                seq = (sp_world, comm.mesh.axis_index(ax),
                       self._seq_args(args, sp_world, check=True))
                # each seq shard sees other tokens: the gradients of
                # replicated parameters are partial over the axis
                if ax not in self._optimizer.grad_axes:
                    self._optimizer.grad_axes = tuple(
                        self._optimizer.grad_axes) + (ax,)
            args = _rank_share(args, comm, seq, ep)
            step = self._dist_train
        return step, args

    def _dispatch_eval(self, *args, **kwargs):
        """`forward` through the eval step in graph mode (a DistOpt
        model's too: its eval runs on each rank's own inputs, as the
        reference's), else as a plain module call."""
        if self._use_graph:
            if self._eval_step is None:
                self._eval_step = GraphStep(self, self._placed_forward,
                                            train_step=False)
            return self._eval_step(*args, **kwargs)
        with torch.set_grad_enabled(
                autograd.training and torch.is_grad_enabled()), \
                self._placed_axes():
            return super().__call__(*args, **kwargs)

    def _placed_forward(self, *args, **kwargs):
        with self._placed_axes():
            return self.forward(*args, **kwargs)

    def _dist_train(self, *args, **kwargs):
        """The distributed step (the reference's SPMD wrapper,
        `singa_tpu/graph.py:431-700`) on this rank's share of the batch
        (`_rank_share`: its rows, and for a sequence-parallel model its
        dim-1 shard of the token arguments), under every axis of the
        mesh (`axes_context`) and the data group's batch axis (BatchNorm
        syncs its moments over it); then an output with this share's
        rows (the logits) is gathered back into the global batch (along
        the sequence first where it is seq-sharded), a floating output
        without them (the loss) is averaged over the data and seq
        groups, and so are the floating buffers (BatchNorm's running
        statistics). Dropout draws this rank's stream
        (`autograd.rank_draws` of its rank in the mesh: rank 0 the
        default generator, so a world-1 step is the plain one), as the
        reference folds the axis indices into the step's key."""
        comm = self._optimizer.comm
        mesh = comm.mesh
        ax, sp_world = self._seq_layout(comm)
        seq_comm = Communicator(mesh, ax) if sp_world > 1 else None
        moe_ax, ep_world = self._moe_layout(comm)
        ep_comm = Communicator(mesh, moe_ax) if ep_world > 1 else None
        # the other token-sharding axes: means over them too
        token_comms = [c for c in (seq_comm, ep_comm) if c is not None]
        # dropout draws by the rank's index over every axis but the
        # tensor-parallel ones (a ZeRO-3 or expert shard is a batch shard)
        tp_only = set(self._tp_axes()) - {comm.axis_name, moe_ax}
        local_t = None
        if seq_comm is not None:
            idx = self._seq_args(args, sp_world, check=False)
            local_t = args[min(idx)].shape[1] if idx else None
        b = next(a.shape[0] for a in args if isinstance(a, torch.Tensor))
        with mesh_module.axes_context(*mesh.axis_names, mesh=mesh), \
                mesh_module.batch_axis_context(
                    comm.axis_name, comm.world_size, comm.group), \
                autograd.rank_draws(mesh.flat_index(
                    [a for a in mesh.axis_names if a not in tp_only])):
            out = self._user_train_one_batch(*args, **kwargs)

        def merge(t):
            if not isinstance(t, torch.Tensor):
                return t
            t = t.detach()
            if t.dim() and t.shape[0] == b:
                if local_t is not None and t.dim() >= 2 and (
                        t.shape[1] == local_t):
                    t = seq_comm.all_gather(t, axis=1)
                if ep_comm is not None:  # rows (data, expert), data major
                    t = ep_comm.all_gather(t)
                return comm.all_gather(t)
            if t.is_floating_point():
                t = comm.all_reduce(t)
                for c in token_comms:
                    t = c.all_reduce(t)
            return t

        with torch.no_grad():
            bufs = [t for t in self.buffers() if t.is_floating_point()]
            avgs = comm.fused_all_reduce(
                bufs, bucket_elems=self._optimizer.buffSize)
            for c in token_comms:
                avgs = c.fused_all_reduce(
                    avgs, bucket_elems=self._optimizer.buffSize)
            for buf, avg in zip(bufs, avgs):
                buf.copy_(avg)
        if isinstance(out, (tuple, list)):
            return type(out)(merge(o) for o in out)
        return merge(out)

    def train(self, mode: bool = True):
        super().train(mode)
        autograd.training = bool(mode)
        return self

    def train_one_batch(self, *args):
        raise NotImplementedError(
            "Model subclasses must define train_one_batch")

    def __call__(self, *args, **kwargs):
        if self.training and self._user_train_one_batch is not None:
            return self._dispatch_train(*args, **kwargs)
        return self._dispatch_eval(*args, **kwargs)

    # -- the state API over placed blocks ------------------------------------
    def get_states(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Parameters and buffers by name, a placed block as its full
        array (all-gathered: a collective on every rank of its mesh)."""
        return {k: gather_full(v)
                for k, v in super().get_states(prefix).items()}

    def set_states(self, states: Mapping) -> None:
        """Copy full arrays (or blocks) into the live tensors, in place."""
        _copy_into(Layer.get_states(self), states, "state")

    # -- the reference's single-file checkpoint -----------------------------
    def save_states(self, fpath: str, aux_states: Optional[Dict] = None
                    ) -> None:
        """Write parameters and buffers (and `aux_states`) as one zip of
        `.npy` entries, the reference's layout."""
        def host(v):
            return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v))

        with zipfile.ZipFile(fpath, "w", zipfile.ZIP_STORED) as zf:
            for group, d in (("states", self.get_states()),
                             ("aux", aux_states or {})):
                for k, v in d.items():
                    buf = io.BytesIO()
                    np.save(buf, host(v), allow_pickle=False)
                    zf.writestr(f"{group}/{k}.npy", buf.getvalue())

    def load_states(self, fpath: str) -> Dict[str, np.ndarray]:
        """Load a `save_states` archive (either package's) into this
        model's parameters and buffers, in place; returns the aux
        states. Other entries (the reference's `meta/pspec.json`) are
        skipped."""
        states, aux = {}, {}
        with zipfile.ZipFile(fpath, "r") as zf:
            for info in zf.infolist():
                group, _, key = info.filename.partition("/")
                if group not in ("states", "aux") or not key.endswith(
                        ".npy"):
                    continue
                arr = np.load(io.BytesIO(zf.read(info)), allow_pickle=False)
                (states if group == "states" else aux)[key[:-4]] = arr
        self.set_states(states)
        return aux


def _rank_share(args, comm, seq=None, ep=None) -> list:
    """This rank's share of a distributed step's batch operands. Operands
    from `distributed.shard_batch` are that share already; plain ones
    are the global batch (the reference's step takes it), of which this
    rank runs rows [rank * b, (rank + 1) * b), and with `seq` = (seq
    world, this rank's seq index, the token argument indices) columns
    [index * t, (index + 1) * t) of dim 1 of each token argument. With
    `ep` = (expert world, this rank's expert index) the rows are cut
    over (data, expert), data major (reference graph.py:455-472)."""
    batch = [a for a in args if isinstance(a, (torch.Tensor, np.ndarray))]
    marked = [is_rank_local(a) for a in batch]
    if batch and all(marked):
        return list(args)
    if any(marked):
        raise ValueError("a distributed step takes either every batch "
                         "operand from shard_batch or none")
    ep_world, ep_index = ep if ep is not None else (1, 0)
    world = comm.world_size * ep_world
    _check_batch(args, world)
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
            for a in args]
    b = next(a.shape[0] for a in args
             if isinstance(a, torch.Tensor)) // world
    row = comm.rank * ep_world + ep_index
    args = [a.narrow(0, row * b, b) if isinstance(a, torch.Tensor)
            else a for a in args]
    if seq is not None:
        world, index, cut = seq
        for i in cut:
            t = args[i].shape[1] // world
            args[i] = args[i].narrow(1, index * t, t)
    return args


def _check_batch(args, world: int) -> None:
    """The reference's refusal: every tensor operand of a distributed
    step has a leading batch dim divisible by the world."""
    for a in args:
        shape = tuple(np.shape(a)) if isinstance(
            a, (torch.Tensor, np.ndarray)) else None
        if shape is not None and (not shape or shape[0] % world):
            raise ValueError(
                "distributed graph mode: every step argument must have a "
                "leading batch dim divisible by the batch world size "
                f"{world}; got shape {shape}")


def _copy_named(own: Mapping[str, torch.Tensor],
                given: Mapping[str, np.ndarray]) -> None:
    unknown = sorted(set(given) - set(own))
    missing = sorted(set(own) - set(given))
    if unknown or missing:
        raise KeyError(f"names differ: unknown {unknown}, "
                       f"missing {missing}")
    bad = {k: (tuple(np.shape(v)), tuple(own[k].shape))
           for k, v in given.items()
           if tuple(np.shape(v)) not in _accepted_shapes(own[k])}
    if bad:
        raise ValueError(f"shape mismatch (given, expected): {bad}")
    with torch.no_grad():
        for k, v in given.items():
            # a placed block takes its block of the full array
            own[k].copy_(block_source(own[k], torch.from_numpy(np.array(v))))


def load_singa_tpu_params(model: nn.Module,
                          params: Mapping[str, np.ndarray]) -> None:
    """Copy reference parameters into `model`, name for name. Raises on
    an unknown name, a missing name or a shape mismatch."""
    _copy_named(dict(model.named_parameters()), params)


def load_singa_tpu_states(model: nn.Module,
                          states: Mapping[str, np.ndarray]) -> None:
    """Copy a reference model's `get_states()` (parameters and buffers)
    into `model`, name for name; a parameter placed on a mesh takes this
    rank's block of the full array (a tp stack's QKV is head-interleaved
    in both packages, so it carries across as it is). Raises on an
    unknown name, a missing name or a shape mismatch."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    _copy_named(own, states)
