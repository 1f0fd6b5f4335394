"""Tape -> C++ StableHLO lowering bridge (counterpart of
singa_tpu/native/hlo_bridge.py).

`lower_tape(out)` walks the tape reaching `out` and replays it into the
C++ graph buffer (`native.HloGraphBuilder`, `native/hlo_core.cc`), which
writes the StableHLO module text. `lower_train_step(loss, params, lr)`
emits the whole SGD training step as one module: the forward, the
hand-derived adjoints, with `n_replicas > 1` one gradient `all_reduce`
a parameter (fp32, or on the bf16 wire: convert, reduce, convert back)
and the mean, then `p - lr * g`; its outputs are the loss and every
updated parameter. The ops it lowers are the reference's: `Linear` with
2 or 3 inputs (the port's `MatMul` is the 2-input one), `Add`, `Relu`,
`Tanh`, `Sigmoid`, `softmax_cross_entropy` with its one-hot target, and
an inactive Dropout's `Identity`, passed through; any other op raises
NotImplementedError by name.

The tape is the port's `autograd.TapeRecorder`: build the forward and
the loss inside one, right before lowering, as the reference's callers
build theirs with `autograd.training` set::

    with autograd.TapeRecorder():
        loss = autograd.softmax_cross_entropy(m.forward(x), onehot)
    step = lower_train_step(loss, params, 0.05, inputs=[x])

The walk is the reference's depth-first `visit`: leaves (parameters,
inputs) are numbered as first visited, and the one-hot target where the
loss is visited, so for the same widths and batch the text equals the
reference's character for character.

`NativeTrainStep.run_steps(batches)` compiles the text once through the
runtime (`hlo_runtime.HloRuntime`: CUDA through PyTorch, the card unless
`device="cpu"`), then runs it a batch at a time, the parameters staying
on the device and fed back between steps; on the card the program is
captured as one CUDA Graph on its second step. `run_replicated(step,
batches)` runs an n-replica module on the n ranks of the process group,
each on its own rows, and checks after each step that the updated
parameters are bitwise identical on every rank. `run_native(out)` runs a
forward module; `compile_stablehlo(text)` compiles text through the
runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from singa_tpu_torch import autograd
from singa_tpu_torch.native import HloGraphBuilder

__all__ = ["lower_tape", "run_native", "lower_train_step",
           "NativeTrainStep", "compile_stablehlo", "run_replicated"]

#: the port's op kinds the lowering reads -> the reference's op names
_KINDS = {"Linear": "Linear", "MatMul": "Linear", "Add": "Add",
          "Relu": "ReLU", "Tanh": "Tanh", "Sigmoid": "Sigmoid",
          "SoftMaxCrossEntropy": "SoftMaxCrossEntropy"}


def compile_stablehlo(text: str, device=None, group=None):
    """(runtime, handle) of `text` compiled on `device` (the card by
    default) for the collectives of `group` (the current process
    group)."""
    from singa_tpu_torch.native.hlo_runtime import HloRuntime

    rt = HloRuntime(device)
    return rt, rt.compile_mlir(text, group=group)


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.array(a, np.float32)  # a copy: never the tensor's storage


def lower_tape(out: torch.Tensor) -> Tuple[str, List[np.ndarray]]:
    """(module text, leaf values) of the tape producing `out`: the leaves
    (parameters and inputs) in the module's argument order."""
    b = HloGraphBuilder()
    try:
        root, leaves, _ = _lower_forward(b, out)
        text = b.emit(root)
    finally:
        b.close()
    return text, [arr for _, _, arr in leaves]


@dataclass
class NativeTrainStep:
    """A full SGD training step lowered to one C++-emitted StableHLO
    module: forward, backward and the parameter update. Its arguments are
    `args` in order; its outputs the loss and each updated parameter."""

    text: str
    args: List[np.ndarray]
    param_idx: List[int]           # arg slots of the trainable params
    input_idx: List[int]           # arg slots of the per-batch inputs
    target_idx: int                # arg slot of the one-hot target
    out_shapes: List[tuple]        # [()] + param shapes
    n_replicas: int = 1            # replica count the module was built for

    def declared_hlo_census(self) -> Dict[str, int]:
        """The collectives this emitter commits to: one gradient
        all_reduce a trainable parameter when data-parallel, none at one
        replica. Shardlint's R7 holds the emitted text to it."""
        n = len(self.param_idx) if self.n_replicas > 1 else 0
        return {"all_reduce": n}

    def runner(self, device=None, group=None) -> "StepRunner":
        """The step compiled on `device`, its arguments on the device."""
        return StepRunner(self, device, group)

    def run_steps(self, batches, device=None) -> List[float]:
        """Train a batch at a time over ``(inputs, onehot)`` batches
        (`inputs` one array a `input_idx` slot): one compile, one run a
        batch, the updated parameters fed back. Returns the losses."""
        run = self.runner(device)
        for inputs, onehot in batches:
            run.step(inputs, onehot)
        return run.losses()


class StepRunner:
    """A `NativeTrainStep` compiled on one device (`run_steps`): the
    arguments live on the device; `step` copies a batch in, runs the
    module and copies the updated parameters back into their slots; the
    losses stay on the device until `losses()`."""

    def __init__(self, step: NativeTrainStep, device=None, group=None):
        self.step_def = step
        self.rt, handle = compile_stablehlo(step.text, device, group)
        self.exe = self.rt.executable(handle)
        self.device = self.rt.device
        self.args = [torch.tensor(a, dtype=torch.float32, device=self.device)
                     for a in step.args]
        self._losses: List[torch.Tensor] = []

    def _put(self, slot: int, value) -> None:
        src = torch.as_tensor(value).to(self.device, torch.float32)
        if tuple(src.shape) != tuple(self.args[slot].shape):
            raise ValueError(f"argument {slot}: shape {tuple(src.shape)}, "
                             f"the module takes "
                             f"{tuple(self.args[slot].shape)}")
        self.args[slot].copy_(src)

    def step(self, inputs: Sequence, onehot) -> List[torch.Tensor]:
        s = self.step_def
        if len(inputs) != len(s.input_idx):
            raise ValueError(
                f"{len(inputs)} input array(s) for {len(s.input_idx)} input "
                f"slot(s)")
        for slot, arr in zip(s.input_idx, inputs):
            self._put(slot, arr)
        self._put(s.target_idx, onehot)
        outs = self.exe.run(self.args)
        if self.exe.static_inputs is not None:
            # a capture holds its own copies: run on them from now on
            self.args = list(self.exe.static_inputs)
        for slot, new in zip(s.param_idx, outs[1:]):
            self.args[slot].copy_(new)
        self._losses.append(outs[0].detach().clone())
        return outs

    def params(self) -> List[torch.Tensor]:
        return [self.args[slot] for slot in self.step_def.param_idx]

    def losses(self) -> List[float]:
        return torch.stack(self._losses).tolist() if self._losses else []


def _lower_forward(b: HloGraphBuilder, out: torch.Tensor):
    """Replay the tape reaching `out` into the C++ buffer. Returns
    (root value id, leaves as [(tensor or None, id, array)], nodes as
    [(name, input ids, output id, aux)] in topological order). The tape
    keeps every tensor it reaches alive, so ids stay unique."""
    ids: Dict[int, int] = {}
    leaves: List[Tuple[Optional[torch.Tensor], int, np.ndarray]] = []
    nodes: List[tuple] = []

    def visit(t: torch.Tensor) -> int:
        if id(t) in ids:
            return ids[id(t)]
        node = autograd.tape_node(t)
        if node is None:
            arr = _as_f32(t)
            vid = b.param(arr.shape)
            leaves.append((t, vid, arr))
            ids[id(t)] = vid
            return vid
        name = _KINDS.get(node.kind, node.kind)
        ins = [visit(x) for x in node.inputs]
        if name == "Identity" and len(ins) == 1:
            ids[id(t)] = ins[0]
            return ins[0]
        aux: dict = {}
        if name == "Linear":
            if len(ins) == 2:
                vid = b.dot(ins[0], ins[1])
            elif len(ins) == 3:
                vid = b.add_bias(b.dot(ins[0], ins[1]), ins[2])
            else:
                raise NotImplementedError(
                    f"native lowering: Linear with {len(ins)} inputs")
        elif name == "Add":
            vid = b.add(ins[0], ins[1])
        elif name == "ReLU":
            vid = b.relu(ins[0])
        elif name == "Tanh":
            vid = b.tanh(ins[0])
        elif name == "Sigmoid":
            vid = b.logistic(ins[0])
        elif name == "SoftMaxCrossEntropy":
            oh = np.asarray(node.aux, np.float32)
            bsz = oh.shape[0]
            oh_vid = b.param(oh.shape)
            leaves.append((None, oh_vid, oh))
            lg = ins[0]
            # log-softmax as jax lowers it: shift by the row max, exp,
            # row-sum, log, shift again
            mx = b.reduce_max(lg, 1)
            z = b.sub(lg, b.bcast_axis(mx, lg, 0))
            e = b.exp(z)
            s = b.reduce_sum(e, 1)
            logp = b.sub(z, b.bcast_axis(b.log(s), lg, 0))
            row = b.reduce_sum(b.mul(oh_vid, logp), 1)
            vid = b.scale(b.reduce_sum(row, 0), -1.0 / bsz)
            aux = {"logp": logp, "onehot": oh_vid, "batch": bsz}
        else:
            raise NotImplementedError(
                f"native StableHLO lowering does not cover op "
                f"{node.kind!r}; the graph path (graph.py) does")
        ids[id(t)] = vid
        nodes.append((name, ins, vid, aux))
        return vid

    root = visit(out)
    return root, leaves, nodes


def lower_train_step(loss: torch.Tensor, params: List[torch.Tensor],
                     lr: float, inputs: Sequence[torch.Tensor] = (),
                     n_replicas: int = 1, wire: str = "fp32"
                     ) -> NativeTrainStep:
    """Lower the SGD training step of the tape ending at the scalar
    `loss` (module docstring). `params` are the trainable leaves, their
    updates output in this order; `inputs` the per-batch leaves whose
    argument slots a run loop swaps; the loss's one-hot target is an
    extra slot (`target_idx`). `n_replicas > 1` emits the data-parallel
    step with the gradient sync on `wire` ("fp32" or "bf16")."""
    if wire not in ("fp32", "bf16"):
        raise ValueError(f"wire must be 'fp32' or 'bf16', got {wire!r}")
    if autograd.tape_node(loss) is None:
        raise ValueError("the loss has no recorded tape: build the forward "
                         "and the loss inside autograd.TapeRecorder()")
    b = HloGraphBuilder()
    try:
        return _lower_train_step(b, loss, params, lr, inputs, n_replicas,
                                 wire)
    finally:
        b.close()


def _lower_train_step(b, loss, params, lr, inputs, n_replicas, wire):
    root, leaves, nodes = _lower_forward(b, loss)

    # backward: reverse-topological walk with grad accumulation, every
    # adjoint emitted through the C++ buffer
    grads: Dict[int, int] = {}

    def accum(vid: int, g: int) -> None:
        grads[vid] = b.add(grads[vid], g) if vid in grads else g

    for name, ins, out_vid, aux in reversed(nodes):
        if name == "SoftMaxCrossEntropy":
            if out_vid != root:
                raise NotImplementedError(
                    "native lowering: the loss must be the tape root")
            # d(mean CE)/dlogits = (rowsum(t) * softmax - t) / batch, the
            # general form for float targets
            sm = b.exp(aux["logp"])
            rows = b.bcast_axis(b.reduce_sum(aux["onehot"], 1), sm, 0)
            accum(ins[0], b.scale(b.sub(b.mul(rows, sm), aux["onehot"]),
                                  1.0 / aux["batch"]))
            continue
        if out_vid not in grads:
            continue  # a branch that does not reach the loss
        dy = grads[out_vid]
        if name == "Linear":
            x_vid, w_vid = ins[0], ins[1]
            accum(x_vid, b.dot(dy, b.transpose(w_vid)))
            accum(w_vid, b.dot(b.transpose(x_vid), dy))
            if len(ins) == 3:
                accum(ins[2], b.reduce_sum(dy, 0))
        elif name == "Add":
            accum(ins[0], dy)
            accum(ins[1], dy)
        elif name == "ReLU":
            accum(ins[0], b.select_gt0(ins[0], dy))
        elif name == "Tanh":
            accum(ins[0], b.sub(dy, b.mul(dy, b.mul(out_vid, out_vid))))
        elif name == "Sigmoid":
            accum(ins[0], b.mul(dy, b.sub(out_vid, b.mul(out_vid, out_vid))))

    # the SGD update of each trainable parameter, in the caller's order
    leaf_vid = {id(t): vid for t, vid, _ in leaves if t is not None}
    arg_slot = {vid: i for i, (_, vid, _) in enumerate(leaves)}
    updated = []
    for p in params:
        vid = leaf_vid.get(id(p))
        if vid is None:
            raise ValueError("param is not a leaf of this tape")
        if vid not in grads:
            raise ValueError("param receives no gradient on this tape")
        g = grads[vid]
        if n_replicas > 1:
            # the gradient sync: the fp32 all_reduce, or the bf16 half
            # wire (compress, reduce, decompress), then the mean
            if wire == "bf16":
                g = b.convert(
                    b.all_reduce_sum(b.convert(g, "bf16"), n_replicas),
                    "f32")
            else:
                g = b.all_reduce_sum(g, n_replicas)
            g = b.scale(g, 1.0 / n_replicas)
        updated.append(b.sub(vid, b.scale(g, float(lr))))

    target_idx = -1
    for t, vid, _ in leaves:
        if t is None:
            target_idx = arg_slot[vid]
    for t in inputs:
        if id(t) not in leaf_vid:
            raise ValueError("input is not a leaf of this tape")
    text = b.emit_multi([root] + updated, n_replicas=n_replicas)
    return NativeTrainStep(
        text=text, args=[arr for _, _, arr in leaves],
        param_idx=[arg_slot[leaf_vid[id(p)]] for p in params],
        input_idx=[arg_slot[leaf_vid[id(t)]] for t in inputs],
        target_idx=target_idx,
        out_shapes=[()] + [tuple(p.shape) for p in params],
        n_replicas=n_replicas)


def run_replicated(step: NativeTrainStep, batches, group=None,
                   device=None) -> List[List[float]]:
    """Run the n-replica `step` on the ranks of `group` (the current
    process group), one replica a rank, over ``(inputs, onehot)`` global
    batches: rank r runs rows [r * local_b, (r + 1) * local_b) of each.
    After each step the updated parameters must be bitwise identical on
    every rank (their check is not part of the module and issues no
    record); a difference raises, naming the parameter slot and the
    step. Returns each step's per-rank losses."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size(group) if live else 1
    me = dist.get_rank(group) if live else 0
    run = step.runner(device, group)
    out: List[List[float]] = []
    for i, (inputs, onehot) in enumerate(batches):
        local = []
        for arr in list(inputs) + [onehot]:
            a = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
                np.asarray(arr, np.float32))
            b = a.shape[0] // n
            local.append(a[me * b:(me + 1) * b])
        outs = run.step(local[:-1], local[-1])
        loss = outs[0].detach().reshape(1).float()
        if not live:
            out.append([float(loss)])
            continue
        rows = [torch.empty_like(loss) for _ in range(n)]
        dist.all_gather(rows, loss, group=group)
        out.append([float(r) for r in rows])
        for k, (slot, p) in enumerate(zip(step.param_idx, run.params())):
            bits = p.detach().contiguous().view(torch.int32).flatten()
            peers = [torch.empty_like(bits) for _ in range(n)]
            dist.all_gather(peers, bits, group=group)
            bad = [r for r in range(n) if not torch.equal(peers[r], bits)]
            if bad:
                raise AssertionError(
                    f"run_replicated: step {i}: parameter {k} (argument "
                    f"slot {slot}) differs between rank {me} and rank(s) "
                    f"{bad}: the replicas are parted")
    return out


def run_native(out: torch.Tensor, device=None) -> np.ndarray:
    """Run `out`'s tape through the native path: the C++-emitted text,
    compiled and run by the runtime on `device` (the card by default)."""
    text, leaves = lower_tape(out)
    rt, handle = compile_stablehlo(text, device)
    try:
        return rt.run_f32(handle, leaves, tuple(out.shape))
    finally:
        rt.free_executable(handle)
