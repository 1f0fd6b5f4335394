"""Autograd (counterpart of singa_tpu/autograd.py).

PyTorch's own tape stands in for the reference's `Operator` tape. Ported
on top of it:

- the autocast policy (reference :143-194): off by default (fp32
  everywhere); when on, matrix-product operands are cast to the autocast
  dtype (bf16) and, under `keep_activations=True`, the bf16 result flows
  on as the activation stream, else it rejoins fp32 after the product;
- `training` (reference :126), the flag `Model.train()` sets: when it is
  False a model's forward records no tape;
- `backward` and `grad_pairs` (reference :559-634): the (param, grad)
  pairs of every parameter the loss reaches, computed fresh on each call
  with `torch.autograd.grad` (nothing accumulates in `.grad`);
- the remat policies `REMAT_POLICIES` and `remat_wrap` (reference
  :427-450) on `torch.utils.checkpoint`;
- `softmax_cross_entropy` / `cross_entropy` (reference :1507-1533);
- the CNN ops, as plain functions on tensors: `conv2d` (explicit pads,
  or "same"/"valid" with XLA's pad placement), `batchnorm`,
  `max_pool2d`, `avg_pool2d`, `global_avg_pool2d`, `relu`, `add` and
  `flatten` (reference :640-682, :895, :982-1323), and the activations
  `leakyrelu`, `sigmoid` and `softmax` (reference :899-935). Under the "NHWC"
  image layout (`layout.py`) the activations are channels-last tensors
  of logical NCHW shape, so every op indexes channels on axis 1;
- the transformer's plain tensor functions `linear` (the bias joined at
  the product's output dtype), `gelu` (tanh approximation by default,
  as `jax.nn.gelu`), `tanh` and `reshape` (reference :670, :909-924,
  :950-965);
- the recurrent ops `vanilla_rnn`, `lstm` and `gru` (reference
  :1356-1500), time-major: the input projection of every step is one
  product, (T*B, in) x (in, G*H) + b, and a Python loop carries only the
  (B, H) x (H, G*H) recurrent product, where the reference runs a
  `lax.scan`. As in the reference, their products are plain `matmul`s
  outside the autocast policy;
- `embedding`, `layernorm`, `dropout`, `transpose` and `cat` (reference
  :676, :709, :1236, :1326-1352), which the layers call; `rank_draws`
  gives each rank of a distributed step its own dropout stream, as the
  reference folds the rank into the step's key (`singa_tpu/graph.py:
  669-674`);
- the export trace (`ExportTrace`, `op`), in place of the reference's
  `Function.meta` on its `Operator` tape (reference :531-546): every op
  above runs through `op(kind, attrs, fn, *inputs)`, which records
  (kind, attrs, extras, inputs, outputs) with the reference's ONNX kinds
  while `sonnx.to_onnx` traces, and otherwise only calls `fn` (one
  `is None` test); under a `TapeRecorder` the same slot tags each op's
  output (and `softmax_cross_entropy`'s loss, with its one-hot target)
  with a `TapeNode`, the reference's `creator`, which the native
  StableHLO lowering (`native.hlo_bridge`) walks;
- `Operator` and `Function` (reference :454-546), the reference's way to
  write an op: a pure `forward` on tensors and an optional `backward`,
  which defaults to the VJP of `forward` (`torch.func.vjp`), run as one
  `torch.autograd.Function` node;
- `clear_op_cache` and `set_op_cache_enabled` (reference :218-234);
- the rest of the reference's functional ops (reference :640-948,
  :1536): `sub mul div pow matmul squeeze unsqueeze split gather stack
  where clip abs exp log sqrt square maximum minimum max min prod var std
  cumsum cumprod norm sort argsort topk one_hot einsum pad elu erf
  softplus log_softmax sum mean mse_loss`, plain functions on tensors with
  the reference's signatures, defaults and tie rules (a reduction's max
  or min shares its gradient evenly among tied entries, elementwise
  `maximum`/`minimum` and `clip` give half to each side of a tie, `sort`
  and `topk` send gradients back through the permutation); `sort`,
  `argsort`, `topk`, `norm` and `one_hot` are `_kernels`' formulations,
  which `tensor` shares.

Names that shadow Python's builtins (`sum`, `max`, `min`, `abs`, `pow`)
are the reference's; code in this module reaches the builtins through
`builtins`.
"""

from __future__ import annotations

import builtins
import functools
import math
import threading
import warnings
import weakref
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from singa_tpu_torch import _kernels
from singa_tpu_torch import device as device_module
from singa_tpu_torch import layout as layout_module
from singa_tpu_torch.ops import max_pool

__all__ = ["set_autocast", "autocast_enabled", "autocast", "training",
           "backward", "grad_pairs", "REMAT_POLICIES", "remat_wrap",
           "softmax_cross_entropy", "cross_entropy", "add", "flatten",
           "relu", "leakyrelu", "sigmoid", "softmax", "conv2d",
           "DEGENERATE_STAT_COUNT", "batchnorm",
           "max_pool2d", "avg_pool2d", "global_avg_pool2d", "gelu", "tanh",
           "reshape", "linear", "vanilla_rnn", "lstm", "gru", "embedding",
           "layernorm", "dropout", "rank_draws", "draw_rank",
           "rank_generators", "reset_rank_draws", "rank_generator_states",
           "set_rank_generator_states", "transpose", "cat", "op",
           "ExportTrace", "TapeRecorder", "TapeNode", "tape_node",
           "clear_op_cache", "set_op_cache_enabled",
           "Operator", "Function", "sub", "mul", "div", "pow", "matmul",
           "squeeze", "unsqueeze", "split", "gather", "stack", "where",
           "clip", "abs", "exp", "log", "sqrt", "square", "maximum",
           "minimum", "max", "min", "prod", "var", "std", "cumsum",
           "cumprod", "norm", "sort", "argsort", "topk", "one_hot", "einsum",
           "pad", "elu", "erf", "softplus", "log_softmax", "sum", "mean",
           "mse_loss"]

#: reference parity: `Model.train(mode)` sets it; a model's forward
#: records no tape while it is False
training = False

_autocast = {"enabled": False, "dtype": torch.bfloat16, "keep": True}


def set_autocast(enabled: bool, dtype: torch.dtype = torch.bfloat16,
                 keep_activations: bool = True) -> None:
    _autocast["enabled"] = bool(enabled)
    _autocast["dtype"] = dtype
    _autocast["keep"] = bool(keep_activations)


def autocast_enabled() -> bool:
    return _autocast["enabled"]


class autocast:
    """Context manager: `with autograd.autocast(): ...`"""

    def __init__(self, enabled: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 keep_activations: bool = True):
        self.enabled, self.dtype = enabled, dtype
        self.keep = keep_activations

    def __enter__(self):
        self._prev = dict(_autocast)
        set_autocast(self.enabled, self.dtype, self.keep)

    def __exit__(self, *exc):
        _autocast.update(self._prev)


def _mxu_cast(*tensors: torch.Tensor):
    """Cast float operands to the autocast dtype (no-op when disabled)."""
    if not _autocast["enabled"]:
        return tensors
    dt = _autocast["dtype"]
    return tuple(t.to(dt) if t.is_floating_point() else t for t in tensors)


def _mxu_result(y: torch.Tensor) -> torch.Tensor:
    """Post-product dtype policy: the bf16 result as-is under
    keep_activations, else back to fp32."""
    if not _autocast["enabled"] or _autocast["keep"]:
        return y
    return y.float()


# -- the export trace ---------------------------------------------------------
#
# The reference's exporter walks its `Operator` tape and reads each op's
# `meta = (kind, attrs, extras)`. PyTorch's tape carries no such thing, so
# the SINGA-level ops record themselves: `op` runs `fn(*inputs)` and, while
# `sonnx.to_onnx` traces, appends (kind, attrs, extras, inputs, outputs) to
# the one active `ExportTrace`. A torch call made outside a recorded op on a
# traced tensor (a graph input or a recorded op's output) would otherwise
# leave a tensor the exporter cannot tell from a constant leaf; the trace
# marks what such calls make and raises when a recorded op consumes it.

#: the active export trace; None outside `sonnx.to_onnx`
_trace: Optional["ExportTrace"] = None


def op(kind: str, attrs, fn: Callable, *inputs: torch.Tensor,
       extras=()):
    """fn(*inputs) as one SINGA-level op of ONNX kind `kind` (the
    reference's `Function(fn, meta=(kind, attrs, extras))(*inputs)`);
    recorded only under an export trace."""
    if _trace is None:
        # the Device dispatch seam (reference :496-504): counted on the
        # device of the first tensor operand
        out = device_module.dispatch(fn, inputs, *inputs)
        if torch.is_grad_enabled():
            _tag_params(out, inputs)
        return out
    return _trace.op(kind, attrs, extras, fn, inputs)


#: the key under which an op's output node (`grad_fn.metadata`) lists the
#: parameters the op read, in input order (`_leaves` orders by it)
_PARAMS_KEY = "singa_params"


def _tag_params(out, inputs) -> None:
    params = [t for t in inputs if isinstance(t, torch.Tensor)
              and t.requires_grad and t.is_leaf]
    if params:
        for t in _tensors(out):
            if t.grad_fn is not None:
                t.grad_fn.metadata[_PARAMS_KEY] = params
                return


def _fn_name(func) -> str:
    qual = getattr(func, "__qualname__", None) or repr(func)
    cls, _, name = qual.rpartition(".")
    if cls == "_VariableFunctionsClass":
        return f"torch.{name}"
    if cls == "TensorBase":
        return f"Tensor.{name}"
    mod = getattr(func, "__module__", None)
    return f"{mod}.{qual}" if mod and not cls else qual


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


#: factories whose values only a later write gives: a tensor they make
#: outside a recorded op is never a constant the trace may bake
_UNINITIALIZED = {torch.empty, torch.empty_like, torch.empty_strided,
                  torch.Tensor.new_empty}


class ExportTrace(TorchFunctionMode):
    """One forward's record of SINGA-level ops, for `sonnx.to_onnx`.
    `with ExportTrace(inputs) as tr: out = model.forward(*inputs)`
    leaves `tr.ops`, a list of (kind, attrs, extras, inputs, outputs) in
    the order they ran. Only the thread that entered it records, never
    inside a CUDA Graph capture, and ops nested in a recorded op are part
    of it. Any torch call outside a recorded op that consumes a traced
    tensor, mutates one, or makes an uninitialized tensor marks what it
    makes; `check` raises, naming that torch function, when a recorded op
    or a graph output is such a tensor."""

    def __init__(self, inputs):
        super().__init__()
        self.inputs = list(inputs)
        self.ops = []
        # id -> tensor: graph inputs and recorded ops' outputs
        self._traced = {id(t): t for t in self.inputs}
        # id -> (tensor, torch function): made outside a recorded op
        self._made_by = {}
        self._depth = 0
        self._thread = threading.get_ident()

    def __enter__(self):
        global _trace
        if _trace is not None:
            raise RuntimeError("an export trace is already running")
        super().__enter__()
        _trace = self
        return self

    def __exit__(self, *exc):
        global _trace
        _trace = None
        return super().__exit__(*exc)

    def check(self, t: torch.Tensor, what: str) -> None:
        made = self._made_by.get(id(t))
        if made is not None:
            raise NotImplementedError(
                f"to_onnx: {what} takes a tensor that the torch function "
                f"{made[1]} made outside a recorded op (from a traced "
                f"tensor, or uninitialized); exporting it as a constant "
                f"would be wrong, so compute it through an autograd op")

    def op(self, kind, attrs, extras, fn, inputs):
        if self._depth or threading.get_ident() != self._thread or (
                torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return fn(*inputs)
        for t in inputs:
            self.check(t, f"the {kind} op")
        self._depth += 1
        try:
            out = fn(*inputs)
        finally:
            self._depth -= 1
        outs = out if isinstance(out, tuple) else (out,)
        for t in outs:
            self._traced[id(t)] = t
            self._made_by.pop(id(t), None)
        self.ops.append((kind, dict(attrs), list(extras), list(inputs),
                         list(outs)))
        return out

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._depth:
            return out
        name = getattr(func, "__name__", "")
        mutates = (name.endswith("_") and not name.endswith("__")) or (
            name.startswith("__i") or name == "__setitem__")
        srcs = [t for t in _tensors((args, kwargs))
                if id(t) in self._traced or id(t) in self._made_by]
        if srcs:
            made = next((self._made_by[id(t)][1] for t in srcs
                         if id(t) in self._made_by), _fn_name(func))
        elif func in _UNINITIALIZED:
            made = _fn_name(func)
        else:
            return out
        marked = list(_tensors(out))
        if mutates and args and isinstance(args[0], torch.Tensor):
            marked.append(args[0])
        for t in marked:
            if mutates or not any(t is s for s in srcs):
                self._made_by[id(t)] = (t, made)
        return out


class TapeNode:
    """One op of a `TapeRecorder`'s tape: the op's kind, its inputs in
    order, and `aux` (the loss's one-hot target)."""

    __slots__ = ("kind", "inputs", "aux")

    def __init__(self, kind, inputs, aux=None):
        self.kind, self.inputs, self.aux = kind, list(inputs), aux


#: the attribute a recorded op's output carries its `TapeNode` under
_CREATOR = "singa_tape_node"


def tape_node(t: torch.Tensor) -> Optional[TapeNode]:
    """The `TapeNode` that made `t` under a `TapeRecorder`, or None (a
    leaf: a parameter, an input, or anything made outside a recorded
    op)."""
    return getattr(t, _CREATOR, None)


class TapeRecorder:
    """The reference's `Operator` tape for the native lowering
    (`native.hlo_bridge`; reference singa_tpu/autograd.py's `creator`).
    `with TapeRecorder(): loss = softmax_cross_entropy(m.forward(x), t)`
    runs the forward as it always runs and tags each SINGA-level op's
    output (an `op(kind, ...)` call, and the loss with its one-hot
    target) with a `TapeNode`, which `tape_node` reads back. An op whose
    output is one of its inputs (an inactive Dropout's Identity) is a
    pass-through and tags nothing. Ops nested in a recorded op are part
    of it; only the entering thread records, never inside a CUDA Graph
    capture. It takes the export trace's slot: the two do not nest."""

    def __init__(self):
        self._depth = 0
        self._thread = threading.get_ident()

    def __enter__(self):
        global _trace
        if _trace is not None:
            raise RuntimeError("an export trace or tape recorder is "
                               "already running")
        _trace = self
        return self

    def __exit__(self, *exc):
        global _trace
        _trace = None

    def _records(self) -> bool:
        return not self._depth and threading.get_ident() == self._thread \
            and not (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())

    def _run(self, fn):
        self._depth += 1
        try:
            return fn()
        finally:
            self._depth -= 1

    def op(self, kind, attrs, extras, fn, inputs):
        records = self._records()
        out = self._run(lambda: device_module.dispatch(fn, inputs, *inputs))
        if torch.is_grad_enabled():
            _tag_params(out, inputs)
        for t in (out if isinstance(out, tuple) else (out,)):
            if records and isinstance(t, torch.Tensor) and not any(
                    t is x for x in inputs):
                setattr(t, _CREATOR, TapeNode(kind, inputs))
        return out

    def loss(self, logits, onehot, fn):
        """`fn()`, the loss of `logits`, tagged "SoftMaxCrossEntropy"
        with its (batch, classes) one-hot target as `aux`."""
        if not self._records():
            return fn()
        out = self._run(fn)
        setattr(out, _CREATOR, TapeNode("SoftMaxCrossEntropy", (logits,),
                                        aux=onehot))
        return out


# -- backward ----------------------------------------------------------------


def _leaves(y: torch.Tensor) -> List[torch.Tensor]:
    """The leaf tensors that need grad and that `y` was computed from, in
    the order the reference's backward walk finalizes them: walking the
    tape back from `y` (reverse topological order), a parameter comes at
    the last op that reads it, and the parameters of one op in its input
    order (an op's output node lists them, `_tag_params`); a leaf no op
    lists comes at its own node."""
    order, seen, stack = [], set(), [(y.grad_fn, False)]
    while stack:  # post-order depth first, inputs in order
        fn, done = stack.pop()
        if done:
            order.append(fn)
        elif fn is not None and fn not in seen:
            seen.add(fn)
            stack.append((fn, True))
            stack.extend((nxt, False) for nxt, _ in reversed(
                fn.next_functions))
    leaves, pos = [], {}
    for i, fn in enumerate(reversed(order)):
        for j, p in enumerate(fn.metadata.get(_PARAMS_KEY, ())):
            pos[id(p)] = (i, j)
        var = getattr(fn, "variable", None)  # AccumulateGrad: a leaf
        if var is not None:
            leaves.append(var)
            pos.setdefault(id(var), (i, 0))
    return sorted(leaves, key=lambda v: pos[id(v)])


#: callables given the root of every backward (`grad_pairs`) before the
#: backward frees its tape (graph.py's memory plan; reference :553-555)
_tape_observers: List[Callable] = []


def grad_pairs(y: torch.Tensor, dy: Optional[torch.Tensor] = None
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (param, grad) for every leaf tensor needing grad that `y`
    reaches, from one `torch.autograd.grad` over the tape; `dy` defaults
    to ones. Unlike the reference's walk, which yields each gradient as it
    finalizes, all of them are computed before the first is yielded."""
    if y.grad_fn is None:
        return
    for cb in _tape_observers:
        cb(y)
    params = _leaves(y)
    if not params:
        return
    grads = torch.autograd.grad(y, params, grad_outputs=dy,
                                allow_unused=True)
    for p, g in zip(params, grads):
        if g is not None:
            yield p, g


def backward(y: torch.Tensor, dy: Optional[torch.Tensor] = None):
    """[(param, grad), ...] for every parameter `y` reaches."""
    return list(grad_pairs(y, dy))


# -- Operator and Function ---------------------------------------------------


def _vjp(fn: Callable, xs: Sequence[torch.Tensor]):
    """fn(*xs) as a tuple, whether it was one, and the VJP of its
    floating outputs in the floating inputs (`torch.func.vjp`; integer
    outputs, such as indices, and integer inputs take no gradient)."""
    fpos = [i for i, x in enumerate(xs) if x.is_floating_point()]
    info = {}

    def on_floats(*fx):
        args = list(xs)
        for i, v in zip(fpos, fx):
            args[i] = v
        ys = fn(*args)
        info["multi"] = isinstance(ys, (tuple, list))
        ys = tuple(ys) if info["multi"] else (ys,)
        info["floating"] = [y.is_floating_point() for y in ys]
        return (tuple(y for y in ys if y.is_floating_point()),
                tuple(y for y in ys if not y.is_floating_point()))

    fys, vjp, iys = torch.func.vjp(
        on_floats, *[xs[i] for i in fpos], has_aux=True)
    # new tensor objects on the same memory: the VJP closure holds the
    # ones it returned, and an output must not lead back to its own node
    fys, iys = iter(fys), iter(iys)
    ys = tuple(next(fys).detach() if f else next(iys)
               for f in info["floating"])
    return ys, info["multi"], vjp, fpos


class _OperatorNode(torch.autograd.Function):
    """One `Operator` call on the tape: its forward, then its backward
    (the operator's own, or the VJP of its forward)."""

    @staticmethod
    def forward(ctx, operator, *xs):
        if type(operator).backward is Operator.backward:
            ys, multi, vjp, fpos = _vjp(operator.forward, xs)
            operator._vjp = (vjp, fpos, len(xs),
                             [y.is_floating_point() for y in ys])
        else:
            ys = operator.forward(*xs)
            multi = isinstance(ys, (tuple, list))
            ys = tuple(ys) if multi else (ys,)
        operator._multi_out = multi
        ctx.operator = operator
        ctx.mark_non_differentiable(
            *[y for y in ys if not y.is_floating_point()])
        return ys if multi else ys[0]

    @staticmethod
    def backward(ctx, *dys):
        dxs = ctx.operator.backward(*dys)
        if not isinstance(dxs, (tuple, list)):
            dxs = (dxs,)
        return (None, *dxs)


class Operator:
    """One differentiable op (reference :454-525), a node of the tape
    once called while `training` is set and an input requires grad.

    Subclasses define `forward(*tensors)`, pure (no state, no in-place
    writes to its inputs), returning a tensor or a tuple of them, and may
    define `backward(*dys)`: one gradient per output in, one per input
    out (None for none); by default it is the VJP of `forward`. The call
    keeps `inputs` and `outputs` (the outputs by weak reference: an
    output holds its node, which holds the op) and returns the output, or
    a tuple of them for a multi-output op. An op called again is a new
    node."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self._outputs: Tuple[weakref.ref, ...] = ()
        self._vjp = None
        self._multi_out = False

    @property
    def outputs(self) -> Tuple[Optional[torch.Tensor], ...]:
        return tuple(r() for r in self._outputs)

    def forward(self, *xs):
        raise NotImplementedError

    def backward(self, *dys):
        """The VJP of `forward`; override for a custom adjoint."""
        if self._vjp is None:
            raise RuntimeError(f"{self.name}: backward called before forward")
        vjp, fpos, n, floating = self._vjp
        grads = vjp(tuple(d for d, f in zip(dys, floating) if f))
        out: List[Optional[torch.Tensor]] = [None] * n
        for i, g in zip(fpos, grads):
            out[i] = g
        return tuple(out)

    def __call__(self, *xs: torch.Tensor):
        meta = getattr(self, "meta", None)
        kind, attrs, extras = meta if meta is not None else (None, {}, ())
        return op(kind, attrs, self._apply, *xs, extras=extras)

    def _apply(self, *xs):
        record = training and torch.is_grad_enabled() and builtins.any(
            x.requires_grad for x in xs)
        if not record:
            with torch.no_grad():
                ys = self.forward(*xs)
            return tuple(ys) if isinstance(ys, list) else ys
        out = _OperatorNode.apply(self, *xs)
        self.inputs = tuple(xs)
        self._outputs = tuple(weakref.ref(t) for t in (
            out if self._multi_out else (out,)))
        return out


class Function(Operator):
    """An `Operator` around a pure function of tensors (reference
    :528-546). `meta = (kind, attrs, extras)` is the op's ONNX form, which
    `sonnx.to_onnx` records; an op without it has none, and its export
    raises."""

    def __init__(self, fn: Callable, name: Optional[str] = None, meta=None):
        super().__init__(name=name or getattr(fn, "__name__", "fn"))
        self._fn = fn
        self.meta = meta

    def forward(self, *xs):
        return self._fn(*xs)


# -- the op cache ------------------------------------------------------------
#
# The reference compiles each eager op once per signature and keeps the
# executables (reference :203-234). PyTorch launches each op's kernels
# directly, so the port has no executable to keep: these two keep the
# reference's observable contract (disabling flushes; the numbers are the
# same either way), and `flash_attention.set_flash_enabled` flushes, as
# the reference's does.

def clear_op_cache() -> None:
    """Drop every cached per-op executable (none are kept here)."""


def set_op_cache_enabled(enabled: bool) -> None:
    """Turn the eager op cache on or off; turning it off flushes it."""
    if not enabled:
        clear_op_cache()


# -- rematerialization policies ----------------------------------------------
#
# - "none":          save every residual (fastest step, most memory).
# - "per_block":     save only the wrapped function's inputs; the whole
#                    body runs again in backward (torch.utils.checkpoint).
# - "dots_saveable": save the outputs of matrix products, recompute the
#                    elementwise chains between them (a selective
#                    checkpoint). A hand-written kernel is no matrix
#                    product to PyTorch's dispatcher, so it runs again,
#                    as a Pallas call does under the reference's policy.

REMAT_POLICIES = ("none", "per_block", "dots_saveable")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saveable_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_dots)


def remat_wrap(fn: Callable, policy: str = "none") -> Callable:
    """Wrap `fn` with the named rematerialization policy (see
    REMAT_POLICIES). Without grad recording the policy has nothing to
    save, and `fn` runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; pick one of {REMAT_POLICIES}")
    if policy == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _dots_saveable_context} if (
        policy == "dots_saveable") else {}

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


# -- losses ------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, target) -> torch.Tensor:
    """Mean softmax cross-entropy over the rows of `logits` (..., C);
    `target` is int labels (...) or one-hot (..., C). The loss math is
    fp32 whatever the logits' dtype. A label outside [0, C) adds 0 to
    the sum and still counts in the mean, as the reference's all-zero
    `one_hot` row makes it do."""
    if isinstance(_trace, TapeRecorder):
        return _trace.loss(logits, _one_hot_of(target, logits.shape[-1]),
                           lambda: _softmax_cross_entropy(logits, target))
    return _softmax_cross_entropy(logits, target)


def _one_hot_of(target, n: int) -> np.ndarray:
    """`target` as a float32 one-hot array (an int label outside [0, n)
    a row of zeros, as the reference's `one_hot`)."""
    t = target.detach().cpu().numpy() if isinstance(
        target, torch.Tensor) else np.asarray(target)
    if np.issubdtype(t.dtype, np.floating):
        return t.astype(np.float32)
    return (t[..., None] == np.arange(n)).astype(np.float32)


def _softmax_cross_entropy(logits: torch.Tensor, target) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    target = torch.as_tensor(target, device=logits.device)
    if target.is_floating_point():
        return -(target.float() * logp).sum(dim=-1).mean()
    # the one-hot sum picks one term: a gather computes it exactly; the
    # index is clamped (the card checks gather indices) and the term of
    # an out-of-range label masked to 0
    n = logp.shape[-1]
    t = target.long().unsqueeze(-1)
    picked = logp.gather(-1, t.clamp(0, n - 1))
    return -torch.where((t >= 0) & (t < n), picked, 0.0).mean()


cross_entropy = softmax_cross_entropy


# -- CNN ops -------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return op("Add", {}, torch.add, a, b)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b), w (in, out); operands under the autocast policy, the
    bias joined at the product's output dtype (under keep-bf16 autocast
    an fp32 bias would promote the activation stream back to fp32)."""
    def mm(a, ww):
        a, ww = _mxu_cast(a, ww)
        return _mxu_result(torch.matmul(a, ww))

    if b is None:
        return op("MatMul", {}, mm, x, w)

    def mm_bias(a, ww, bb):
        y = mm(a, ww)
        return y + bb.to(y.dtype)

    return op("Linear", {}, mm_bias, x, w, b)


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    return op("Reshape", {"shape": list(shape)},
              lambda a: a.reshape(shape), x)


def transpose(x: torch.Tensor, axes=None) -> torch.Tensor:
    """Permute the axes (reversed when `axes` is None, as numpy's)."""
    axes = tuple(axes) if axes is not None else None
    return op("Transpose", {"perm": list(axes) if axes else None},
              lambda a: a.permute(axes or tuple(reversed(range(a.dim())))),
              x)


def cat(xs, axis: int = 0) -> torch.Tensor:
    return op("Concat", {"axis": axis},
              lambda *ts: torch.cat(ts, dim=axis), *xs)


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU; `approximate=True` is the tanh form (`jax.nn.gelu`'s
    default), False the exact erf form."""
    form = "tanh" if approximate else "none"
    return op("Gelu", {"approximate": form},
              lambda a: F.gelu(a, approximate=form), x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return op("Tanh", {}, torch.tanh, x)


def flatten(x: torch.Tensor, start_axis: int = 1) -> torch.Tensor:
    """Flatten the dims from `start_axis` on (the batch axis stays)."""
    return op("Flatten", {"axis": start_axis},
              lambda a: a.reshape(*a.shape[:start_axis], -1), x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return op("Relu", {}, F.relu, x)


def leakyrelu(x: torch.Tensor, a: float = 0.01) -> torch.Tensor:
    """x where x >= 0, else a * x (`jax.nn.leaky_relu`: slope 1 at 0)."""
    return op("LeakyRelu", {"alpha": a},
              lambda v: torch.where(v >= 0, v, v * a), x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return op("Sigmoid", {}, torch.sigmoid, x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Softmax over logical `axis` (NCHW axes in both image layouts)."""
    def fn(v):
        y = torch.softmax(v, dim=axis)
        return layout_module.from_nchw(y) if v.dim() == 4 else y

    return op("Softmax", {"axis": axis}, fn, x)


def embedding(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[idx]; the (table, idx) order of ONNX's Gather."""
    return op("Gather", {"axis": 0}, lambda t, i: t[i], table, idx)


def _layer_norm(x, scale, offset, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics over the last axis, population variance, cast
    back to x's dtype."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - m) * torch.rsqrt(v + eps) * scale + offset).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    return op("LayerNormalization", {"axis": -1, "epsilon": eps},
              lambda a, g, b: _layer_norm(a, g, b, eps), x, gamma, beta)


def dropout(x: torch.Tensor, p: float = 0.5,
            train: bool = True) -> torch.Tensor:
    """Inverted dropout with PyTorch's draws; the identity when not
    training or p is 0. Inside `rank_draws(r)` with r > 0 the mask comes
    from rank r's own generator (see there)."""
    if not train or p <= 0.0:
        return op("Identity", {}, lambda a: a, x)
    gen = _rank_generator(x.device)
    if gen is None:
        return op("Dropout", {"ratio": p},
                  lambda a: F.dropout(a, p, training=True), x)
    scale = 1.0 / (1.0 - p) if p < 1.0 else 0.0
    return op("Dropout", {"ratio": p}, lambda a: a * torch.empty_like(
        a).bernoulli_(1.0 - p, generator=gen).mul_(scale), x)


# -- each rank's dropout draws ------------------------------------------------
#
# The reference folds the data-axis index into a distributed step's key
# (singa_tpu/graph.py:669-674), so every shard draws its own masks. Here a
# rank is a process whose default generator the trainers seed alike on
# every rank; `Model._dist_train` runs its step under `rank_draws(rank)`.

_draws = threading.local()
#: (device, rank) -> [generator, the seed it was made from]
_RANK_GENERATORS: dict = {}
#: the seed stride between ranks (2**64 / the golden ratio)
_RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


#: (device type, rank) -> saved generator state, put in at that
#: generator's first draw (`set_rank_generator_states`)
_RANK_RESTORED: dict = {}


class rank_draws:
    """`with autograd.rank_draws(r):` dropout inside draws rank r's
    stream. Rank 0 draws from PyTorch's default generator, exactly as
    outside any distributed step (so a world-1 step is bitwise the plain
    one); rank r > 0 from a generator of its own on each device, seeded
    at its first use from `torch.initial_seed()` and r, and seeded anew
    when `torch.initial_seed()` has changed or after
    `reset_rank_draws()`. A captured step (`graph.GraphStep`) registers
    these generators with its graph, so every replay draws fresh masks.
    A checkpoint carries their states (`rank_generator_states`), as the
    reference's manifest carries the key it folds each rank's index
    into."""

    def __init__(self, rank: int):
        self.rank = int(rank)

    def __enter__(self):
        self._prev = getattr(_draws, "rank", 0)
        _draws.rank = self.rank

    def __exit__(self, *exc):
        _draws.rank = self._prev


def draw_rank() -> int:
    """The rank whose dropout stream is active (0 outside `rank_draws`)."""
    return getattr(_draws, "rank", 0)


def rank_generators(device: torch.device) -> List[torch.Generator]:
    """The rank generators made so far on `device`."""
    return [g for (dev, _), (g, _) in _RANK_GENERATORS.items()
            if dev == device]


def reset_rank_draws() -> None:
    """Forget every rank generator: the next draw of rank r > 0 starts
    its stream from `torch.initial_seed()` again."""
    _RANK_GENERATORS.clear()
    _RANK_RESTORED.clear()


def _rank_seed(rank: int) -> int:
    return (torch.initial_seed() + rank * _RANK_SEED_STRIDE) % 2 ** 63


def rank_generator_states() -> List[dict]:
    """The states of this process's rank generators, JSON-able:
    [{"rank": r, "device": "cuda:0", "state": [uint8, ...]}, ...] by
    rank, then device. Empty where no rank r > 0 has drawn (a world-1
    run). A restore matches an entry by its rank and device type, not
    the device's index: rank r's stream resumes on whichever card the
    restoring process gives rank r."""
    return [{"rank": int(rank), "device": str(dev),
             "state": gen.get_state().tolist()}
            for (dev, rank), (gen, _) in sorted(
                _RANK_GENERATORS.items(),
                key=lambda kv: (kv[0][1], str(kv[0][0])))]


def set_rank_generator_states(entries) -> None:
    """Put the rank generators where `rank_generator_states` found them
    (a checkpoint's `rng["ranks"]`), after the default generators were
    restored: a rank with an entry of its device type resumes its
    stream, whatever the index of the card it is on now, at once where
    its generator exists (in place: a captured step keeps drawing from
    it) or else at its first draw. Every other rank generator is seeded
    anew from `torch.initial_seed()` and its rank, as at a fresh start:
    a rank the saving world did not have, or any rank after a world-1
    checkpoint. A rank saved only on another device type (a card's
    stream restored on the host) starts afresh too, with a warning: the
    two generators' states do not convert."""
    _RANK_RESTORED.clear()
    for e in entries or ():
        _RANK_RESTORED.setdefault(
            (torch.device(e["device"]).type, int(e["rank"])), e["state"])
    for (dev, rank), entry in _RANK_GENERATORS.items():
        state = _restored_state(dev, rank)
        seed = _rank_seed(rank)
        if state is None:
            entry[0].manual_seed(seed)
        else:
            entry[0].set_state(torch.tensor(state, dtype=torch.uint8))
        entry[1] = seed


def _restored_state(device: torch.device, rank: int):
    """The saved state rank `rank` resumes on `device` (taken out of
    `_RANK_RESTORED`), or None; warns where rank `rank` was saved only
    on another device type."""
    state = _RANK_RESTORED.pop((device.type, rank), None)
    other = sorted(t for t, r in _RANK_RESTORED if r == rank)
    if state is None and other:
        warnings.warn(
            f"rank {rank}'s dropout stream was saved on {', '.join(other)} "
            f"and is drawn here on {device.type}: it starts afresh from "
            f"its seed, so the resume is not bitwise")
    return state


def _rank_generator(device: torch.device) -> Optional[torch.Generator]:
    rank = draw_rank()
    if rank == 0:
        return None
    seed = _rank_seed(rank)
    entry = _RANK_GENERATORS.get((device, rank))
    if entry is not None and entry[1] == seed:
        return entry[0]
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"rank {rank}'s dropout generator on {device} would be made or "
            f"seeded inside a CUDA Graph capture; run the step once "
            f"uncaptured first (graph.GraphStep does)")
    if entry is None:
        entry = _RANK_GENERATORS[(device, rank)] = [
            torch.Generator(device=device), seed]
    entry[0].manual_seed(seed)
    entry[1] = seed
    state = _restored_state(device, rank)
    if state is not None:
        entry[0].set_state(torch.tensor(state, dtype=torch.uint8))
    return entry[0]


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _same_pads(in_sizes, kernel, strides, dilations, lower: bool = False
              ) -> List[Tuple[int, int]]:
    """(begin, end) pads per spatial dim that keep ceil(n / s) outputs:
    the total (the dilated window's overhang) split in two, the odd cell
    at the end (XLA's "SAME", ONNX's SAME_UPPER) or, `lower`, at the
    beginning (SAME_LOWER)."""
    out = []
    for n, k, s, d in zip(in_sizes, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        total = builtins.max((-(-n // s) - 1) * s + eff - n, 0)
        small, big = total // 2, total - total // 2
        out.append((big, small) if lower else (small, big))
    return out


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """2-D convolution, weight OIHW in both image layouts; operands under
    the autocast policy, the bias joined at the output dtype. cuDNN keeps
    a channels-last input channels-last. `padding` is a number, a pair,
    or "same"/"valid" (either case): "same" pads as XLA does, the odd
    cell at the end at any stride, with one explicit `F.pad` where the
    two ends differ (`F.conv2d`'s own "same" refuses strides over 1).
    The reference lowers 1x1 convs over small outputs to matrix
    products, a tiling choice of the TPU; here every conv is one
    `F.conv2d` (only the summation order differs)."""
    stride, dilation = _pair(stride), _pair(dilation)
    auto_pad = "NOTSET"
    if isinstance(padding, str):
        auto_pad = padding.upper()
        if auto_pad not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        pads = [(0, 0)] * 2 if auto_pad == "VALID" else _same_pads(
            x.shape[2:], w.shape[2:], stride, dilation)
    else:
        pads = [(p, p) for p in _pair(padding)]
    even = all(lo == hi for lo, hi in pads)
    padding = tuple(lo for lo, _ in pads) if even else (0, 0)
    torch_pads = [p for pair in reversed(pads) for p in pair]

    def fn(a, ww, *bb):
        a, ww = _mxu_cast(a, ww)
        if not even:
            a = F.pad(a, torch_pads)
        out = _mxu_result(F.conv2d(a, ww, None, stride, padding, dilation,
                                   groups))
        if bb:
            out = out + bb[0].view(1, -1, 1, 1).to(out.dtype)
        return out

    ph, pw = (0, 0) if auto_pad != "NOTSET" else padding
    return op("Conv", {"strides": list(stride), "pads": [ph, pw, ph, pw],
                       "dilations": list(dilation), "group": groups,
                       "auto_pad": auto_pad},
              fn, *((x, w) if b is None else (x, w, b)))


#: per-channel statistic count (N*H*W) below which training-mode batch
#: norm normalizes with the running statistics (reference :1083)
DEGENERATE_STAT_COUNT = 16


def batchnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor,
              momentum: float = 0.9, eps: float = 1e-5, train: bool = True,
              sync: Optional[bool] = None):
    """Batch normalization over the channel axis; returns (y,
    new_running_mean, new_running_var). The reference's formula, not
    `F.batch_norm`:

    - statistics in fp32 in one pass, var = E[x^2] - E[x]^2 clamped at 0,
      and y cast back to x's dtype;
    - running update `r * momentum + batch * (1 - momentum)` with the
      biased batch variance (PyTorch's own uses the unbiased variance and
      the opposite momentum);
    - when N*H*W < DEGENERATE_STAT_COUNT, training normalizes with the
      running statistics and still updates them from the batch moments
      held without gradient, and warns.

    `sync`: cross-replica statistics. None (the default) is automatic:
    under a DistOpt step (`parallel.mesh.batch_axis_context`) the two
    moments are averaged over the data group, differentiably (the
    backward averages their cotangent over the group), so the
    distributed step is the single-device large-batch step. True
    requires that context; False keeps local statistics. The
    degenerate-statistics guard counts the global N*H*W."""
    from singa_tpu_torch.parallel import mesh as mesh_module

    group = mesh_module.current_batch_group() if sync is not False else None
    if sync and group is None:
        raise ValueError(
            "batchnorm(sync=True) outside a data-parallel batch-axis "
            "context (a DistOpt step over a process group)")
    world = mesh_module.current_batch_axis_size() if group is not None else 1
    c_axis = layout_module.channel_axis(x.dim())
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    meta = ("BatchNormalization", {"epsilon": eps})
    extras = (running_mean, running_var)

    def with_running(xf):
        return (xf - running_mean.view(bshape)) * torch.rsqrt(
            running_var.view(bshape) + eps)

    if not train:
        def fn_eval(a, g, b):
            y = with_running(a.float()) * g.view(bshape) + b.view(bshape)
            return y.to(a.dtype)

        y = op(*meta, fn_eval, x, gamma, beta, extras=extras)
        return y, running_mean, running_var
    n_stat = math.prod(x.shape[i] for i in red) * world
    degenerate = n_stat < DEGENERATE_STAT_COUNT
    if degenerate:
        warnings.warn(
            f"BatchNorm: only {n_stat} elements per channel "
            f"(< {DEGENERATE_STAT_COUNT}); batch statistics are "
            "degenerate, so normalizing with the running statistics "
            "instead (the running moments still update from the batch)",
            stacklevel=2)

    def fn_train(a, g, b):
        xf = a.float()
        with torch.set_grad_enabled(
                torch.is_grad_enabled() and not degenerate):
            m = xf.mean(red)
            m2 = xf.square().mean(red)
            if group is not None:
                from singa_tpu_torch.communicator import group_mean

                # one collective for both moments: equal shard sizes
                # make the mean of shard means the global mean
                m, m2 = group_mean(torch.stack((m, m2)), group,
                                   world).unbind(0)
            v = (m2 - m.square()).clamp_min(0.0)
        xhat = with_running(xf) if degenerate else (
            (xf - m.view(bshape)) * torch.rsqrt(v.view(bshape) + eps))
        y = xhat * g.view(bshape) + b.view(bshape)
        return y.to(a.dtype), m, v

    y, m, v = op(*meta, fn_train, x, gamma, beta, extras=extras)
    new_rm = running_mean * momentum + m.detach() * (1 - momentum)
    new_rv = running_var * momentum + v.detach() * (1 - momentum)
    return y, new_rm, new_rv


def _pool2d(x: torch.Tensor, kernel, stride, padding, kind: str):
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    p = _pair(padding)
    attrs = {"kernel_shape": list(k), "strides": list(s),
             "pads": [p[0], p[1], p[0], p[1]]}
    if kind == "avg":
        return op("AveragePool", attrs, lambda a: _avg_pool2d(a, k, s, p), x)

    def fn(a):
        if a.dim() == 4 and layout_module.image_layout() == "NHWC":
            # the channels-last activation seen as the (N, H, W, C)
            # tensor it is in memory; the op's backward is the K2a
            # kernel when on
            y = max_pool.maxpool2d_nhwc(a.permute(0, 2, 3, 1), k, s, p)
            return y.permute(0, 3, 1, 2)
        return max_pool.max_pool2d(a, k, s, p)

    return op("MaxPool", attrs, fn, x)


def _avg_pool2d(x: torch.Tensor, k, s, p) -> torch.Tensor:
    """Average pool with the padding excluded from each window's count
    (the reference's and cuDNN's default). Pads over half the window,
    which PyTorch's pool refuses, are applied explicitly: window sums
    over zero padding divided by the reference's count of cells that are
    not padding, so a window wholly in padding gives 0/0 = NaN, as the
    reference's `lax.reduce_window` quotient does."""
    if not any(2 * pi > ki for ki, pi in zip(k, p)):
        return F.avg_pool2d(x, k, s, p, count_include_pad=False)
    pads = (p[1], p[1], p[0], p[0])
    total = F.avg_pool2d(F.pad(x, pads), k, s, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[-2:]), dtype=x.dtype,
                      device=x.device)
    count = F.avg_pool2d(F.pad(ones, pads), k, s, divisor_override=1)
    return total / count


def max_pool2d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """Max-pool; padding is never selected, and any padding is taken (a
    window wholly in padding gives -inf). Under "NHWC" 4-D inputs go
    through `ops.max_pool.maxpool2d_nhwc` (reference :1264-1277), under
    "NCHW" through PyTorch's max-pool and its autograd."""
    return _pool2d(x, kernel, stride, padding, "max")


def avg_pool2d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    return _pool2d(x, kernel, stride, padding, "avg")


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C), the mean taken in fp32."""
    sp = layout_module.spatial_axes()
    return op("GlobalAvgPoolFlat", {},
              lambda a: a.float().mean(dim=sp).to(a.dtype), x)


# -- recurrent ops -------------------------------------------------------------
#
# Time is the leading axis (T, B, in); gate orders are torch's and cuDNN's:
# LSTM i, f, g, o; GRU r, z, n. `reverse=True` walks the steps from the
# last and keeps the outputs time-aligned; `remat=True` saves only each
# step's carry and recomputes the cell in the backward
# (`torch.utils.checkpoint`, where the reference wraps its scan body in
# `jax.checkpoint`). The reference's RNN_SCAN_UNROLL is an XLA knob with
# no counterpart here.


def _recur(step: Callable, carry: Tuple[torch.Tensor, ...],
           xproj: torch.Tensor, reverse: bool, remat: bool):
    """Run carry = step(*carry, xproj[t]) over t; returns the final carry
    and the stacked first carries (T, B, H)."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        cell = step

        def step(*a):
            return checkpoint(cell, *a, use_reentrant=False)

    # one unbind: its backward stacks the steps' gradients in one write,
    # where indexing xproj[t] per step would zero-fill and sum a full
    # (T, B, G*H) gradient for every step
    xs = xproj.unbind(0)
    ys = [None] * len(xs)
    for t in (reversed(range(len(xs))) if reverse else range(len(xs))):
        carry = step(*carry, xs[t])
        ys[t] = carry[0]
    return carry, torch.stack(ys)


def vanilla_rnn(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                b: torch.Tensor, h0: torch.Tensor,
                nonlinearity: str = "tanh", reverse: bool = False,
                remat: bool = False):
    """Elman RNN over x (T, B, in) -> (ys (T, B, H), h_T); w_ih (in, H),
    w_hh (H, H), b (H,)."""
    if nonlinearity not in ("tanh", "relu"):
        raise ValueError(f"unknown nonlinearity {nonlinearity!r}")
    act = torch.tanh if nonlinearity == "tanh" else F.relu

    def fn(xa, wih, whh, bb, h0a):
        def step(h, xt):
            return (act(xt + torch.matmul(h, whh)),)

        (h,), ys = _recur(step, (h0a,), torch.matmul(xa, wih) + bb,
                          reverse, remat)
        return ys, h

    return op("SingaRNN", {"hidden": int(w_hh.shape[0]),
                           "reverse": int(reverse),
                           "nonlinearity": nonlinearity},
              fn, x, w_ih, w_hh, b, h0)


def lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
         b: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
         reverse: bool = False, remat: bool = False):
    """LSTM over x (T, B, in) -> (ys (T, B, H), h_T, c_T); w_ih (in, 4H),
    w_hh (H, 4H), b (4H,), gates ordered i, f, g, o."""

    def fn(xa, wih, whh, bb, h0a, c0a):
        def step(h, c, xt):
            i, f, g, o = (xt + torch.matmul(h, whh)).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            return torch.sigmoid(o) * torch.tanh(c), c

        (h, c), ys = _recur(step, (h0a, c0a), torch.matmul(xa, wih) + bb,
                            reverse, remat)
        return ys, h, c

    return op("SingaLSTM", {"hidden": int(w_hh.shape[0]),
                            "reverse": int(reverse)},
              fn, x, w_ih, w_hh, b, h0, c0)


def gru(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
        b_ih: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
        reverse: bool = False, remat: bool = False):
    """GRU over x (T, B, in) -> (ys (T, B, H), h_T); w_ih (in, 3H),
    w_hh (H, 3H), gates ordered r, z, n. The biases are separate because
    r applies inside the hidden-side affine:
    n = tanh(x_n + b_in + r * (h W_n + b_hn))."""

    def fn(xa, wih, whh, bih, bhh, h0a):
        def step(h, xt):
            xr, xz, xn = xt.chunk(3, dim=-1)
            hr, hz, hn = (torch.matmul(h, whh) + bhh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            return ((1.0 - z) * n + z * h,)

        (h,), ys = _recur(step, (h0a,), torch.matmul(xa, wih) + bih,
                          reverse, remat)
        return ys, h

    return op("SingaGRU", {"hidden": int(w_hh.shape[0]),
                           "reverse": int(reverse)},
              fn, x, w_ih, w_hh, b_ih, b_hh, h0)


# -- the rest of the functional ops --------------------------------------------
#
# Plain functions on tensors with the reference's signatures (reference
# :640-948, :1536), each one op: the ONNX kind of the reference's `meta`
# where the exporter can write it as it is, None (no ONNX form: export
# raises) otherwise.


def _dims(x: torch.Tensor, axis):
    """A reduction's dims: every dim when `axis` is None."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _as_tensor(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """`v` (a tensor, array or number) on `like`'s device."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=like.device, dtype=dtype)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return op("Sub", {}, torch.sub, a, b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return op("Mul", {}, torch.mul, a, b)


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return op("Div", {}, torch.div, a, b)


def pow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:  # noqa: A001
    return op("Pow", {}, torch.pow, a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product; operands under the autocast policy."""
    def fn(x, y):
        x, y = _mxu_cast(x, y)
        return _mxu_result(torch.matmul(x, y))

    return op("MatMul", {}, fn, a, b)


def squeeze(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Drop the size-1 `axis` (an int or a tuple), or every size-1 dim;
    naming a dim that is not size 1 raises, as numpy's."""
    def fn(a):
        dims = tuple(d for d in range(a.dim()) if a.shape[d] == 1) \
            if axis is None else _dims(a, axis)
        if builtins.any(a.shape[d] != 1 for d in dims):
            raise ValueError(f"squeeze: axis {axis} of shape "
                             f"{tuple(a.shape)} is not 1")
        return a.squeeze(dims) if dims else a

    return op(None, {}, fn, x)


def unsqueeze(x: torch.Tensor, axis) -> torch.Tensor:
    """New size-1 dims at `axis` (an int or a tuple, positions in the
    output), inserted in increasing order."""
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)

    def fn(a):
        for ax in sorted(axes):
            a = a.unsqueeze(ax)
        return a

    return op(None, {}, fn, x)


def split(x: torch.Tensor, parts, axis: int = 0):
    """numpy's split: `parts` an int (that many equal pieces; it must
    divide the axis) or the indices to cut at; a tuple of pieces."""
    def fn(a):
        if isinstance(parts, int) and a.shape[axis] % parts:
            raise ValueError(f"split: {parts} pieces do not divide "
                             f"{a.shape[axis]} entries")
        sections = parts if isinstance(parts, int) else list(parts)
        return tuple(torch.tensor_split(a, sections, dim=axis))

    return op(None, {}, fn, x)


def gather(x: torch.Tensor, indices, axis: int = 0) -> torch.Tensor:
    """numpy's take along `axis`: the result's shape is x's with that
    axis replaced by the indices' shape; a negative index counts from
    the end."""
    def fn(a):
        idx = _as_tensor(indices, a, torch.long)
        idx = torch.where(idx < 0, idx + a.shape[axis], idx)
        ax = axis % a.dim()
        out = a.index_select(ax, idx.reshape(-1))
        return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])

    return op(None, {}, fn, x)


def pad(x: torch.Tensor, pad_width, value: float = 0.0) -> torch.Tensor:
    """numpy's constant pad: `pad_width` an int, a (before, after) pair
    or one pair per dim."""
    def fn(a):
        widths = np.broadcast_to(np.asarray(pad_width, np.int64),
                                 (a.dim(), 2))
        flat = [int(w) for pair in widths[::-1] for w in pair]
        return F.pad(a, flat, value=value)

    return op(None, {}, fn, x)


def _reduce(reducer, x, axis, keepdims):
    dims = _dims(x, axis)
    return reducer(x, dims, keepdims) if dims else x


def sum(x: torch.Tensor, axis=None,  # noqa: A001
        keepdims: bool = False) -> torch.Tensor:
    return op(None, {}, lambda a: _reduce(
        lambda t, d, k: t.sum(dim=d, keepdim=k), a, axis, keepdims), x)


def mean(x: torch.Tensor, axis=None, keepdims: bool = False
         ) -> torch.Tensor:
    return op(None, {}, lambda a: _reduce(
        lambda t, d, k: t.mean(dim=d, keepdim=k), a, axis, keepdims), x)


def max(x: torch.Tensor, axis=None,  # noqa: A001
        keepdims: bool = False) -> torch.Tensor:
    """The maximum over `axis`; tied maxima share the gradient evenly."""
    return op(None, {}, lambda a: _reduce(
        lambda t, d, k: t.amax(dim=d, keepdim=k), a, axis, keepdims), x)


def min(x: torch.Tensor, axis=None,  # noqa: A001
        keepdims: bool = False) -> torch.Tensor:
    """The minimum over `axis`; tied minima share the gradient evenly."""
    return op(None, {}, lambda a: _reduce(
        lambda t, d, k: t.amin(dim=d, keepdim=k), a, axis, keepdims), x)


def prod(x: torch.Tensor, axis=None, keepdims: bool = False
         ) -> torch.Tensor:
    def fn(t, dims, k):
        for d in sorted(dims, reverse=True):
            t = t.prod(dim=d, keepdim=k)
        return t

    return op(None, {}, lambda a: _reduce(fn, a, axis, keepdims), x)


def var(x: torch.Tensor, axis=None, keepdims: bool = False,
        ddof: int = 0) -> torch.Tensor:
    return op(None, {}, lambda a: _reduce(
        lambda t, d, k: t.var(dim=d, keepdim=k, correction=ddof), a, axis,
        keepdims), x)


def std(x: torch.Tensor, axis=None, keepdims: bool = False,
        ddof: int = 0) -> torch.Tensor:
    return op(None, {}, lambda a: _reduce(
        lambda t, d, k: t.std(dim=d, keepdim=k, correction=ddof), a, axis,
        keepdims), x)


def cumsum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return op(None, {}, lambda a: a.cumsum(dim=axis), x)


def cumprod(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return op(None, {}, lambda a: a.cumprod(dim=axis), x)


def norm(x: torch.Tensor, ord: float = 2, axis=None,  # noqa: A002
         keepdims: bool = False) -> torch.Tensor:
    """Vector p-norm over `axis` (None: the flattened tensor); ord 1, 2,
    inf or any p > 0 (`_kernels.norm_`, as `tensor.norm`)."""
    return op(None, {}, lambda a: _kernels.norm_(a, ord, axis, keepdims), x)


def sort(x: torch.Tensor, axis: int = -1, descending: bool = False
         ) -> torch.Tensor:
    """Sorted values along `axis`; gradients go back through the
    permutation."""
    return op(None, {}, lambda a: _kernels.sort_(a, axis, descending), x)


def argsort(x: torch.Tensor, axis: int = -1, descending: bool = False
            ) -> torch.Tensor:
    """The sorting indices along `axis` (no gradient)."""
    return _kernels.argsort_(x, axis, descending)


def topk(x: torch.Tensor, k: int, axis: int = -1):
    """(values, indices) of the k largest along `axis`, largest first;
    the values take gradients, the indices none."""
    return op(None, {}, lambda a: _kernels.topk_(a, k, axis), x)


def one_hot(x, num_classes: int, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """Integer labels to one-hot rows (no gradient); a label outside
    [0, num_classes) gives a row of zeros."""
    return _kernels.one_hot_(torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x), num_classes, dtype)


def where(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where `cond` (a tensor or array, nonzero is true), else b."""
    return op(None, {}, lambda x_, y_: torch.where(
        _as_tensor(cond, x_, torch.bool), x_, y_), a, b)


def stack(xs, axis: int = 0) -> torch.Tensor:
    return op(None, {}, lambda *ts: torch.stack(ts, dim=axis), *xs)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """max(x, lo) then min(., hi), as numpy's clip: an entry equal to a
    bound takes half the gradient."""
    def fn(a):
        if lo is not None:
            a = torch.maximum(a, _as_tensor(lo, a, a.dtype))
        if hi is not None:
            a = torch.minimum(a, _as_tensor(hi, a, a.dtype))
        return a

    return op(None, {}, fn, x)


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001
    return op("Abs", {}, torch.abs, x)


def exp(x: torch.Tensor) -> torch.Tensor:
    return op("Exp", {}, torch.exp, x)


def log(x: torch.Tensor) -> torch.Tensor:
    return op("Log", {}, torch.log, x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return op("Sqrt", {}, torch.sqrt, x)


def square(x: torch.Tensor) -> torch.Tensor:
    return op(None, {}, torch.square, x)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max; a tie gives each side half the gradient."""
    return op("Max", {}, torch.maximum, a, b)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min; a tie gives each side half the gradient."""
    return op("Min", {}, torch.minimum, a, b)


def einsum(spec: str, *xs: torch.Tensor) -> torch.Tensor:
    """einsum, operands under the autocast policy like `matmul`."""
    def fn(*ts):
        return _mxu_result(torch.einsum(spec, *_mxu_cast(*ts)))

    return op("Einsum", {"equation": spec}, fn, *xs)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return op("Elu", {"alpha": alpha}, lambda v: F.elu(v, alpha), x)


def erf(x: torch.Tensor) -> torch.Tensor:
    return op("Erf", {}, torch.erf, x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as `jax.nn.softplus` (logaddexp(x, 0))."""
    return op("Softplus", {}, lambda v: torch.logaddexp(
        v, torch.zeros((), dtype=v.dtype, device=v.device)), x)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """log(softmax) over logical `axis`, as `softmax`."""
    def fn(v):
        y = torch.log_softmax(v, dim=axis)
        return layout_module.from_nchw(y) if v.dim() == 4 else y

    return op("LogSoftmax", {"axis": axis}, fn, x)


def mse_loss(x: torch.Tensor, target) -> torch.Tensor:
    """mean((x - target)^2) over every entry."""
    return op(None, {}, lambda a: (a - _as_tensor(target, a, a.dtype))
              .square().mean(), x)
