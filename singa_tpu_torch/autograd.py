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
  `is None` test).
"""

from __future__ import annotations

import functools
import math
import threading
import warnings
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

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
           "rank_generators", "reset_rank_draws", "transpose", "cat", "op",
           "ExportTrace"]

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
        out = fn(*inputs)
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


def grad_pairs(y: torch.Tensor, dy: Optional[torch.Tensor] = None
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (param, grad) for every leaf tensor needing grad that `y`
    reaches, from one `torch.autograd.grad` over the tape; `dy` defaults
    to ones. Unlike the reference's walk, which yields each gradient as it
    finalizes, all of them are computed before the first is yielded."""
    if y.grad_fn is None:
        return
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


class rank_draws:
    """`with autograd.rank_draws(r):` dropout inside draws rank r's
    stream. Rank 0 draws from PyTorch's default generator, exactly as
    outside any distributed step (so a world-1 step is bitwise the plain
    one); rank r > 0 from a generator of its own on each device, seeded
    at its first use from `torch.initial_seed()` and r, and seeded anew
    when `torch.initial_seed()` has changed or after
    `reset_rank_draws()`. A captured step (`graph.GraphStep`) registers
    these generators with its graph, so every replay draws fresh masks."""

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


def _rank_generator(device: torch.device) -> Optional[torch.Generator]:
    rank = draw_rank()
    if rank == 0:
        return None
    seed = (torch.initial_seed() + rank * _RANK_SEED_STRIDE) % 2 ** 63
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
        total = max((-(-n // s) - 1) * s + eff - n, 0)
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
                from singa_tpu_torch.communicator import pmean_over

                # one collective for both moments: equal shard sizes
                # make the mean of shard means the global mean
                m, m2 = pmean_over(torch.stack((m, m2)), group,
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
