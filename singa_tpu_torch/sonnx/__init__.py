"""sonnx: ONNX import and export (counterpart of singa_tpu/sonnx/).

`prepare(onnx_model, device)` parses an ONNX graph (bytes, a path or a
decoded `PB`) and returns a `SingaRep` whose `.run(inputs)` gives numpy
outputs; `load(...)` returns the `SONNXModel` itself, a `Model` that runs
eagerly, trains through `compile` / `train_one_batch`, and captures its
training step as one CUDA Graph under `graph(True)`. `to_onnx(model,
inputs)` (`export.py`) exports a port model. The protobuf codec is the
port's own copy of the reference's, `proto.py` (no `onnx` package).

Every ONNX node runs through a handler of `HANDLERS`: a plain function
of torch tensors with the reference handler's semantics, so PyTorch's
tape gives the gradients. Convs and pools follow ONNX's pad rules
(explicit begin/end pads, SAME_UPPER / SAME_LOWER for convs), padding
never wins a max and is left out of an average unless
`count_include_pad`; BatchNormalization takes its inference form;
LSTM / GRU / RNN keep ONNX's gate orders (iofc, zrh), both
`linear_before_reset` forms and every `direction`, and refuse what the
reference refuses (batch-major layout, cell clip, per-example
`sequence_lens`, peepholes, activations other than the defaults).

Initializers are classified as the reference does: BatchNormalization's
inputs 3 and 4 are buffers, other float tensors of more than one element
(and PRelu slopes) trainable parameters, the rest constants; fine-tuning
moves only the parameters. They keep their ONNX names (`fc1.W`) in
`get_params` / `get_buffers` / `get_states` / `set_params` /
`set_states`, and are held under escaped keys, since `nn.Module` refuses
names with a ".".

Shape-consuming inputs (Reshape targets, Slice bounds, ...) are read on
the host on the model's first run, which must be uncaptured (a
device-to-host read), and replayed afterwards; tensors a handler builds
from host values (Shape, Size, Constant, Range) are made once per value
and reused, so the steps after the first are capturable.

Dtypes: int64 stays int64 (torch indexes with it), where the reference,
JAX without x64, computes in int32; so Shape, Size, ArgMax, ArgMin and
Cast to an int64 type give int64 here and int32 there, with the same
values. float64 initializers and inputs become float32, as in the
reference; a Cast to DOUBLE gives float64 here, float32 there. One value
differs on purpose: OneHot counts a negative index from the end, as
ONNX says, where the reference's `jax.nn.one_hot` gives an all-off row.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from singa_tpu_torch import autograd
from singa_tpu_torch import device as device_module
from singa_tpu_torch import model as model_module
from singa_tpu_torch.sonnx import proto  # noqa: F401  (sonnx.proto)
from singa_tpu_torch.sonnx.proto import (PB, AttrType, TensorDataType,
                                         decode_model, encode_model)

__all__ = ["prepare", "load", "save", "to_onnx", "SingaRep", "SONNXModel",
           "to_array", "from_array", "HANDLERS"]


# -- TensorProto <-> numpy ----------------------------------------------------

_DTYPES = {
    TensorDataType.FLOAT: np.float32,
    TensorDataType.UINT8: np.uint8,
    TensorDataType.INT8: np.int8,
    TensorDataType.UINT16: np.uint16,
    TensorDataType.INT16: np.int16,
    TensorDataType.INT32: np.int32,
    TensorDataType.INT64: np.int64,
    TensorDataType.BOOL: np.bool_,
    TensorDataType.FLOAT16: np.float16,
    TensorDataType.DOUBLE: np.float64,
    TensorDataType.UINT32: np.uint32,
    TensorDataType.UINT64: np.uint64,
}
_NP_TO_ONNX = {np.dtype(v): k for k, v in _DTYPES.items()}


def to_array(t: PB) -> np.ndarray:
    """TensorProto -> numpy array."""
    dt = t.data_type or TensorDataType.FLOAT
    if dt == TensorDataType.BFLOAT16:
        raw = np.frombuffer(t.raw_data, dtype=np.uint16).astype(np.uint32)
        arr = (raw << 16).view(np.float32).astype(np.float32)
        return arr.reshape(tuple(t.dims))
    np_dt = _DTYPES.get(dt)
    if np_dt is None:
        raise NotImplementedError(f"TensorProto data_type {dt}")
    if t.HasField("raw_data") and len(t.raw_data):
        arr = np.frombuffer(t.raw_data, dtype=np_dt)
    elif dt == TensorDataType.FLOAT:
        arr = np.asarray(t.float_data, dtype=np_dt)
    elif dt == TensorDataType.DOUBLE:
        arr = np.asarray(t.double_data, dtype=np_dt)
    elif dt == TensorDataType.INT64:
        arr = np.asarray(t.int64_data, dtype=np_dt)
    elif dt in (TensorDataType.UINT32, TensorDataType.UINT64):
        arr = np.asarray(t.uint64_data, dtype=np_dt)
    else:
        arr = np.asarray(t.int32_data, dtype=np_dt)
    return arr.reshape(tuple(t.dims))


def from_array(arr: np.ndarray, name: str = "") -> PB:
    """numpy array -> TensorProto (raw_data encoding)."""
    # not ascontiguousarray: that promotes 0-d scalars to 1-d
    arr = np.asarray(arr, order="C")
    dt = _NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        raise NotImplementedError(f"dtype {arr.dtype}")
    t = PB("TensorProto")
    t.dims = list(arr.shape)
    t.data_type = dt
    t.raw_data = arr.tobytes()
    if name:
        t.name = name
    return t


def _to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of `arr` on `device`; float64 becomes float32."""
    arr = np.array(arr, dtype=np.float32 if arr.dtype == np.float64
                   else arr.dtype)
    return torch.from_numpy(arr).to(device)


def _attrs(node: PB) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for a in node.attribute:
        ty = a.type
        if ty == AttrType.FLOAT:
            out[a.name] = a.f
        elif ty == AttrType.INT:
            out[a.name] = a.i
        elif ty == AttrType.STRING:
            out[a.name] = a.s.decode("utf-8", errors="replace")
        elif ty == AttrType.TENSOR:
            out[a.name] = to_array(a.t)
        elif ty == AttrType.FLOATS:
            out[a.name] = list(a.floats)
        elif ty == AttrType.INTS:
            out[a.name] = list(a.ints)
        elif ty == AttrType.STRINGS:
            out[a.name] = [s.decode("utf-8") for s in a.strings]
        else:
            raise NotImplementedError(f"attribute type {ty} ({a.name})")
    return out


# -- node handlers ------------------------------------------------------------
#
# handler(ctx, node, attrs, ins) -> [outputs]: `ctx` is the SONNXModel
# (statics and constants), `ins` the input tensors, None for an omitted
# optional input.

HANDLERS: Dict[str, Callable] = {}


def handler(*op_types: str):
    def deco(fn):
        for op_type in op_types:
            HANDLERS[op_type] = fn
        return fn

    return deco


def _opt(ins, i):
    """Optional input i, or None."""
    return ins[i] if len(ins) > i else None


def _onnx_pads(attrs, spatial: int):
    """ONNX pads [b1..bn, e1..en] -> [(b1, e1), ...]; auto_pad VALID
    gives zeros, SAME_* the string "SAME"."""
    auto = attrs.get("auto_pad", "NOTSET")
    if auto and auto not in ("NOTSET", ""):
        if auto == "VALID":
            return [(0, 0)] * spatial
        return "SAME"
    pads = attrs.get("pads", [0] * (2 * spatial))
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _torch_pads(pads) -> List[int]:
    """[(b1, e1), ..., (bn, en)] over the trailing dims -> F.pad's order
    (the last dim first)."""
    return [p for pair in reversed(pads) for p in pair]


@handler("Conv")
def _conv(ctx, node, attrs, ins):
    x, w, b = ins[0], ins[1], _opt(ins, 2)
    spatial = x.dim() - 2
    if spatial != 2:
        raise NotImplementedError("sonnx Conv: only 2-D convs supported")
    strides = tuple(attrs.get("strides", [1] * spatial))
    dilations = tuple(attrs.get("dilations", [1] * spatial))
    pads = _onnx_pads(attrs, spatial)
    if isinstance(pads, str):
        pads = autograd._same_pads(
            x.shape[2:], attrs.get("kernel_shape", w.shape[2:]), strides,
            dilations, lower="LOWER" in attrs["auto_pad"])
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x, padding = F.pad(x, _torch_pads(pads)), (0, 0)
    return [F.conv2d(x, w, b, strides, padding, dilations,
                     attrs.get("group", 1))]


def _bshape(x):
    return (1, -1) + (1,) * (x.dim() - 2)


@handler("BatchNormalization")
def _bn(ctx, node, attrs, ins):
    x, g, b, m, v = ins[:5]
    eps = attrs.get("epsilon", 1e-5)
    s = _bshape(x)
    return [(x - m.reshape(s)) * torch.rsqrt(v.reshape(s) + eps)
            * g.reshape(s) + b.reshape(s)]


@handler("InstanceNormalization")
def _instancenorm(ctx, node, attrs, ins):
    x, g, b = ins[:3]
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    v = x.var(dim=axes, keepdim=True, correction=0)
    s = _bshape(x)
    return [(x - m) * torch.rsqrt(v + eps) * g.reshape(s) + b.reshape(s)]


@handler("LayerNormalization")
def _layernorm(ctx, node, attrs, ins):
    x, g, b = ins[0], ins[1], _opt(ins, 2)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(attrs.get("axis", -1) % x.dim(), x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    v = x.var(dim=axes, keepdim=True, correction=0)
    y = (x - m) * torch.rsqrt(v + eps) * g
    return [y if b is None else y + b]


@handler("LRN")
def _lrn(ctx, node, attrs, ins):
    x = ins[0]
    alpha, beta = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75)
    bias, size = attrs.get("bias", 1.0), attrs.get("size", 5)
    half = size // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, size - 1 - half))
    acc = sq.unfold(1, size, 1).sum(-1)  # a window over the channels
    return [x / torch.pow(bias + alpha / size * acc, beta)]


_POOLS = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
          ("max", 3): F.max_pool3d, ("avg", 1): F.avg_pool1d,
          ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}


def _pool(ctx, node, attrs, ins, kind: str):
    x = ins[0]
    spatial = x.dim() - 2
    k = tuple(attrs["kernel_shape"])
    strides = tuple(attrs.get("strides", [1] * spatial))
    pads = _onnx_pads(attrs, spatial)
    if isinstance(pads, str):
        raise NotImplementedError("sonnx pooling: auto_pad SAME")
    pool = _POOLS[(kind, spatial)]
    padded = any(lo or hi for lo, hi in pads)
    if kind == "max":
        if padded:
            x = F.pad(x, _torch_pads(pads), value=-math.inf)
        return [pool(x, k, strides)]
    mean = pool(F.pad(x, _torch_pads(pads)) if padded else x, k, strides)
    if not padded or attrs.get("count_include_pad", 0):
        return [mean]
    # the share of each window that is not padding
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return [mean / pool(F.pad(ones, _torch_pads(pads)), k, strides)]


@handler("MaxPool")
def _maxpool(ctx, node, attrs, ins):
    return _pool(ctx, node, attrs, ins, "max")


@handler("AveragePool")
def _avgpool(ctx, node, attrs, ins):
    return _pool(ctx, node, attrs, ins, "avg")


@handler("GlobalAveragePool")
def _gap(ctx, node, attrs, ins):
    x = ins[0]
    return [x.mean(dim=tuple(range(2, x.dim())), keepdim=True)]


@handler("GlobalMaxPool")
def _gmp(ctx, node, attrs, ins):
    x = ins[0]
    return [x.amax(dim=tuple(range(2, x.dim())), keepdim=True)]


_UNARY = {
    "Relu": F.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Softplus": F.softplus,
    "Softsign": F.softsign,
    "Exp": torch.exp,
    "Log": torch.log,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Reciprocal": torch.reciprocal,
    "Sqrt": torch.sqrt,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,  # half to even, as jnp.round
    "Erf": torch.erf,
    "Sign": torch.sign,
    "Not": torch.logical_not,
    "Sin": torch.sin,
    "Cos": torch.cos,
    "Identity": lambda x: x,
}


@handler(*_UNARY)
def _unary(ctx, node, attrs, ins):
    return [_UNARY[node.op_type](ins[0])]


@handler("LeakyRelu")
def _leaky(ctx, node, attrs, ins):
    return [F.leaky_relu(ins[0], attrs.get("alpha", 0.01))]


@handler("Elu")
def _elu(ctx, node, attrs, ins):
    return [F.elu(ins[0], attrs.get("alpha", 1.0))]


@handler("Selu")
def _selu(ctx, node, attrs, ins):
    return [F.selu(ins[0])]


@handler("PRelu")
def _prelu(ctx, node, attrs, ins):
    x, s = ins[:2]
    return [torch.where(x >= 0, x, s * x)]


@handler("HardSigmoid")
def _hardsigmoid(ctx, node, attrs, ins):
    a, b = attrs.get("alpha", 0.2), attrs.get("beta", 0.5)
    return [torch.clamp(a * ins[0] + b, 0.0, 1.0)]


@handler("Gelu")
def _gelu(ctx, node, attrs, ins):
    form = "tanh" if attrs.get("approximate", "none") == "tanh" else "none"
    return [F.gelu(ins[0], approximate=form)]


@handler("Clip")
def _clip(ctx, node, attrs, ins):
    lo, hi = attrs.get("min"), attrs.get("max")
    if _opt(ins, 1) is not None:  # opset 11 on: min and max as inputs
        lo = ctx.static(node, 1, ins[1])
    if _opt(ins, 2) is not None:
        hi = ctx.static(node, 2, ins[2])
    lo = -math.inf if lo is None else float(np.asarray(lo))
    hi = math.inf if hi is None else float(np.asarray(hi))
    return [torch.clamp(ins[0], lo, hi)]


@handler("Softmax")
def _softmax(ctx, node, attrs, ins):
    return [F.softmax(ins[0], dim=attrs.get("axis", -1))]


@handler("LogSoftmax")
def _logsoftmax(ctx, node, attrs, ins):
    return [F.log_softmax(ins[0], dim=attrs.get("axis", -1))]


_BINARY = {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": torch.true_divide,  # jnp.divide's true division, ints too
    "Pow": torch.pow,
    "Min": torch.minimum,
    "Max": torch.maximum,
    "Equal": torch.eq,
    "Greater": torch.gt,
    "GreaterOrEqual": torch.ge,
    "Less": torch.lt,
    "LessOrEqual": torch.le,
    "And": torch.logical_and,
    "Or": torch.logical_or,
    "Xor": torch.logical_xor,
    "Mod": torch.remainder,  # jnp.mod: the sign of the divisor
}


@handler(*_BINARY)
def _binary(ctx, node, attrs, ins):
    fn = _BINARY[node.op_type]
    out = ins[0]
    for x in ins[1:]:  # Min and Max are variadic
        out = fn(out, x)
    return [out]


@handler("Sum")
def _sum_variadic(ctx, node, attrs, ins):
    out = ins[0]
    for x in ins[1:]:
        out = out + x
    return [out]


@handler("Where")
def _where(ctx, node, attrs, ins):
    c, a, b = ins[:3]
    return [torch.where(c.bool(), a, b)]


@handler("MatMul")
def _matmul(ctx, node, attrs, ins):
    return [torch.matmul(ins[0], ins[1])]


@handler("Einsum")
def _einsum(ctx, node, attrs, ins):
    return [torch.einsum(attrs["equation"], *ins)]


@handler("Gemm")
def _gemm(ctx, node, attrs, ins):
    a, b, c = ins[0], ins[1], _opt(ins, 2)
    a = a.t() if attrs.get("transA", 0) else a
    b = b.t() if attrs.get("transB", 0) else b
    out = attrs.get("alpha", 1.0) * (a @ b)
    if c is not None:
        out = out + attrs.get("beta", 1.0) * c
    return [out]


_TORCH_DTYPES = {
    TensorDataType.FLOAT: torch.float32,
    TensorDataType.UINT8: torch.uint8,
    TensorDataType.INT8: torch.int8,
    TensorDataType.INT16: torch.int16,
    TensorDataType.INT32: torch.int32,
    TensorDataType.INT64: torch.int64,
    TensorDataType.BOOL: torch.bool,
    TensorDataType.FLOAT16: torch.float16,
    TensorDataType.DOUBLE: torch.float64,
    TensorDataType.BFLOAT16: torch.bfloat16,
}


@handler("Cast")
def _cast(ctx, node, attrs, ins):
    dt = _TORCH_DTYPES.get(attrs["to"])
    if dt is None:
        raise NotImplementedError(f"Cast to {attrs['to']}")
    return [ins[0].to(dt)]


@handler("CastLike")
def _castlike(ctx, node, attrs, ins):
    return [ins[0].to(ins[1].dtype)]


@handler("Dropout")
def _dropout(ctx, node, attrs, ins):
    # inference semantics: identity (and an all-true mask if asked for)
    out = [ins[0]]
    if len(node.output) > 1:
        out.append(torch.ones_like(ins[0], dtype=torch.bool))
    return out


@handler("Flatten")
def _flatten(ctx, node, attrs, ins):
    x = ins[0]
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis else 1
    return [x.reshape(lead, -1)]


@handler("Reshape")
def _reshape(ctx, node, attrs, ins):
    x = ins[0]
    shape = [int(s) for s in ctx.static(node, 1, ins[1])]
    keep = not attrs.get("allowzero", 0)
    return [x.reshape([x.shape[i] if (s == 0 and keep) else s
                       for i, s in enumerate(shape)])]


@handler("Transpose")
def _transpose(ctx, node, attrs, ins):
    x = ins[0]
    perm = attrs.get("perm") or list(reversed(range(x.dim())))
    return [x.permute(perm)]


@handler("Squeeze")
def _squeeze(ctx, node, attrs, ins):
    axes = attrs.get("axes")
    if axes is None and _opt(ins, 1) is not None:
        axes = [int(a) for a in ctx.static(node, 1, ins[1])]
    x = ins[0]
    return [torch.squeeze(x, dim=tuple(axes)) if axes else torch.squeeze(x)]


@handler("Unsqueeze")
def _unsqueeze(ctx, node, attrs, ins):
    axes = attrs.get("axes")
    if axes is None:
        axes = [int(a) for a in ctx.static(node, 1, ins[1])]
    out = ins[0]
    rank = out.dim() + len(axes)
    for a in sorted(int(v) % rank for v in axes):
        out = out.unsqueeze(a)
    return [out]


@handler("Concat")
def _concat(ctx, node, attrs, ins):
    return [torch.cat(ins, dim=attrs["axis"])]


@handler("Split")
def _split(ctx, node, attrs, ins):
    x, axis = ins[0], attrs.get("axis", 0)
    sizes = attrs.get("split")
    if sizes is None and _opt(ins, 1) is not None:
        sizes = [int(s) for s in ctx.static(node, 1, ins[1])]
    if sizes is None:
        n_out = len(node.output)
        if x.shape[axis] % n_out:
            raise ValueError(f"Split: {x.shape[axis]} does not divide into "
                             f"{n_out} equal parts")
        sizes = [x.shape[axis] // n_out] * n_out
    return list(torch.split(x, sizes, dim=axis))


def _slice_axis(x, ax, st, en, sp):
    """x[..., st:en:sp, ...] on axis ax, negative steps included."""
    n = x.shape[ax]
    st, en, sp = slice(st, en, sp).indices(n)
    idx = [slice(None)] * x.dim()
    if sp > 0:
        idx[ax] = slice(st, en, sp)
        return x[tuple(idx)]
    # torch slices step forward only: walk the flipped axis
    idx[ax] = slice(n - 1 - st, n - 1 - en, -sp)
    return x.flip(ax)[tuple(idx)]


@handler("Slice")
def _slice(ctx, node, attrs, ins):
    if "starts" in attrs:  # opset < 10
        starts, ends = attrs["starts"], attrs["ends"]
        axes = attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = [int(v) for v in ctx.static(node, 1, ins[1])]
        ends = [int(v) for v in ctx.static(node, 2, ins[2])]
        axes = ([int(v) for v in ctx.static(node, 3, ins[3])]
                if _opt(ins, 3) is not None else list(range(len(starts))))
        steps = ([int(v) for v in ctx.static(node, 4, ins[4])]
                 if _opt(ins, 4) is not None else [1] * len(starts))
    x = ins[0]
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        x = _slice_axis(x, ax % x.dim(), st, en, sp)
    return [x]


def _wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


@handler("Gather")
def _gather(ctx, node, attrs, ins):
    x, idx = ins[:2]
    axis = attrs.get("axis", 0) % x.dim()
    idx = _wrap_index(idx, x.shape[axis])
    out = x.index_select(axis, idx.reshape(-1))
    return [out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])]


@handler("GatherElements")
def _gather_elements(ctx, node, attrs, ins):
    x, idx = ins[:2]
    axis = attrs.get("axis", 0) % x.dim()
    return [torch.gather(x, axis, _wrap_index(idx, x.shape[axis]))]


@handler("Expand")
def _expand(ctx, node, attrs, ins):
    tgt = [int(s) for s in ctx.static(node, 1, ins[1])]
    x = ins[0]
    xs = [1] * (len(tgt) - x.dim()) + list(x.shape)
    tgt = [1] * (len(xs) - len(tgt)) + tgt
    # numpy-style broadcast: a 1 or -1 keeps the input's dim
    shape = [xs[i] if tgt[i] in (1, -1) else tgt[i] for i in range(len(tgt))]
    return [x.reshape(xs).expand(shape)]


@handler("Tile")
def _tile(ctx, node, attrs, ins):
    reps = [int(r) for r in ctx.static(node, 1, ins[1])]
    return [ins[0].tile(reps)]


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "edge": "replicate"}


@handler("Pad")
def _pad(ctx, node, attrs, ins):
    mode = _PAD_MODES[attrs.get("mode", "constant")]
    if "pads" in attrs:  # opset < 11
        pads, cval = attrs["pads"], attrs.get("value", 0.0)
    else:
        pads = [int(v) for v in ctx.static(node, 1, ins[1])]
        cval = (float(np.asarray(ctx.static(node, 2, ins[2])))
                if _opt(ins, 2) is not None else 0.0)
    n = len(pads) // 2
    width = [(pads[i], pads[i + n]) for i in range(n)]
    if mode != "constant":  # F.pad pads only the trailing dims there
        while width and width[0] == (0, 0):
            width.pop(0)
    x = ins[0]
    if mode == "constant":
        return [F.pad(x, _torch_pads(width), value=cval)]
    return [F.pad(x, _torch_pads(width), mode=mode)]


@handler("Shape")
def _shape(ctx, node, attrs, ins):
    dims = tuple(ins[0].shape[attrs.get("start", 0):attrs.get("end")])
    return [ctx.const((id(node), dims), dims, torch.int64)]


@handler("Size")
def _size(ctx, node, attrs, ins):
    n = ins[0].numel()
    return [ctx.const((id(node), n), n, torch.int64)]


_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float32,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.bool_): torch.bool}


@handler("ConstantOfShape")
def _const_of_shape(ctx, node, attrs, ins):
    shape = [int(s) for s in ctx.static(node, 0, ins[0])]
    value = attrs.get("value")
    if value is None:
        value = np.zeros((1,), np.float32)
    return [torch.full(shape, value.reshape(())[()].item(),
                       dtype=_NP_TO_TORCH[value.dtype], device=ctx.device)]


@handler("Range")
def _range(ctx, node, attrs, ins):
    start, limit, delta = (np.asarray(ctx.static(node, i, ins[i])).item()
                           for i in range(3))
    arr = np.arange(start, limit, delta)
    return [ctx.const((id(node), start, limit, delta), arr)]


def _reduce(ctx, node, attrs, ins, fn_red):
    axes = attrs.get("axes")
    if axes is None and _opt(ins, 1) is not None:
        axes = [int(a) for a in ctx.static(node, 1, ins[1])]
    keepdims = bool(attrs.get("keepdims", 1))
    x = ins[0]
    if not axes and attrs.get("noop_with_empty_axes", 0):
        return [x]
    dims = tuple(a % x.dim() for a in axes) if axes else tuple(
        range(x.dim()))
    return [fn_red(x, dims, keepdims)]


def _prod(x, dims, keepdim):
    for d in sorted(dims, reverse=True):  # torch.prod takes one dim
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCTIONS = {
    "ReduceMean": lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
    "ReduceSum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "ReduceMax": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "ReduceMin": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
    "ReduceProd": _prod,
    "ReduceL2": lambda x, d, k: torch.sqrt(
        torch.sum(x.square(), dim=d, keepdim=k)),
}


@handler(*_REDUCTIONS)
def _reduction(ctx, node, attrs, ins):
    return _reduce(ctx, node, attrs, ins, _REDUCTIONS[node.op_type])


@handler("ArgMax", "ArgMin")
def _arg(ctx, node, attrs, ins):
    fn = torch.argmax if node.op_type == "ArgMax" else torch.argmin
    return [fn(ins[0], dim=attrs.get("axis", 0),
               keepdim=bool(attrs.get("keepdims", 1)))]


@handler("Constant")
def _constant(ctx, node, attrs, ins):
    if "value" in attrs:
        arr = attrs["value"]
    elif "value_float" in attrs:
        arr = np.asarray(attrs["value_float"], np.float32)
    elif "value_int" in attrs:
        arr = np.asarray(attrs["value_int"], np.int64)
    elif "value_floats" in attrs:
        arr = np.asarray(attrs["value_floats"], np.float32)
    elif "value_ints" in attrs:
        arr = np.asarray(attrs["value_ints"], np.int64)
    else:
        raise NotImplementedError("Constant without tensor value")
    return [ctx.const((id(node),), arr)]


@handler("OneHot")
def _onehot(ctx, node, attrs, ins):
    idx, values = ins[0], ins[2]
    depth = int(np.asarray(ctx.static(node, 1, ins[1])))
    oh = F.one_hot(_wrap_index(idx, depth), depth).to(values.dtype)
    oh = oh.movedim(-1, attrs.get("axis", -1) % oh.dim())
    return [oh * (values[1] - values[0]) + values[0]]


@handler("Trilu")
def _trilu(ctx, node, attrs, ins):
    k = int(np.asarray(ctx.static(node, 1, ins[1]))) if _opt(
        ins, 1) is not None else 0
    fn = torch.triu if attrs.get("upper", 1) else torch.tril
    return [fn(ins[0], k)]


# -- the recurrent ops --------------------------------------------------------


def _rnn_family_common(node, attrs, ins):
    """Validate an LSTM/GRU/RNN node: time-major layout, no cell clip,
    default activations (RNN: Tanh or Relu), no per-example
    sequence_lens, no peepholes. Returns (hidden, direction, dirs)."""
    if attrs.get("layout", 0):
        raise NotImplementedError(
            f"{node.op_type}: layout=1 (batch-major) is not supported; "
            "re-export time-major")
    if attrs.get("clip") is not None:
        raise NotImplementedError(
            f"{node.op_type}: cell clip is not supported")
    direction = attrs.get("direction", "forward")
    if direction not in ("forward", "reverse", "bidirectional"):
        raise NotImplementedError(
            f"{node.op_type}: direction {direction!r}")
    dirs = 2 if direction == "bidirectional" else 1
    acts = attrs.get("activations")
    if acts is not None:
        defaults = {"LSTM": ["Sigmoid", "Tanh", "Tanh"],
                    "GRU": ["Sigmoid", "Tanh"],
                    "RNN": ["Tanh"]}[node.op_type] * dirs
        if not (node.op_type == "RNN" and all(
                a in ("Tanh", "Relu") for a in acts)) and acts != defaults:
            raise NotImplementedError(
                f"{node.op_type}: non-default activations {acts}")
    if _opt(ins, 4) is not None:
        raise NotImplementedError(
            f"{node.op_type}: per-example sequence_lens is not supported "
            "(fixed-length time loop)")
    if node.op_type == "LSTM" and _opt(ins, 7) is not None:
        raise NotImplementedError("LSTM: peephole weights (input P)")
    return int(attrs["hidden_size"]), direction, dirs


def _run_directions(proj, dirs, direction, step, carries):
    """Run `step(carry, xt, d) -> carry` over time for each direction d
    (the second of a bidirectional node, or a reverse node, walks back
    and keeps its outputs time-aligned) over proj[d], d's input
    projection (T, B, G*H); carries[d] is d's first carry, whose element 0
    is the output. Returns (y (T, dirs, B, H), [final carry per
    direction])."""
    ys_d, finals = [], []
    for d in range(dirs):
        xs = proj[d].unbind(0)
        rev = d == 1 or direction == "reverse"
        carry, ys = carries[d], [None] * len(xs)
        for t in (reversed(range(len(xs))) if rev else range(len(xs))):
            carry = step(carry, xs[t], d)
            ys[t] = carry[0]
        ys_d.append(torch.stack(ys))
        finals.append(carry)
    return torch.stack(ys_d, dim=1), finals


def _start(state, d, b, h, x):
    return state[d] if state is not None else x.new_zeros((b, h))


@handler("LSTM")
def _lstm(ctx, node, attrs, ins):
    """ONNX LSTM: gates i, o, f, c; B = [Wb; Rb]."""
    H, direction, dirs = _rnn_family_common(node, attrs, ins)
    x, w, r = ins[:3]
    b, h0, c0 = _opt(ins, 3), _opt(ins, 5), _opt(ins, 6)
    B = x.shape[1]
    proj = [torch.matmul(x, w[d].t()) + (b[d][:4 * H] + b[d][4 * H:]
                                         if b is not None else 0.0)
            for d in range(dirs)]

    def step(carry, xt, d):
        h, c = carry
        i, o, f, ct = (xt + torch.matmul(h, r[d].t())).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(ct)
        return torch.sigmoid(o) * torch.tanh(c), c

    y, finals = _run_directions(
        proj, dirs, direction, step,
        [(_start(h0, d, B, H, x), _start(c0, d, B, H, x))
         for d in range(dirs)])
    outs = [y, torch.stack([f[0] for f in finals]),
            torch.stack([f[1] for f in finals])]
    return outs[:len(node.output)]


@handler("GRU")
def _gru(ctx, node, attrs, ins):
    """ONNX GRU: gates z, r, h, both `linear_before_reset` forms."""
    H, direction, dirs = _rnn_family_common(node, attrs, ins)
    lbr = int(attrs.get("linear_before_reset", 0))
    x, w, r = ins[:3]
    b, h0 = _opt(ins, 3), _opt(ins, 5)
    B = x.shape[1]
    wb = [b[d][:3 * H] if b is not None else 0.0 for d in range(dirs)]
    rb = [b[d][3 * H:] if b is not None else x.new_zeros(3 * H)
          for d in range(dirs)]
    proj = [torch.matmul(x, w[d].t()) + wb[d] for d in range(dirs)]

    def step(carry, xt, d):
        (h,) = carry
        rd = r[d]
        # lbr=0's candidate needs (r*h) Rh apart, so only the z and r
        # two-thirds of the recurrent product run here
        hp = torch.matmul(h, (rd if lbr else rd[:2 * H]).t()) + (
            rb[d] if lbr else rb[d][:2 * H])
        z = torch.sigmoid(xt[..., :H] + hp[..., :H])
        rt = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
        if lbr:
            n = torch.tanh(xt[..., 2 * H:] + rt * hp[..., 2 * H:])
        else:
            n = torch.tanh(xt[..., 2 * H:] + torch.matmul(
                rt * h, rd[2 * H:].t()) + rb[d][2 * H:])
        return ((1.0 - z) * n + z * h,)

    y, finals = _run_directions(
        proj, dirs, direction, step,
        [(_start(h0, d, B, H, x),) for d in range(dirs)])
    return [y, torch.stack([f[0] for f in finals])][:len(node.output)]


@handler("RNN")
def _rnn(ctx, node, attrs, ins):
    """ONNX vanilla RNN, Tanh or Relu."""
    H, direction, dirs = _rnn_family_common(node, attrs, ins)
    acts = attrs.get("activations") or ["Tanh"] * dirs
    act = [torch.tanh if a == "Tanh" else F.relu for a in acts]
    x, w, r = ins[:3]
    b, h0 = _opt(ins, 3), _opt(ins, 5)
    B = x.shape[1]
    proj = [torch.matmul(x, w[d].t()) + (b[d][:H] + b[d][H:]
                                         if b is not None else 0.0)
            for d in range(dirs)]

    def step(carry, xt, d):
        return (act[d](xt + torch.matmul(carry[0], r[d].t())),)

    y, finals = _run_directions(
        proj, dirs, direction, step,
        [(_start(h0, d, B, H, x),) for d in range(dirs)])
    return [y, torch.stack([f[0] for f in finals])][:len(node.output)]


# -- the backend --------------------------------------------------------------


def _esc(name: str) -> str:
    """An ONNX name as an `nn.Module` key (no "."), reversibly."""
    return name.replace("%", "%25").replace(".", "%2E")


def _unesc(key: str) -> str:
    return key.replace("%2E", ".").replace("%25", "%")


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class SONNXModel(model_module.Model):
    """An imported ONNX graph as a Model: it runs eagerly, trains, and
    captures its training step under `graph()` (see the module
    docstring). `forward(*inputs)` takes the graph's non-initializer
    inputs in order; `train_one_batch(x, y)` is softmax cross-entropy on
    the first output, then the optimizer."""

    def __init__(self, graph: PB, device=None):
        super().__init__()
        self._graph = graph
        self.device = device_module.resolve(device)
        self._statics: Dict[Tuple[int, int], np.ndarray] = {}
        self._made: Dict[Any, torch.Tensor] = {}
        self._node_attrs: Dict[int, Dict[str, Any]] = {}
        self._recorded = False
        self._output_names = [o.name for o in graph.output]

        # BatchNormalization's running mean and variance (inputs 3 and
        # 4) are state, not weights; scalars (mask fill values) are
        # constants, except PRelu slopes. Fine-tuning moves weights only.
        buffer_names, trainable_scalars = set(), set()
        for node in graph.node:
            if node.op_type == "BatchNormalization":
                buffer_names.update(node.input[3:5])
            if node.op_type == "PRelu" and len(node.input) > 1:
                trainable_scalars.add(node.input[1])
        self.params = nn.ParameterDict()
        self.state = nn.Module()  # buffers under escaped ONNX names
        self.consts = nn.Module()
        init_names = set()
        for init in graph.initializer:
            arr = to_array(init)
            init_names.add(init.name)
            t = _to_torch(arr, self.device)
            is_float = arr.dtype.kind == "f"
            if is_float and init.name in buffer_names:
                self.state.register_buffer(_esc(init.name), t)
            elif is_float and (arr.size > 1
                               or init.name in trainable_scalars):
                self.params[_esc(init.name)] = nn.Parameter(t)
            else:
                self.consts.register_buffer(_esc(init.name), t,
                                            persistent=False)
        self._input_names = [vi.name for vi in graph.input
                             if vi.name not in init_names]

    # -- the initializers under their ONNX names -----------------------------
    def get_params(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        return {prefix + _unesc(k): v for k, v in self.params.items()}

    def get_buffers(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        return {prefix + _unesc(k): v
                for k, v in self.state.named_buffers()}

    def get_consts(self) -> Dict[str, torch.Tensor]:
        return {_unesc(k): v for k, v in self.consts.named_buffers()}

    def get_states(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        out = self.get_params(prefix)
        out.update(self.get_buffers(prefix))
        return out

    def set_params(self, params) -> None:
        own = self.get_params()
        with torch.no_grad():
            for k, v in params.items():
                own[k].copy_(torch.as_tensor(np.asarray(v)))

    def set_states(self, states) -> None:
        own = {**self.get_consts(), **self.get_states()}
        with torch.no_grad():
            for k, v in states.items():
                if k not in own:
                    raise KeyError(f"unknown state {k!r}")
                own[k].copy_(torch.as_tensor(np.asarray(v)))

    def set_optimizer(self, opt) -> None:
        """As `Model.set_optimizer`, with the slots under ONNX names."""
        self._optimizer = opt
        opt.prepare(self.get_params())

    # -- statics and constants -----------------------------------------------
    def static(self, node: PB, idx: int, t) -> np.ndarray:
        """Input `idx` of `node` as host values: read on the first run,
        replayed after it."""
        key = (id(node), idx)
        if not self._recorded:
            if _capturing():
                raise RuntimeError(
                    "sonnx: the first run of an imported model reads its "
                    "static inputs on the host; run it uncaptured first")
            val = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t))
            self._statics[key] = val
            return val
        if key not in self._statics:
            raise RuntimeError(
                f"{node.op_type}: static input {idx} was not captured on "
                "the recording run (did the input signature change? "
                "re-prepare)")
        return self._statics[key]

    def const(self, key, values, dtype=None) -> torch.Tensor:
        """A tensor of host values on the model's device, made once per
        key (a host-to-device copy cannot run inside a capture)."""
        t = self._made.get(key)
        if t is None:
            if _capturing():
                raise RuntimeError(
                    "sonnx: a new constant inside a CUDA Graph capture; "
                    "run this input signature uncaptured first")
            arr = np.asarray(values)
            t = _to_torch(arr, self.device)
            if dtype is not None:
                t = t.to(dtype)
            self._made[key] = t
        return t

    def _attrs_of(self, node: PB) -> Dict[str, Any]:
        a = self._node_attrs.get(id(node))
        if a is None:
            a = self._node_attrs[id(node)] = _attrs(node)
        return a

    # -- execution -----------------------------------------------------------
    def forward(self, *xs):
        if len(xs) != len(self._input_names):
            raise ValueError(
                f"expected {len(self._input_names)} inputs "
                f"{self._input_names}, got {len(xs)}")
        env: Dict[str, torch.Tensor] = {**self.get_consts(),
                                        **self.get_states()}
        for name, x in zip(self._input_names, xs):
            env[name] = (x.to(self.device) if isinstance(x, torch.Tensor)
                         else _to_torch(np.asarray(x), self.device))
        for node in self._graph.node:
            fn = HANDLERS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"sonnx: unsupported ONNX op {node.op_type!r}")
            ins = [env[n] if n else None for n in node.input]
            outs = fn(self, node, self._attrs_of(node), ins)
            for name, out in zip(node.output, outs):
                if name:
                    env[name] = out
        self._recorded = True
        result = [env[n] for n in self._output_names]
        return result[0] if len(result) == 1 else tuple(result)

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self._apply_opt(loss)
        return out, loss


class SingaRep:
    """The reference's backend rep: `.run(inputs)` -> numpy outputs."""

    def __init__(self, model: SONNXModel):
        self.model = model

    def run(self, inputs: Sequence) -> List[np.ndarray]:
        prev = autograd.training
        autograd.training = False
        try:
            with torch.no_grad():
                out = self.model.forward(*inputs)
        finally:
            autograd.training = prev
        outs = out if isinstance(out, tuple) else (out,)
        return [o.detach().cpu().numpy() for o in outs]


def _as_model_pb(model) -> PB:
    if isinstance(model, PB):
        return model
    if isinstance(model, (bytes, bytearray)):
        return decode_model(bytes(model))
    if isinstance(model, str):
        with open(model, "rb") as f:
            return decode_model(f.read())
    raise TypeError(f"cannot load ONNX model from {type(model)}")


def prepare(model, device=None) -> SingaRep:
    """`sonnx.prepare(onnx_model, device)` -> a runnable rep; `model` is
    ONNX bytes, a file path or a decoded ModelProto. On the card unless
    `device="cpu"`."""
    return SingaRep(SONNXModel(_as_model_pb(model).graph, device))


def load(path, device=None) -> SONNXModel:
    """An ONNX file (or bytes) as a fine-tunable SONNXModel."""
    return SONNXModel(_as_model_pb(path).graph, device)


def save(model_pb: PB, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_model(model_pb))


from singa_tpu_torch.sonnx.export import to_onnx  # noqa: E402,F401
