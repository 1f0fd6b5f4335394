"""ONNX export: trace a model's forward and emit a ModelProto
(counterpart of singa_tpu/sonnx/export.py).

`to_onnx(model, inputs)` runs one eval-mode forward under an
`autograd.ExportTrace`, which records every SINGA-level op (`autograd.op`)
with the reference's ONNX kind and attributes, and maps each recorded op
onto ONNX nodes (opset 17) as the reference's exporter maps its tape:
Linear to MatMul + Add, GlobalAvgPoolFlat to GlobalAveragePool + Squeeze,
BatchNormalization in its inference form, the fused Attention op
decomposed into Split / Reshape / MatMul / Softmax nodes (causal: one
additive mask initializer shared by every layer), the recurrent ops as
ONNX LSTM / GRU / RNN nodes with their gate permutations as in-graph
shape ops, and GatherCLS as Gather. Gelu is decomposed too: the erf
form for `approximate="none"`, and, where the reference writes the erf
form for both, the tanh form for `approximate="tanh"`, so a round trip
keeps the model's function.

Initializers take the names of `named_parameters()` and
`named_buffers()` (BatchNorm's running statistics among them); any other
tensor a recorded op reads that is not a graph input or a recorded op's
output is baked as a constant (`arange` positions, zero states), as the
reference bakes its constant leaves. A tensor that a plain torch call
derived from a traced one is refused, naming the torch function; so is a
model whose forward has an op with no ONNX mapping recorded (the scanned
`ScanTransformerStack`, masked attention), as the reference refuses an op
without export metadata.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from singa_tpu_torch import autograd
from singa_tpu_torch.sonnx.proto import PB, AttrType, TensorDataType

__all__ = ["to_onnx"]

_OPSET = 17


def _make_attr(name: str, v: Any) -> Optional[PB]:
    a = PB("AttributeProto")
    a.name = name
    if isinstance(v, bool):
        a.type, a.i = AttrType.INT, int(v)
    elif isinstance(v, (int, np.integer)):
        a.type, a.i = AttrType.INT, int(v)
    elif isinstance(v, (float, np.floating)):
        a.type, a.f = AttrType.FLOAT, float(v)
    elif isinstance(v, str):
        a.type, a.s = AttrType.STRING, v.encode("utf-8")
    elif isinstance(v, np.ndarray):
        from singa_tpu_torch.sonnx import from_array

        a.type, a.t = AttrType.TENSOR, from_array(v)
    elif isinstance(v, (list, tuple)):
        if all(isinstance(x, (int, np.integer)) for x in v):
            a.type, a.ints = AttrType.INTS, [int(x) for x in v]
        elif all(isinstance(x, str) for x in v):
            a.type, a.strings = AttrType.STRINGS, [
                x.encode("utf-8") for x in v]
        else:
            a.type, a.floats = AttrType.FLOATS, [float(x) for x in v]
    elif v is None:
        return None
    else:
        raise TypeError(f"attribute {name}: {type(v)}")
    return a


class _Builder:
    def __init__(self):
        self.nodes: List[PB] = []
        self.initializers: List[PB] = []
        self._n = 0
        self._shared: Dict = {}

    def tmp(self) -> str:
        self._n += 1
        return f"_tmp{self._n}"

    def const(self, arr: np.ndarray, hint: str = "const") -> str:
        from singa_tpu_torch.sonnx import from_array

        self._n += 1
        name = f"{hint}_{self._n}"
        self.initializers.append(from_array(np.asarray(arr), name))
        return name

    def shared_const(self, key, make_arr, hint: str = "const") -> str:
        """One initializer per structural key: repeated emissions (the
        (T, T) causal mask of every attention layer) share one tensor."""
        name = self._shared.get(key)
        if name is None:
            name = self.const(make_arr(), hint)
            self._shared[key] = name
        return name

    def node(self, op_type: str, inputs: Sequence[str],
             outputs: Sequence[str], **attrs) -> None:
        n = PB("NodeProto")
        n.op_type = op_type
        n.input = list(inputs)
        n.output = list(outputs)
        n.name = f"{op_type}_{len(self.nodes)}"
        n.attribute = [a for a in (_make_attr(k, v) for k, v in attrs.items())
                       if a is not None]
        self.nodes.append(n)


def _norm_axes(axes) -> Optional[List[int]]:
    if axes is None:
        return None
    if isinstance(axes, (int, np.integer)):
        return [int(axes)]
    return [int(a) for a in axes]


def _emit_gelu(b: _Builder, approximate: str, ins: List[str],
               outs: List[str]) -> None:
    """0.5 x (1 + erf(x / sqrt 2)), or for the tanh form
    0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))."""
    x = ins[0]
    half = b.shared_const(("half",), lambda: np.asarray(0.5, np.float32),
                          "half")
    one = b.shared_const(("one",), lambda: np.asarray(1.0, np.float32),
                         "one")
    inner = b.tmp()
    if approximate == "tanh":
        c3 = b.shared_const(("gelu_c3",),
                            lambda: np.asarray(0.044715, np.float32),
                            "gelu_c3")
        k = b.shared_const(("gelu_k",), lambda: np.asarray(
            np.sqrt(2.0 / np.pi), np.float32), "gelu_k")
        x2, x3, cx3, s, ks = (b.tmp() for _ in range(5))
        b.node("Mul", [x, x], [x2])
        b.node("Mul", [x2, x], [x3])
        b.node("Mul", [x3, c3], [cx3])
        b.node("Add", [x, cx3], [s])
        b.node("Mul", [s, k], [ks])
        b.node("Tanh", [ks], [inner])
    else:
        sqrt2 = b.shared_const(("sqrt2",), lambda: np.asarray(
            np.sqrt(2.0), np.float32), "sqrt2")
        t1 = b.tmp()
        b.node("Div", [x, sqrt2], [t1])
        b.node("Erf", [t1], [inner])
    t3, t4 = b.tmp(), b.tmp()
    b.node("Add", [inner, one], [t3])
    b.node("Mul", [x, t3], [t4])
    b.node("Mul", [t4, half], outs)


def _emit(b: _Builder, kind: str, attrs: Dict, extras: List[str],
          ins: List[str], outs: List[str]) -> None:
    if kind == "Linear":  # x @ W + b -> MatMul + Add (rank-agnostic Gemm)
        tmp = b.tmp()
        b.node("MatMul", [ins[0], ins[1]], [tmp])
        b.node("Add", [tmp, ins[2]], [outs[0]])
    elif kind == "Reshape":
        shape = b.const(np.asarray(attrs["shape"], np.int64), "shape")
        b.node("Reshape", [ins[0], shape], outs)
    elif kind == "BatchNormalization":
        b.node("BatchNormalization", list(ins[:3]) + list(extras),
               [outs[0]], epsilon=attrs["epsilon"])
    elif kind == "GlobalAvgPoolFlat":
        tmp = b.tmp()
        b.node("GlobalAveragePool", ins, [tmp])
        axes = b.const(np.asarray([2, 3], np.int64), "axes")
        b.node("Squeeze", [tmp, axes], outs)
    elif kind == "Transpose":
        b.node("Transpose", ins, outs, perm=attrs.get("perm"))
    elif kind == "Gelu":
        _emit_gelu(b, attrs.get("approximate", "none"), ins, outs)
    elif kind == "Attention":
        _emit_attention(b, attrs, ins, outs)
    elif kind in ("SingaLSTM", "SingaGRU", "SingaRNN"):
        _emit_rnn(b, kind, attrs, ins, outs)
    elif kind == "GatherCLS":  # x[:, 0] -> Gather(axis=1, indices=0)
        idx = b.const(np.asarray(0, np.int64), "cls_idx")
        b.node("Gather", [ins[0], idx], outs, axis=1)
    else:
        b.node(kind, ins, outs, **attrs)


def _emit_rnn(b: _Builder, kind: str, attrs: Dict, ins: List[str],
              outs: List[str]) -> None:
    """The recurrent ops as standard ONNX LSTM / GRU / RNN nodes, with the
    weight-layout transforms emitted as in-graph shape ops so the export
    stays value-agnostic:

    - here: W (in, G*H) with gate columns [i f g o | r z n | one],
      combined or split biases; ONNX: W (1, G*H, in) with gate rows
      [i o f c | z r h | one], B (1, 2*G*H) = [Wb; Rb];
    - GRU exports linear_before_reset=1: the candidate gate applies the
      reset inside the hidden affine (the torch/cuDNN form)."""
    H = int(attrs["hidden"])
    direction = "reverse" if attrs.get("reverse") else "forward"
    ax0 = b.shared_const(("axes0",), lambda: np.asarray([0], np.int64),
                         "axes0")
    ax1 = b.shared_const(("axes1",), lambda: np.asarray([1], np.int64),
                         "axes1")

    def unsq0(name):
        u = b.tmp()
        b.node("Unsqueeze", [name, ax0], [u])
        return u

    def permuted(name, perm):
        parts = [b.tmp() for _ in perm]
        b.node("Split", [name], parts, axis=0)
        c = b.tmp()
        b.node("Concat", [parts[i] for i in perm], [c], axis=0)
        return c

    def wt(name, perm):
        """(in, G*H) -> Transpose -> gate permute -> (1, G*H, in)."""
        t = b.tmp()
        b.node("Transpose", [name], [t], perm=[1, 0])
        return unsq0(t if perm is None else permuted(t, perm))

    def bias_perm(name, perm):
        return name if perm is None else permuted(name, perm)

    def squeeze_outs(ys):
        b.node("Squeeze", [ys[0], ax1], [outs[0]])
        for y, o in zip(ys[1:], outs[1:]):
            b.node("Squeeze", [y, ax0], [o])

    if kind == "SingaLSTM":
        perm = [0, 3, 1, 2]  # i f g o -> i o f c (ONNX c is our g)
        x, w_ih, w_hh, bias, h0, c0 = ins
        zeros = b.shared_const(("rnn_zeros", 4 * H), lambda: np.zeros(
            (4 * H,), np.float32), "rb_zeros")
        bcat = b.tmp()
        b.node("Concat", [bias_perm(bias, perm), zeros], [bcat], axis=0)
        ys = [b.tmp() for _ in range(3)]
        b.node("LSTM", [x, wt(w_ih, perm), wt(w_hh, perm), unsq0(bcat), "",
                        unsq0(h0), unsq0(c0)], ys, hidden_size=H,
               direction=direction)
    elif kind == "SingaGRU":
        perm = [1, 0, 2]  # r z n -> z r h
        x, w_ih, w_hh, b_ih, b_hh, h0 = ins
        bcat = b.tmp()
        b.node("Concat", [bias_perm(b_ih, perm), bias_perm(b_hh, perm)],
               [bcat], axis=0)
        ys = [b.tmp() for _ in range(2)]
        b.node("GRU", [x, wt(w_ih, perm), wt(w_hh, perm), unsq0(bcat), "",
                       unsq0(h0)], ys, hidden_size=H, direction=direction,
               linear_before_reset=1)
    else:
        x, w_ih, w_hh, bias, h0 = ins
        zeros = b.shared_const(("rnn_zeros", H), lambda: np.zeros(
            (H,), np.float32), "rb_zeros")
        bcat = b.tmp()
        b.node("Concat", [bias, zeros], [bcat], axis=0)
        act = "Tanh" if attrs.get("nonlinearity", "tanh") == "tanh" else (
            "Relu")
        ys = [b.tmp() for _ in range(2)]
        b.node("RNN", [x, wt(w_ih, None), wt(w_hh, None), unsq0(bcat), "",
                       unsq0(h0)], ys, hidden_size=H, direction=direction,
               activations=[act])
    squeeze_outs(ys)


def _emit_attention(b: _Builder, attrs: Dict, ins: List[str],
                    outs: List[str]) -> None:
    """The fused Attention op (input: (B, T, 3d) packed QKV) as standard
    ONNX nodes: Split -> per-head Reshape/Transpose -> scaled MatMul ->
    (causal mask Add) -> Softmax -> MatMul -> merge heads."""
    h, d = int(attrs["num_heads"]), int(attrs["d_model"])
    hd = d // h
    scale = float(attrs["scale"])
    q, k, v = b.tmp(), b.tmp(), b.tmp()
    b.node("Split", ins, [q, k, v], axis=2)
    heads_shape = b.shared_const(
        ("heads", h, hd), lambda: np.asarray([0, 0, h, hd], np.int64),
        "heads")

    def split_heads(x):  # (B, T, d) -> (B, h, T, hd)
        r, t = b.tmp(), b.tmp()
        b.node("Reshape", [x, heads_shape], [r])
        b.node("Transpose", [r], [t], perm=[0, 2, 1, 3])
        return t

    q2, k2, v2 = split_heads(q), split_heads(k), split_heads(v)
    kt, s, ss = b.tmp(), b.tmp(), b.tmp()
    b.node("Transpose", [k2], [kt], perm=[0, 1, 3, 2])
    b.node("MatMul", [q2, kt], [s])
    scale_c = b.shared_const(("scale", scale), lambda: np.asarray(
        scale, np.float32), "scale")
    b.node("Mul", [s, scale_c], [ss])
    if attrs["causal"]:
        # additive (1, 1, T, T) upper-triangular mask, T the traced
        # sequence length; one initializer for every layer
        t_len = int(attrs["seq_len"])
        mask = b.shared_const(
            ("causal_mask", t_len),
            lambda: np.triu(np.full((t_len, t_len), -1e30, np.float32),
                            k=1)[None, None], "causal_mask")
        masked = b.tmp()
        b.node("Add", [ss, mask], [masked])
        ss = masked
    p, o, ot = b.tmp(), b.tmp(), b.tmp()
    b.node("Softmax", [ss], [p], axis=-1)
    b.node("MatMul", [p, v2], [o])
    b.node("Transpose", [o], [ot], perm=[0, 2, 1, 3])
    merge_shape = b.shared_const(
        ("merge", d), lambda: np.asarray([0, 0, d], np.int64), "merge")
    b.node("Reshape", [ot, merge_shape], outs)


_ELEM_TYPES = {torch.float32: TensorDataType.FLOAT,
               torch.float64: TensorDataType.DOUBLE,
               torch.int32: TensorDataType.INT32,
               torch.int64: TensorDataType.INT64,
               torch.bool: TensorDataType.BOOL}


def _value_info(name: str, t: torch.Tensor) -> PB:
    dims = []
    for d in t.shape:
        dd = PB("TensorShapeDim")
        dd.dim_value = int(d)
        dims.append(dd)
    shape = PB("TensorShapeProto")
    shape.dim = dims
    tt = PB("TypeProtoTensor")
    tt.elem_type = _ELEM_TYPES.get(t.dtype, TensorDataType.FLOAT)
    tt.shape = shape
    ty = PB("TypeProto")
    ty.tensor_type = tt
    v = PB("ValueInfoProto")
    v.name = name
    v.type = ty
    return v


def _live_ops(ops, outs):
    """The recorded ops the outputs depend on, in their order (a model's
    forward may compute what it never returns)."""
    live = {id(t) for t in outs}
    keep = []
    for rec in reversed(ops):
        if any(id(t) in live for t in rec[4]):
            keep.append(rec)
            live.update(id(t) for t in rec[3])
            live.update(id(t) for t in rec[2])
    return keep[::-1]


def _model_device(model) -> torch.device:
    for t in model.parameters():
        return t.device
    return torch.device("cpu")


def to_onnx(model, inputs: Sequence, model_name: str = "singa_tpu",
            opset: int = _OPSET) -> PB:
    """Export `model` (a Model or layer) traced on `inputs` to a
    ModelProto.

    The inputs go to the model's device, integer ones as int64 (the
    graph's int64 inputs); the forward runs once in eval mode without a
    tape, under `autograd.ExportTrace`, and the model's mode is restored
    after. A model running NHWC inside (`set_image_layout("NHWC")`) is
    traced through a switch to NCHW (the recorded ops are ONNX's NCHW;
    weights are the same in both layouts) and switched back; its captured
    steps stay. Raises NotImplementedError when the forward computes
    with plain torch calls on a traced tensor (naming the call)."""
    dev = _model_device(model)
    inputs = [torch.as_tensor(x, device=dev) for x in inputs]
    inputs = [x.long() if not (x.is_floating_point() or x.dtype == torch.bool)
              else x for x in inputs]
    was_training, prev_flag = model.training, autograd.training
    nhwc = getattr(model, "_img_layout", None) == "NHWC"
    model.eval()
    if nhwc:  # the attribute, not set_image_layout: that drops the steps
        model._img_layout = "NCHW"
    try:
        with torch.no_grad(), autograd.ExportTrace(inputs) as trace:
            out = model.forward(*inputs)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for o in outs:
                trace.check(o, "a graph output")
    finally:
        if nhwc:
            model._img_layout = "NHWC"
        model.train(was_training)
        autograd.training = prev_flag

    from singa_tpu_torch.sonnx import from_array

    b = _Builder()
    names: Dict[int, str] = {id(x): f"input_{i}"
                             for i, x in enumerate(inputs)}
    state_names = {id(t): n for n, t in model.named_parameters()}
    state_names.update((id(t), n) for n, t in model.named_buffers())
    count = [0]

    def name_of(t: torch.Tensor) -> str:
        nm = names.get(id(t))
        if nm is not None:
            return nm
        arr = t.detach().cpu().numpy()
        if id(t) in state_names:
            nm = state_names[id(t)]
            b.initializers.append(from_array(arr, nm))
        else:  # a constant leaf (not a parameter, buffer or input)
            nm = b.const(arr, "leaf")
        names[id(t)] = nm
        return nm

    for kind, attrs, extras, op_in, op_out in _live_ops(trace.ops, outs):
        if kind is None:
            raise NotImplementedError(
                "to_onnx: the forward runs an op that carries no export "
                "metadata (an autograd op without an ONNX form, or a "
                "Function without meta)")
        in_names = [name_of(t) for t in op_in]
        extra_names = [name_of(t) for t in extras]
        out_names = []
        for t in op_out:
            count[0] += 1
            names[id(t)] = f"t{count[0]}"
            out_names.append(names[id(t)])
        _emit(b, kind, attrs, extra_names, in_names, out_names)

    g = PB("GraphProto")
    g.name = model_name
    g.node = b.nodes
    g.initializer = b.initializers
    g.input = [_value_info(f"input_{i}", x) for i, x in enumerate(inputs)]
    g.output = [_value_info(name_of(o), o) for o in outs]
    m = PB("ModelProto")
    m.ir_version = 8
    m.producer_name = "singa_tpu_torch"
    ops = PB("OperatorSetIdProto")
    ops.domain = ""
    ops.version = opset
    m.opset_import = [ops]
    m.graph = g
    return m
