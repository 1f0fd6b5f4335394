"""sonnx import and the protobuf codec: the port against singa_tpu.sonnx.

- The codec: the same message tree encodes to the same bytes in both
  packages (TensorProtos of every dtype the exporters write, a negative
  int64 varint, a whole exported ModelProto decoded by the port and
  encoded again); the golden hand-written wire bytes of
  `tests/test_sonnx_golden.py` decode and run; the varint edge cases.
- The importer: each hand-built graph of `tests/test_sonnx.py` (Gemm and
  Relu, Conv / BatchNormalization / MaxPool / GlobalAveragePool, the
  shape chain whose Reshape target is captured on the first run,
  attention-like MatMul / Where / Softmax, a bidirectional LSTM, GRU
  with linear_before_reset 0 and 1, and RNN) plus graphs over the other
  handlers, fed as the same bytes to both packages' `prepare`, with
  outputs within the reference test's tolerances; the refusals
  (unsupported op named, what the recurrent handlers reject).
- Export and fine-tuning: an export that would bake a tensor a plain
  torch call derived from a traced one raises, naming the call (the
  scanned GPT stack and masked attention raise; the scanned stack
  raises in the reference too); the NHWC export keeps the model's
  captured steps; an imported MLP fine-tunes like the reference's
  imported MLP (3 SGD steps on the same bytes within 1e-5); the
  `onnx_zoo` example's round trip and file import on the CPU.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as ref_autograd
from singa_tpu import opt as ref_opt
from singa_tpu import sonnx as ref_sonnx
from singa_tpu import tensor as ref_tensor
from singa_tpu.models import MLP as RefMLP
from singa_tpu.models.gpt import gpt_small as ref_gpt_small
from singa_tpu.sonnx import proto as ref_proto
from singa_tpu_torch import autograd, layer, model, opt, sonnx
from singa_tpu_torch.models import MLP, CifarResNet, bert_small, gpt_small
from singa_tpu_torch.sonnx import proto
from singa_tpu_torch.sonnx.export import _make_attr
from tests.test_sonnx_golden import (B_VALS, W_VALS, _int_field, _str_field,
                                     _tag, _vint, golden_model_bytes)


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    ref_autograd.training = False


def _ids(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.int32)


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- graph builders, in either package's PB -----------------------------------


def _graph(pb, nodes, inputs, outputs, initializers=()):
    g = pb.PB("GraphProto")
    g.name = "test"
    g.node = nodes
    g.initializer = list(initializers)
    g.input = inputs
    g.output = outputs
    m = pb.PB("ModelProto")
    m.ir_version = 8
    ops = pb.PB("OperatorSetIdProto")
    ops.domain = ""
    ops.version = 17
    m.opset_import = [ops]
    m.graph = g
    return m


def _node(op, ins, outs, **attrs):
    n = proto.PB("NodeProto")
    n.op_type = op
    n.input = list(ins)
    n.output = list(outs)
    n.attribute = [a for a in (_make_attr(k, v) for k, v in attrs.items())
                   if a is not None]
    return n


def _vi(name):
    v = proto.PB("ValueInfoProto")
    v.name = name
    return v


def _model_bytes(nodes, inputs, outputs, inits=()):
    return proto.encode_model(_graph(
        proto, nodes, [_vi(n) for n in inputs], [_vi(n) for n in outputs],
        [sonnx.from_array(a, n) for n, a in inits]))


def _both(blob, feeds, tol, n_runs=1):
    """Run `blob` in both packages on `feeds`; the port's outputs must
    equal the reference's within `tol` on every run."""
    mine = sonnx.prepare(blob, device="cpu")
    ref = ref_sonnx.prepare(blob)
    for _ in range(n_runs):
        got, want = mine.run(feeds), ref.run(feeds)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **tol)
    return got


# -- the codec ----------------------------------------------------------------


def _tree(pb, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(3, 4)) * 10).astype(dtype)
    t = pb.PB("TensorProto")
    t.dims = list(arr.shape)
    t.data_type = {np.float32: 1, np.int64: 7, np.int32: 6,
                   np.bool_: 9}[dtype]
    t.raw_data = arr.tobytes()
    t.name = "w"
    return t


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int32, np.bool_])
def test_same_tree_same_bytes_in_both_packages(dtype):
    mine = proto.encode(_tree(proto, dtype), "TensorProto")
    theirs = ref_proto.encode(_tree(ref_proto, dtype), "TensorProto")
    assert mine == theirs
    back = proto.decode(mine, "TensorProto")
    arr = sonnx.to_array(back)
    np.testing.assert_array_equal(arr, ref_sonnx.to_array(
        ref_proto.decode(theirs, "TensorProto")))
    assert back.name == "w"


def test_from_array_matches_the_reference_bytes():
    for arr in (np.array([-1, -(2 ** 40), 5], np.int64),
                np.asarray(0.5, np.float32),
                np.arange(6, dtype=np.int32).reshape(2, 3)):
        mine = proto.encode(sonnx.from_array(arr, "a"), "TensorProto")
        assert mine == ref_proto.encode(ref_sonnx.from_array(arr, "a"),
                                        "TensorProto")
        back = sonnx.to_array(proto.decode(mine, "TensorProto"))
        np.testing.assert_array_equal(back, arr)
        assert back.shape == arr.shape


def test_an_exported_model_reencodes_to_the_same_bytes():
    from singa_tpu import tensor as ref_tensor
    from singa_tpu.models import MLP as RefMLP

    ref_tensor.set_seed(0)
    m = RefMLP(perceptron_size=8, num_classes=3)
    x = ref_tensor.from_numpy(np.ones((2, 5), np.float32))
    m.compile([x], is_train=False, use_graph=False)
    blob = ref_sonnx.encode_model(ref_sonnx.to_onnx(m, [x]))
    assert proto.encode_model(proto.decode_model(blob)) == blob


def test_golden_bytes_run():
    rep = sonnx.prepare(golden_model_bytes(), device="cpu")
    x = np.array([[1.0, -2.0, 0.5, 3.0]], dtype=np.float32)
    (y,) = rep.run([x])
    np.testing.assert_allclose(y, np.maximum(x @ W_VALS + B_VALS, 0.0),
                               rtol=1e-5, atol=1e-6)


def test_golden_bytes_decode():
    g = proto.decode_model(golden_model_bytes()).graph
    assert [n.op_type for n in g.node] == ["MatMul", "Add", "Relu"]
    assert [i.name for i in g.initializer] == ["W", "B"]
    assert g.initializer[0].dims == [4, 3]
    np.testing.assert_allclose(g.initializer[1].float_data, B_VALS)
    dims = g.input[0].type.tensor_type.shape.dim
    assert [d.dim_value for d in dims] == [1, 4]
    # old-style graphs list initializers among the inputs: not fed
    assert sonnx.load(golden_model_bytes(), device="cpu")._input_names == [
        "X"]


@pytest.mark.parametrize("v", [0, 1, 127, 128, 16383, 16384, (1 << 32) - 1,
                               1 << 32, (1 << 64) - 1])
def test_varint_boundaries(v):
    got, pos = proto._read_varint(_vint(v), 0)
    assert got == v and pos == len(_vint(v))


def test_varint_errors_and_unknown_fields():
    assert proto.decode(_int_field(7, -1), "TensorProto").int64_data == [-1]
    with pytest.raises(ValueError, match="varint too long"):
        proto._read_varint(b"\x80" * 11 + b"\x01", 0)
    with pytest.raises(IndexError):
        proto._read_varint(b"\x80\x80", 0)
    buf = _tag(99, 0) + _vint(5) + _str_field(8, "ok")
    assert proto.decode(buf, "TensorProto").name == "ok"


# -- the importer: the reference test's graphs --------------------------------


def test_gemm_relu_graph():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    blob = _model_bytes(
        [_node("Gemm", ["x", "w", "b"], ["h"], alpha=1.0, beta=1.0,
               transB=0), _node("Relu", ["h"], ["y"])],
        ["x"], ["y"], [("w", w), ("b", b)])
    (out,) = _both(blob, [x], dict(rtol=1e-5))
    np.testing.assert_allclose(out, np.maximum(x @ w + b, 0), rtol=1e-5)


def test_conv_bn_pool_graph():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 2, 8, 8)).astype(np.float32)
    inits = [("w", rng.normal(size=(4, 2, 3, 3)).astype(np.float32)),
             ("g", np.abs(rng.normal(size=(4,))).astype(np.float32)),
             ("b", rng.normal(size=(4,)).astype(np.float32)),
             ("m", rng.normal(size=(4,)).astype(np.float32)),
             ("v", np.abs(rng.normal(size=(4,))).astype(np.float32) + 0.5)]
    blob = _model_bytes([
        _node("Conv", ["x", "w"], ["c"], strides=[1, 1], pads=[1, 1, 1, 1],
              kernel_shape=[3, 3]),
        _node("BatchNormalization", ["c", "g", "b", "m", "v"], ["n"],
              epsilon=1e-5),
        _node("MaxPool", ["n"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
        _node("GlobalAveragePool", ["p"], ["y"])], ["x"], ["y"], inits)
    _both(blob, [x], dict(rtol=1e-4, atol=1e-5))
    m = sonnx.load(blob, device="cpu")
    assert set(m.get_buffers()) == {"m", "v"}
    assert set(m.get_params()) == {"w", "g", "b"}


def test_shape_chain_static_capture():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape: the target is
    read on the first run and replayed on the second."""
    x = np.random.default_rng(3).normal(size=(2, 3, 4)).astype(np.float32)
    blob = _model_bytes([
        _node("Shape", ["x"], ["s"]),
        _node("Gather", ["s", "i0"], ["d0"], axis=0),
        _node("Unsqueeze", ["d0", "ax0"], ["d0u"]),
        _node("Concat", ["d0u", "negone"], ["tgt"], axis=0),
        _node("Reshape", ["x", "tgt"], ["y"])], ["x"], ["y"],
        [("i0", np.asarray(0, np.int64)), ("ax0", np.asarray([0], np.int64)),
         ("negone", np.asarray([-1], np.int64))])
    rep = sonnx.prepare(blob, device="cpu")
    (out,) = rep.run([x])
    np.testing.assert_allclose(out, x.reshape(2, -1))
    assert rep.model._recorded and rep.model._statics
    (out2,) = rep.run([x + 1])
    np.testing.assert_allclose(out2, (x + 1).reshape(2, -1))
    _both(blob, [x], dict(rtol=0, atol=0), n_runs=2)


def test_attention_like_graph():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 8)).astype(np.float32)
    k = rng.normal(size=(2, 5, 8)).astype(np.float32)
    mask = (rng.random((2, 5, 5)) > 0.3).astype(np.float32)
    blob = _model_bytes([
        _node("Transpose", ["k"], ["kt"], perm=[0, 2, 1]),
        _node("MatMul", ["q", "kt"], ["scores"]),
        _node("Cast", ["mask"], ["maskb"], to=9),
        _node("Where", ["maskb", "scores", "neg"], ["masked"]),
        _node("Softmax", ["masked"], ["y"], axis=-1)],
        ["q", "k", "mask"], ["y"], [("neg", np.asarray(-1e9, np.float32))])
    _both(blob, [q, k, mask], dict(rtol=1e-4, atol=1e-6))


T, B, IN, H = 5, 2, 3, 4


def _rnn_inputs(gates, dirs, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((T, B, IN)).astype(np.float32),
            (rng.standard_normal((dirs, gates * H, IN)) * 0.4).astype(
                np.float32),
            (rng.standard_normal((dirs, gates * H, H)) * 0.4).astype(
                np.float32),
            (rng.standard_normal((dirs, 2 * gates * H)) * 0.1).astype(
                np.float32)]


def _sig(a):
    return 1.0 / (1.0 + np.exp(-a))


def test_lstm_bidirectional_against_numpy_and_the_reference():
    feeds = _rnn_inputs(4, 2, 4)
    blob = _model_bytes([_node("LSTM", ["x", "w", "r", "b"],
                               ["y", "yh", "yc"], hidden_size=H,
                               direction="bidirectional")],
                        ["x", "w", "r", "b"], ["y", "yh", "yc"])
    y, yh, yc = _both(blob, feeds, dict(rtol=1e-5, atol=1e-5))
    assert y.shape == (T, 2, B, H) and yh.shape == (2, B, H)
    x, w, r, bb = feeds
    h, c = np.zeros((B, H)), np.zeros((B, H))
    for t in range(T):
        g = x[t] @ w[0].T + bb[0][:4 * H] + bb[0][4 * H:] + h @ r[0].T
        i, o, f, ct = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        c = _sig(f) * c + _sig(i) * np.tanh(ct)
        h = _sig(o) * np.tanh(c)
    np.testing.assert_allclose(y[-1, 0], h, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(yh[0], h, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lbr", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
def test_gru_both_reset_forms(lbr, direction):
    dirs = 2 if direction == "bidirectional" else 1
    blob = _model_bytes([_node("GRU", ["x", "w", "r", "b"], ["y", "yh"],
                               hidden_size=H, linear_before_reset=lbr,
                               direction=direction)],
                        ["x", "w", "r", "b"], ["y", "yh"])
    _both(blob, _rnn_inputs(3, dirs, 5), dict(rtol=1e-5, atol=1e-5))


def test_gru_reset_forms_differ():
    feeds = _rnn_inputs(3, 1, 5)
    outs = []
    for lbr in (0, 1):
        blob = _model_bytes([_node("GRU", ["x", "w", "r", "b"], ["y", "yh"],
                                   hidden_size=H, linear_before_reset=lbr)],
                            ["x", "w", "r", "b"], ["y", "yh"])
        outs.append(sonnx.prepare(blob, device="cpu").run(feeds)[0])
    assert not np.allclose(outs[0], outs[1])


@pytest.mark.parametrize("act", ["Tanh", "Relu"])
def test_rnn_activations(act):
    blob = _model_bytes([_node("RNN", ["x", "w", "r", "b", "", "h0"],
                               ["y", "yh"], hidden_size=H,
                               activations=[act])],
                        ["x", "w", "r", "b", "h0"], ["y", "yh"])
    feeds = _rnn_inputs(1, 1, 6) + [
        np.random.default_rng(7).normal(size=(1, B, H)).astype(np.float32)]
    _both(blob, feeds, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("attrs,match", [
    (dict(layout=1), "layout=1"), (dict(clip=1.0), "clip"),
    (dict(activations=["Relu", "Tanh", "Tanh"]), "activations")])
def test_recurrent_handlers_refuse_what_the_reference_refuses(attrs, match):
    blob = _model_bytes([_node("LSTM", ["x", "w", "r"], ["y"],
                               hidden_size=H, **attrs)],
                        ["x", "w", "r"], ["y"])
    feeds = _rnn_inputs(4, 1, 8)[:3]
    for rep in (sonnx.prepare(blob, device="cpu"), ref_sonnx.prepare(blob)):
        with pytest.raises(NotImplementedError, match=match):
            rep.run(feeds)


def test_unsupported_op_reports_name():
    blob = _model_bytes([_node("NonexistentOp", ["x"], ["y"])], ["x"], ["y"])
    rep = sonnx.prepare(blob, device="cpu")
    with pytest.raises(NotImplementedError, match="NonexistentOp"):
        rep.run([np.zeros((1,), np.float32)])


# -- the importer: the other handlers, against the reference ------------------

_X = np.random.default_rng(9).normal(size=(2, 3, 6, 6)).astype(np.float32)
_I64 = np.int64

#: (name, nodes, extra initializers): each graph maps input "x" (_X) to
#: output "y"
HANDLER_GRAPHS = [
    ("avgpool_pads", [_node("AveragePool", ["x"], ["y"],
                            kernel_shape=[3, 3], strides=[2, 2],
                            pads=[1, 1, 1, 1])], []),
    ("avgpool_count_pad", [_node("AveragePool", ["x"], ["y"],
                                 kernel_shape=[3, 3], pads=[1, 0, 1, 2],
                                 count_include_pad=1)], []),
    ("maxpool_asym", [_node("MaxPool", ["x"], ["y"], kernel_shape=[2, 3],
                            strides=[1, 2], pads=[0, 1, 1, 1])], []),
    ("conv_same_lower", [_node("Conv", ["x", "w"], ["y"], strides=[2, 2],
                               kernel_shape=[3, 3], auto_pad="SAME_LOWER")],
     [("w", np.random.default_rng(10).normal(size=(4, 3, 3, 3)).astype(
         np.float32))]),
    ("conv_group_dilated", [_node("Conv", ["x", "w", "cb"], ["y"], group=3,
                                  dilations=[2, 2], pads=[2, 1, 2, 1])],
     [("w", np.random.default_rng(11).normal(size=(6, 1, 3, 3)).astype(
         np.float32)), ("cb", np.arange(6, dtype=np.float32))]),
    ("layernorm", [_node("LayerNormalization", ["x", "g", "b"], ["y"],
                         axis=-1, epsilon=1e-5)],
     [("g", np.linspace(0.5, 1.5, 6).astype(np.float32)),
      ("b", np.linspace(-1, 1, 6).astype(np.float32))]),
    ("instancenorm", [_node("InstanceNormalization", ["x", "g", "b"], ["y"])],
     [("g", np.ones(3, np.float32) * 2), ("b", np.ones(3, np.float32))]),
    ("lrn", [_node("LRN", ["x"], ["y"], size=3, alpha=0.01)], []),
    ("unary_chain", [_node("Sigmoid", ["x"], ["a"]),
                     _node("Softplus", ["a"], ["b"]),
                     _node("LeakyRelu", ["x"], ["c"], alpha=0.1),
                     _node("Elu", ["c"], ["d"]),
                     _node("HardSigmoid", ["d"], ["e"]),
                     _node("Sum", ["b", "e", "x"], ["y"])], []),
    ("gelu_both", [_node("Gelu", ["x"], ["a"]),
                   _node("Gelu", ["x"], ["b"], approximate="tanh"),
                   _node("Sub", ["a", "b"], ["y"])], []),
    ("clip_inputs", [_node("Clip", ["x", "lo", "hi"], ["y"])],
     [("lo", np.asarray(-0.5, np.float32)),
      ("hi", np.asarray(0.25, np.float32))]),
    ("slice_neg_step", [_node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
     [("st", np.asarray([5, 0], _I64)), ("en", np.asarray([-7, 3], _I64)),
      ("ax", np.asarray([3, 1], _I64)), ("sp", np.asarray([-2, 1], _I64))]),
    ("pad_reflect", [_node("Pad", ["x", "pads"], ["y"], mode="reflect")],
     [("pads", np.asarray([0, 0, 1, 2, 0, 0, 2, 1], _I64))]),
    ("pad_edge_const", [_node("Pad", ["x", "pads"], ["a"], mode="edge"),
                        _node("Pad", ["a", "pads", "cv"], ["y"])],
     [("pads", np.asarray([0, 0, 1, 0, 0, 1, 0, 1], _I64)),
      ("cv", np.asarray(2.5, np.float32))]),
    ("split_concat", [_node("Split", ["x"], ["a", "b", "c"], axis=2),
                      _node("Concat", ["c", "a", "b"], ["y"], axis=2)], []),
    ("split_sizes", [_node("Split", ["x", "sz"], ["a", "b"], axis=3),
                     _node("Mul", ["a", "a"], ["aa"]),
                     _node("ReduceSum", ["aa", "ax"], ["s"], keepdims=1),
                     _node("Add", ["s", "b"], ["y"])],
     [("sz", np.asarray([1, 5], _I64)), ("ax", np.asarray([3], _I64))]),
    ("reductions", [_node("ReduceMean", ["x"], ["a"], axes=[1, 2],
                          keepdims=0),
                    _node("ReduceMax", ["x"], ["b"], axes=[1, 2],
                          keepdims=0),
                    _node("ReduceL2", ["x"], ["c"], axes=[1, 2], keepdims=0),
                    _node("ReduceProd", ["x"], ["d"], axes=[1], keepdims=0),
                    _node("ReduceMin", ["d"], ["e"], axes=[1], keepdims=0),
                    _node("Sum", ["a", "b", "c", "e"], ["y"])], []),
    ("argmax_gather", [_node("ArgMax", ["x"], ["i"], axis=3, keepdims=0),
                       _node("GatherElements", ["x", "i4"], ["g"], axis=3),
                       _node("Flatten", ["g"], ["f"], axis=2),
                       _node("Gather", ["f", "gi"], ["y"], axis=1)],
     [("i4", np.asarray([[[[1, -1, 0]]]], _I64) * np.ones(
         (2, 3, 6, 1), _I64)),
      ("gi", np.asarray([[0, -1], [2, 1]], _I64))]),
    ("expand_tile", [_node("ReduceMean", ["x"], ["m"], axes=[3],
                           keepdims=1),
                     _node("Expand", ["m", "shp"], ["e"]),
                     _node("Tile", ["e", "reps"], ["y"])],
     [("shp", np.asarray([1, 1, 6, 3], _I64)),
      ("reps", np.asarray([1, 2, 1, 1], _I64))]),
    ("shape_const_range", [_node("Shape", ["x"], ["s"], start=2),
                           _node("ReduceProd", ["s"], ["n"], keepdims=0),
                           _node("Cast", ["n"], ["nf"], to=1),
                           _node("Constant", [], ["c"],
                                 value=np.asarray([1.5, 2.0], np.float32)),
                           _node("Range", ["z", "lim", "one"], ["r"]),
                           _node("Cast", ["r"], ["rf"], to=1),
                           _node("ConstantOfShape", ["cs"], ["k"],
                                 value=np.asarray([3.0], np.float32)),
                           _node("Mul", ["x", "nf"], ["a"]),
                           _node("Add", ["a", "rf"], ["b"]),
                           _node("Mul", ["b", "k"], ["y"])],
     [("z", np.asarray(0, _I64)), ("lim", np.asarray(6, _I64)),
      ("one", np.asarray(1, _I64)), ("cs", np.asarray([6], _I64))]),
    ("squeeze_unsqueeze_transpose", [
        _node("ReduceMean", ["x"], ["m"], axes=[1], keepdims=1),
        _node("Squeeze", ["m", "ax1"], ["s"]),
        _node("Unsqueeze", ["s", "ax02"], ["u"]),
        _node("Transpose", ["u"], ["y"], perm=[3, 1, 0, 2, 4])],
     [("ax1", np.asarray([1], _I64)), ("ax02", np.asarray([0, -1], _I64))]),
    ("softmax_logsoftmax_where", [
        _node("Softmax", ["x"], ["p"], axis=1),
        _node("LogSoftmax", ["x"], ["lp"], axis=1),
        _node("Greater", ["x", "zero"], ["pos"]),
        _node("Where", ["pos", "p", "lp"], ["y"])],
     [("zero", np.asarray(0.0, np.float32))]),
    ("trilu_einsum", [_node("Trilu", ["x", "k"], ["t"], upper=0),
                      _node("Einsum", ["t", "x"], ["y"],
                            equation="bchw,bcwv->bchv")],
     [("k", np.asarray(1, _I64))]),
]


@pytest.mark.parametrize("name,nodes,inits", HANDLER_GRAPHS,
                         ids=[g[0] for g in HANDLER_GRAPHS])
def test_handler_graph_matches_the_reference(name, nodes, inits):
    blob = _model_bytes(nodes, ["x"], ["y"], inits)
    _both(blob, [_X], dict(rtol=1e-5, atol=1e-5), n_runs=2)


def test_onehot_and_prelu():
    """OneHot and a trainable PRelu slope. A negative index counts from
    the end, as ONNX's OneHot says; the reference's `jax.nn.one_hot`
    gives it an all-off row, so it is held apart from the reference."""
    blob = _model_bytes([_node("OneHot", ["idx", "depth", "vals"], ["o"],
                               axis=1),
                         _node("PRelu", ["o", "slope"], ["y"])],
                        ["idx"], ["y"],
                        [("depth", np.asarray(4, np.int64)),
                         ("vals", np.asarray([-1.0, 2.0], np.float32)),
                         ("slope", np.asarray(0.25, np.float32))])
    _both(blob, [np.asarray([[0, 3], [1, 2]], np.int64)],
          dict(rtol=0, atol=0))
    (y,) = sonnx.prepare(blob, device="cpu").run(
        [np.asarray([[-1, 0]], np.int64)])
    want = np.full((1, 4, 2), -0.25, np.float32)
    want[0, 3, 0] = want[0, 0, 1] = 2.0
    np.testing.assert_array_equal(y, want)
    # a float initializer of more than one element trains; so does a
    # PRelu slope of one (the reference's rule)
    assert set(sonnx.load(blob, device="cpu").get_params()) == {
        "slope", "vals"}
    assert set(ref_sonnx.load(blob).get_params()) == {"slope", "vals"}


# -- export refusals, fine-tuning, the example --------------------------------


class _Doubling(model.Model):
    def __init__(self):
        super().__init__()
        self.fc1 = layer.Linear(4, in_features=4, device="cpu")
        self.fc2 = layer.Linear(2, in_features=4, device="cpu")

    def forward(self, x):
        return self.fc2(self.fc1(x) * 2.0)  # a raw torch call


def test_export_refuses_a_derived_tensor_naming_the_torch_call():
    with pytest.raises(NotImplementedError, match=r"Tensor\.(__)?mul"):
        sonnx.to_onnx(_Doubling(), [torch.ones(3, 4)])


def test_export_refuses_a_derived_graph_output():
    class Out(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(2, in_features=4, device="cpu")

        def forward(self, x):
            return self.fc(x).exp()

    with pytest.raises(NotImplementedError, match=r"Tensor\.exp"):
        sonnx.to_onnx(Out(), [torch.ones(3, 4)])


def test_scanned_gpt_stack_raises_in_both_packages():
    """The scanned stack carries no export metadata in the reference, and
    computes with plain torch calls in the port: both refuse it."""
    kw = dict(dropout=0.0, max_len=16, d_model=32, num_heads=2,
              scan_blocks=True)
    ids = _ids(1, (2, 16), 255)
    with pytest.raises(NotImplementedError, match="made outside a recorded"):
        sonnx.to_onnx(gpt_small(**kw, device="cpu"), [torch.from_numpy(ids)])
    ref = ref_gpt_small(**kw)
    ref.eval()
    xr = ref_tensor.from_numpy(ids)
    ref.forward(xr)
    with pytest.raises(NotImplementedError, match="no export metadata"):
        ref_sonnx.to_onnx(ref, [xr])


def test_masked_attention_raises():
    m = bert_small(num_layers=1, d_model=32, num_heads=4, max_len=16,
                   dropout=0.0, device="cpu")
    mask = torch.ones(2, 1, 1, 16, dtype=torch.bool)

    class Masked(model.Model):
        def __init__(self):
            super().__init__()
            self.bert = m

        def forward(self, ids):
            return self.bert(ids, mask=mask)[1]

    with pytest.raises(NotImplementedError, match="made outside"):
        sonnx.to_onnx(Masked(), [torch.from_numpy(_ids(0, (2, 16), 100))])


def test_nhwc_export_keeps_the_captured_steps_and_the_layout():
    m = CifarResNet(depth=8, num_classes=10, device="cpu")
    m.set_image_layout("NHWC")
    m.set_optimizer(opt.SGD(lr=0.01))
    x = torch.from_numpy(_images(6, (2, 3, 16, 16)))
    y = torch.tensor([1, 2])
    m.compile([x], is_train=True, use_graph=True)
    m(x, y)
    step = m._train_step
    assert step is not None
    sonnx.to_onnx(m, [x])
    assert m._train_step is step and m._img_layout == "NHWC"
    assert m.training and autograd.training


def test_imported_mlp_fine_tunes_like_the_reference():
    """The same ONNX bytes (the reference's export of its MLP), loaded by
    both packages: 3 SGD steps give the same losses and parameters, by
    ONNX name, within 1e-5."""
    ref_tensor.set_seed(0)
    src = RefMLP(perceptron_size=16, num_classes=4)
    x = _images(7, (8, 6))
    xr = ref_tensor.from_numpy(x)
    src.compile([xr], is_train=False, use_graph=False)
    blob = ref_sonnx.encode_model(ref_sonnx.to_onnx(src, [xr]))
    y = (np.arange(8) % 4).astype(np.int32)

    ref = ref_sonnx.load(blob)
    ref.set_optimizer(ref_opt.SGD(lr=0.1))
    ref.train(True)
    port = sonnx.load(blob, device="cpu")
    port.set_optimizer(opt.SGD(lr=0.1))
    port.train(True)
    assert set(port.get_params()) == set(ref.get_params()) == {
        "fc1.W", "fc1.b", "fc2.W", "fc2.b"}
    yr = ref_tensor.from_numpy(y)
    for _ in range(3):
        _, ref_loss = ref.train_one_batch(xr, yr)
        _, loss = port.train_one_batch(torch.from_numpy(x),
                                       torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), float(ref_loss.data),
                                   rtol=1e-5)
    for k, v in ref.get_params().items():
        np.testing.assert_allclose(port.get_params()[k].detach().numpy(),
                                   np.asarray(v.data), atol=1e-5)


def test_onnx_zoo_round_trip_on_the_cpu(capsys):
    """The example's default path: the port's ResNet-50 exported,
    imported and run twice, held to the source's forward."""
    from singa_tpu_torch.examples import onnx_zoo

    onnx_zoo.main(["--device", "cpu", "--batch", "2"])
    out = capsys.readouterr().out
    assert "round-trip outputs match the source model" in out
    assert "(176 nodes)" in out and "output shapes [(2, 1000)]" in out


def test_onnx_zoo_imports_a_file(capsys, tmp_path):
    from singa_tpu_torch.examples import onnx_zoo

    path = str(tmp_path / "mlp.onnx")
    sonnx.save(sonnx.to_onnx(MLP(16, 4, in_features=8, device="cpu"),
                             [torch.ones(3, 8)]), path)
    onnx_zoo.main(["--device", "cpu", "--model", path])
    out = capsys.readouterr().out
    assert "inputs: [('input_0', [3, 8])]" in out
    assert "output shapes [(3, 4)]" in out
