"""sonnx export and import across the two packages (the port's
singa_tpu_torch.sonnx against singa_tpu.sonnx), on the CPU.

For each model of the reference's round-trip tests (`tests/test_sonnx.py`,
`tests/test_layout.py`: the MLP, CifarResNet(depth=8) in NCHW and NHWC,
bert_small with 2 layers, gpt_small, Char-RNN with an LSTM, a GRU and a
relu RNN, and the bidirectional LSTM), built by the reference from its
seed and carried into the port with `load_singa_tpu_states`:

- (a) the reference's export bytes, imported by the port, give the
  reference model's forward;
- (b) the port's export bytes, imported by the reference, give the port
  model's forward;
- (c) the port's export bytes, imported by the port, give the port
  model's forward;

within the reference tests' tolerances (MLP 1e-5; ResNet rtol 1e-3, atol
1e-4; BERT 2e-3; GPT 8e-3, the decomposed softmax's reassociation;
RNNs 2e-4). Also: both exports emit the standard ONNX nodes, the port's
initializers take the state names, and an imported CNN fine-tunes its
weights and moves no BatchNorm buffer or constant.
tests/test_torch_sonnx.py holds the export's refusals and the imported
MLP's fine-tuning against the reference's.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as ref_autograd
from singa_tpu import layer as ref_layer
from singa_tpu import model as ref_model_module
from singa_tpu import sonnx as ref_sonnx
from singa_tpu import tensor as ref_tensor
from singa_tpu.models import MLP as RefMLP
from singa_tpu.models import resnet as ref_resnet
from singa_tpu.models.gpt import gpt_small as ref_gpt_small
from singa_tpu.models.transformer import bert_small as ref_bert_small
from singa_tpu_torch import autograd, layer, model, opt, sonnx
from singa_tpu_torch.model import load_singa_tpu_states
from singa_tpu_torch.models import MLP, CifarResNet, bert_small, gpt_small
from tests.helper_torch_parity import ref_states


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    ref_autograd.training = False


class RefCharRNN(ref_model_module.Model):
    """The reference test's Char-RNN: embed -> LSTM/GRU/RNN -> head."""

    def __init__(self, vocab=32, hidden=16, cell="lstm", **rnn_kw):
        super().__init__()
        self.embed = ref_layer.Embedding(vocab, hidden)
        cls = {"lstm": ref_layer.LSTM, "gru": ref_layer.GRU,
               "rnn": ref_layer.RNN}[cell]
        self.rnn = cls(hidden, **rnn_kw)
        self.head = ref_layer.Linear(vocab)

    def forward(self, ids):
        return self.head(self.rnn(self.embed(ids)))


class CharRNN(model.Model):
    def __init__(self, vocab=32, hidden=16, cell="lstm", **rnn_kw):
        super().__init__()
        self.embed = layer.Embedding(vocab, hidden, device="cpu")
        cls = {"lstm": layer.LSTM, "gru": layer.GRU, "rnn": layer.RNN}[cell]
        self.rnn = cls(hidden, input_size=hidden, device="cpu", **rnn_kw)
        dirs = 2 if rnn_kw.get("bidirectional") else 1
        self.head = layer.Linear(vocab, in_features=hidden * dirs,
                                 device="cpu")

    def forward(self, ids):
        ids = torch.as_tensor(ids).long()
        return self.head(self.rnn(self.embed(ids)))


def _ids(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.int32)


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mlp():
    ref_tensor.set_seed(0)
    return (RefMLP(perceptron_size=16, num_classes=4),
            MLP(16, 4, in_features=8, device="cpu"),
            _images(5, (3, 8)), dict(rtol=1e-5, atol=1e-6))


def _resnet(layout):
    def make():
        ref_tensor.set_seed(0)
        r = ref_resnet.CifarResNet(depth=8, num_classes=10)
        p = CifarResNet(depth=8, num_classes=10, device="cpu")
        r.set_image_layout(layout)
        p.set_image_layout(layout)
        return r, p, _images(6, (2, 3, 16, 16)), dict(rtol=1e-3, atol=1e-4)
    return make


def _bert():
    ref_tensor.set_seed(0)
    kw = dict(num_layers=2, d_model=32, num_heads=4, max_len=16,
              dropout=0.0)
    return (ref_bert_small(**kw), bert_small(**kw, device="cpu"),
            _ids(0, (2, 16), 100), dict(rtol=2e-3, atol=2e-3))


def _gpt():
    ref_tensor.set_seed(0)
    kw = dict(dropout=0.0, max_len=16, d_model=32, num_heads=2)
    return (ref_gpt_small(**kw), gpt_small(**kw, device="cpu"),
            _ids(1, (2, 16), 255), dict(rtol=8e-3, atol=8e-3))


def _char(cell, seed=0, t=12, **kw):
    def make():
        ref_tensor.set_seed(seed)
        return (RefCharRNN(cell=cell, **kw), CharRNN(cell=cell, **kw),
                _ids(seed + 2, (2, t), 32), dict(rtol=2e-4, atol=2e-4))
    return make


CASES = {"mlp": _mlp, "resnet_nchw": _resnet("NCHW"),
         "resnet_nhwc": _resnet("NHWC"), "bert": _bert, "gpt": _gpt,
         "char_lstm": _char("lstm"), "char_gru": _char("gru"),
         "char_rnn": _char("rnn", nonlinearity="relu"),
         "bilstm": _char("lstm", seed=1, t=10, bidirectional=True)}


def _outs(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o.data) if hasattr(o, "data") and not isinstance(
        o, torch.Tensor) else o.detach().numpy() for o in outs]


@pytest.fixture(scope="module")
def built():
    """Each case's two models on the same weights, their forwards and
    both packages' export bytes, built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            ref, port, x, tol = CASES[name]()
            ref.eval()
            xr = ref_tensor.from_numpy(x)
            ref.compile([xr], is_train=False, use_graph=False)
            load_singa_tpu_states(port, ref_states(ref))
            port.eval()
            want_ref = _outs(ref.forward(xr))
            with torch.no_grad():
                want_port = _outs(port.forward(torch.from_numpy(x)))
            ref_bytes = ref_sonnx.encode_model(ref_sonnx.to_onnx(ref, [xr]))
            port_bytes = sonnx.proto.encode_model(
                sonnx.to_onnx(port, [torch.from_numpy(x)]))
            autograd.training = ref_autograd.training = False
            cache[name] = dict(x=x, tol=tol, want_ref=want_ref,
                               want_port=want_port, ref_bytes=ref_bytes,
                               port_bytes=port_bytes, port=port)
        return cache[name]

    return get


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("name", CASES)
def test_the_two_models_agree(built, name):
    c = built(name)
    _close(c["want_port"], c["want_ref"], c["tol"])


@pytest.mark.parametrize("name", CASES)
def test_a_reference_export_imported_by_the_port(built, name):
    c = built(name)
    got = sonnx.prepare(c["ref_bytes"], device="cpu").run([c["x"]])
    _close(got, c["want_ref"], c["tol"])


@pytest.mark.parametrize("name", CASES)
def test_b_port_export_imported_by_the_reference(built, name):
    c = built(name)
    got = ref_sonnx.prepare(c["port_bytes"]).run([c["x"]])
    _close([np.asarray(g) for g in got], c["want_port"], c["tol"])


@pytest.mark.parametrize("name", CASES)
def test_c_port_export_imported_by_the_port(built, name):
    c = built(name)
    got = sonnx.prepare(c["port_bytes"], device="cpu").run([c["x"]])
    _close(got, c["want_port"], c["tol"])


@pytest.mark.parametrize("name,op_type,count", [
    ("char_lstm", "LSTM", 1), ("char_gru", "GRU", 1), ("char_rnn", "RNN", 1),
    ("bilstm", "LSTM", 2), ("bert", "Softmax", 2), ("gpt", "Softmax", 2)])
def test_export_emits_the_standard_nodes(built, name, op_type, count):
    """Recurrent layers export as ONNX LSTM/GRU/RNN nodes (a bidirectional
    one as two single-direction nodes), attention as a decomposed
    Softmax per layer, as the reference's exports do."""
    for blob in (built(name)["port_bytes"], built(name)["ref_bytes"]):
        g = sonnx.proto.decode_model(blob).graph
        assert sum(n.op_type == op_type for n in g.node) == count


def test_port_export_names_initializers_by_state_names(built):
    c = built("resnet_nchw")
    g = sonnx.proto.decode_model(c["port_bytes"]).graph
    names = {i.name for i in g.initializer}
    own = {n for n, _ in c["port"].named_parameters()} | {
        n for n, _ in c["port"].named_buffers()}
    assert own <= names
    bn = [n for n in g.node if n.op_type == "BatchNormalization"]
    assert bn and all(n.input[3].endswith("running_mean")
                      and n.input[4].endswith("running_var") for n in bn)


def test_imported_resnet_fine_tunes_its_weights_only(built):
    """Fine-tuning an imported CNN moves its weights and no BatchNorm
    statistic or constant."""
    c = built("resnet_nhwc")
    m = sonnx.load(c["port_bytes"], device="cpu")
    buffers = {k: v.clone() for k, v in m.get_buffers().items()}
    consts = {k: v.clone() for k, v in m.get_consts().items()}
    params = {k: v.detach().clone() for k, v in m.get_params().items()}
    assert buffers and consts and params
    m.set_optimizer(opt.SGD(lr=0.01))
    x = torch.from_numpy(c["x"])
    y = torch.tensor([3, 7])
    m.compile([x], is_train=True, use_graph=True)
    losses = [m(x, y)[1].item() for _ in range(3)]
    assert losses[-1] < losses[0]
    assert all(torch.equal(m.get_buffers()[k], v) for k, v in buffers.items())
    assert all(torch.equal(m.get_consts()[k], v) for k, v in consts.items())
    assert all(not torch.equal(m.get_params()[k], v)
               for k, v in params.items())
