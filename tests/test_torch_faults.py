"""The port's repaired faults (ROADMAP queue 3), each on the reference's
own construction, arguments or input, run on both packages.

- F3: the layer constructors take the reference's positional arguments,
  output widths only, and infer the input width at the first call. The
  reference's layer-test constructions (`tests/test_layer_model.py:23,
  49, 176, 179`) and the re-anchor's three cases give equal shapes,
  parameter names and counts, and, after carrying the reference's
  weights over, outputs within 1e-5.
- Item 7's state API: `get_params` / `set_params` / `get_states`, and a
  `Model.save_states` file crossed between the packages both ways.
- F4: the reference CLI test's `serve_gpt` argument lists
  (`tests/test_examples_cli.py:58, 70, 86, 108`) run on the port;
  `gpt_lm --save-every` beside `--checkpoint` commits a checkpoint at
  the cadence.
- F5: a label outside [0, C) adds 0 to the cross-entropy's sum and
  still counts in its mean (0.77304 on the re-anchor's input, 1e-6).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from singa_tpu import autograd as ref_autograd
from singa_tpu import layer as ref_layer
from singa_tpu import model as ref_model_module
from singa_tpu import opt as ref_opt
from singa_tpu import tensor
from singa_tpu.models import MLP as RefMLP
from singa_tpu_torch import autograd, layer, model, opt
from singa_tpu_torch.examples import gpt_lm, serve_gpt
from singa_tpu_torch.models import MLP
from tests.helper_torch_parity import rand, randomize_params

TOL = 1e-5


class _RefBNNet(ref_model_module.Model):
    """tests/test_layer_model.py:172-186."""

    def __init__(self):
        super().__init__()
        self.conv = ref_layer.Conv2d(4, 3, padding=1)
        self.bn = ref_layer.BatchNorm2d()
        self.flat = ref_layer.Flatten()
        self.fc = ref_layer.Linear(2)

    def forward(self, x):
        return self.fc(self.flat(ref_autograd.relu(self.bn(self.conv(x)))))


class _BNNet(model.Model):
    def __init__(self):
        super().__init__()
        self.conv = layer.Conv2d(4, 3, padding=1, device="cpu")
        self.bn = layer.BatchNorm2d(device="cpu")
        self.flat = layer.Flatten()
        self.fc = layer.Linear(2, device="cpu")

    def forward(self, x):
        return self.fc(self.flat(autograd.relu(self.bn(self.conv(x)))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


def _seq(pkg):
    kw = {} if pkg is ref_layer else {"device": "cpu"}
    return pkg.Sequential(pkg.Conv2d(8, 3, padding=1, **kw),
                          pkg.BatchNorm2d(**kw), pkg.ReLU(),
                          pkg.MaxPool2d(2, 2))


def _pair(pkg, name):
    kw = {} if pkg is ref_layer else {"device": "cpu"}
    return {
        "linear_lazy": lambda: pkg.Linear(8, **kw),  # :23
        "linear_10": lambda: pkg.Linear(10, **kw),
        "conv_bn_pool_stack": lambda: _seq(pkg),  # :49
        "bn_net": lambda: _RefBNNet() if pkg is ref_layer else _BNNet(),
        "conv_32_3_1": lambda: pkg.Conv2d(32, 3, 1, **kw),
        "lstm_64_2": lambda: pkg.LSTM(64, 2, **kw),
    }[name]()


CASES = {  # name -> input shape
    "linear_lazy": (2, 5),
    "linear_10": (3, 7),
    "conv_bn_pool_stack": (2, 3, 8, 8),
    "bn_net": (8, 3, 6, 6),
    "conv_32_3_1": (1, 32, 8, 8),
    "lstm_64_2": (3, 4, 64),
}
SHAPES = {"linear_lazy": (2, 8), "conv_bn_pool_stack": (2, 8, 4, 4),
          "conv_32_3_1": (1, 32, 6, 6), "lstm_64_2": (3, 4, 64)}


def _ref_eval(lyr):
    """Eval mode through a reference layer tree (only `Model.train`
    walks it there)."""
    if hasattr(lyr, "training"):
        lyr.training = False
    for _, child in lyr._direct_children():
        _ref_eval(child)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_constructions_build_the_same_layer(name):
    x = rand(CASES[name], 1)
    ref, port = _pair(ref_layer, name), _pair(layer, name)
    _ref_eval(ref)
    port.eval()
    before = set(port.get_params())  # biases only: no input width yet
    y_ref = np.asarray(ref(tensor.from_numpy(x)).data)
    y = port(torch.from_numpy(x))
    assert tuple(y.shape) == y_ref.shape
    if name in SHAPES:
        assert tuple(y.shape) == SHAPES[name]
    want = {k: tuple(v.shape) for k, v in ref.get_params().items()}
    got = {k: tuple(v.shape) for k, v in port.get_params().items()}
    assert got == want and before < set(got)
    assert sum(np.prod(s) for s in got.values()) == sum(
        np.prod(s) for s in want.values())
    if name == "lstm_64_2":  # hidden 64, 2 layers
        assert sum(np.prod(s) for s in got.values()) == 66048
    params = randomize_params(ref, 2)
    port.set_params(params)
    buffers = {k: np.asarray(v.data) for k, v in ref.get_buffers().items()}
    port.set_states(buffers)
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref(tensor.from_numpy(x)).data), rtol=TOL, atol=TOL)


def test_the_input_width_keyword_builds_at_once():
    lin = layer.Linear(10, in_features=4, device="cpu")
    assert tuple(lin.W.shape) == (4, 10) and tuple(lin.b.shape) == (10,)
    conv = layer.Conv2d(32, 3, 1, in_channels=8, device="cpu")
    assert tuple(conv.W.shape) == (32, 8, 3, 3)
    lstm = layer.LSTM(2, input_size=64, device="cpu")
    assert tuple(lstm.w_ih_l0.shape) == (64, 8)
    bn = layer.BatchNorm2d(num_features=6, device="cpu")
    assert tuple(bn.running_var.shape) == (6,)
    tp = layer.Linear(4, tp_axis="model", in_features=6, device="cpu")
    assert tp.W.pspec == (None, "model") and tuple(tp.W.shape) == (6, 4)
    with pytest.raises(ValueError, match="tp_mode"):
        layer.Linear(4, tp_axis="model", tp_mode="diagonal", device="cpu")


def test_widths_exist_before_the_optimizer_names_its_slots():
    """A lazy model's `set_optimizer` before `compile` names the slots
    after compile's forward has made the parameters."""
    m = _BNNet()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    x = torch.from_numpy(rand((8, 3, 6, 6), 3))
    m.compile([x], is_train=True, use_graph=True)
    names = {k.partition("//")[0] for k in m.optimizer.dump_states()
             if "//" in k}
    assert names == set(m.get_params())
    _, loss = m(x, torch.zeros(8, dtype=torch.long))
    assert torch.isfinite(loss)


def test_state_api_matches_the_reference():
    m = MLP(perceptron_size=5, num_classes=2, in_features=None,
            device="cpu")
    m.compile([torch.ones(1, 3)], is_train=False)
    assert set(m.get_params()) == {"fc1.W", "fc1.b", "fc2.W", "fc2.b"}
    new_w = np.full((3, 5), 0.5, np.float32)
    m.set_params({"fc1.W": new_w})
    np.testing.assert_array_equal(
        m.get_params()["fc1.W"].detach().numpy(), new_w)
    with pytest.raises(KeyError):
        m.set_params({"nope": new_w})
    with pytest.raises(ValueError, match="shape"):
        m.set_params({"fc1.W": new_w.T})
    bn = _BNNet()
    bn(torch.ones(2, 3, 6, 6))
    assert set(bn.get_buffers()) == {"bn.running_mean", "bn.running_var"}
    assert set(bn.get_states()) == set(bn.get_params()) | set(
        bn.get_buffers())


def _ref_trained_mlp(X, y):
    m = RefMLP(perceptron_size=9, num_classes=2)
    m.set_optimizer(ref_opt.SGD(lr=0.2))
    tx, ty = tensor.from_numpy(X), tensor.from_numpy(y)
    m.compile([tx], is_train=True)
    m(tx, ty)
    return m


def test_save_states_crosses_between_the_packages(tmp_path):
    """tests/test_layer_model.py:245's round trip, across packages: a
    file the reference saved loads into the port, and one the port saved
    loads into the reference, aux states included."""
    rng = np.random.RandomState(0)
    X = rng.randn(32, 6).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32)
    ref = _ref_trained_mlp(X, y)
    f_ref = str(tmp_path / "ref.zip")
    ref.save_states(f_ref, aux_states={"epoch": np.asarray(3)})
    port = MLP(perceptron_size=9, num_classes=2, in_features=6,
               device="cpu")
    aux = port.load_states(f_ref)
    assert int(aux["epoch"]) == 3
    ref_states = {k: np.asarray(v.data) for k, v in ref.get_states().items()}
    for k, v in port.get_states().items():
        np.testing.assert_array_equal(v.detach().numpy(), ref_states[k])
    ref.eval()
    port.eval()
    tx = torch.from_numpy(X)
    np.testing.assert_allclose(port(tx).detach().numpy(),
                               np.asarray(ref(tensor.from_numpy(X)).data),
                               rtol=TOL, atol=TOL)

    with torch.no_grad():
        port.fc2.W.mul_(2.0)
    f_port = str(tmp_path / "port.zip")
    port.save_states(f_port, aux_states={"step": torch.tensor(7)})
    back = RefMLP(perceptron_size=9, num_classes=2)
    back.compile([tensor.from_numpy(X)], is_train=False)
    aux = back.load_states(f_port)
    assert int(aux["step"]) == 7
    for k, v in back.get_states().items():
        np.testing.assert_array_equal(
            np.asarray(v.data), port.get_states()[k].detach().numpy())


def _serve(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_gpt.main([*argv, "--device", "cpu"])
    return buf.getvalue()


SERVE_ARGS = {  # tests/test_examples_cli.py
    58: ["--steps", "0", "--requests", "3", "--slots", "2", "--max-new",
         "8", "--d-model", "48", "--window", "32"],
    70: ["--steps", "0", "--requests", "3", "--slots", "2", "--max-new",
         "8", "--d-model", "48", "--window", "32", "--draft", "self",
         "--spec-k", "3", "--kv-dtype", "int8"],
    86: ["--steps", "0", "--requests", "3", "--slots", "2", "--max-new",
         "6", "--d-model", "48", "--window", "64", "--sched", "chunked",
         "--chunk-budget", "1", "--priority", "high,background",
         "--tenant", "a,b"],
    108: ["--steps", "0", "--requests", "6", "--slots", "2", "--max-new",
          "8", "--d-model", "48", "--window", "32", "--seed", "5",
          "--replicas", "2"],
}


@pytest.mark.parametrize("line", sorted(SERVE_ARGS))
def test_serve_gpt_takes_the_reference_cli_arguments(line):
    out = _serve(SERVE_ARGS[line])
    n = 6 if line == 108 else 3
    assert f"served {n}/{n} requests" in out
    assert ("decode executables: 1,1" if line == 108
            else "decode executables: 1") in out


def test_serve_gpt_pretrains_on_a_corpus_then_serves(tmp_path):
    """--data, --steps and --lr: AdamW on the corpus, the loss falls;
    --scan-blocks serves the scanned decoder the same way."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("abcabcabd " * 200)
    out = _serve(["--data", str(corpus), "--steps", "10", "--lr", "1e-2",
                  "--requests", "2", "--max-new", "4", "--d-model", "32",
                  "--window", "32"])
    assert "corpus: 2000 chars, vocab 5" in out
    losses = [float(l.rsplit(" ", 1)[1]) for l in out.splitlines()
              if l.startswith("train step")]
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert "served 2/2 requests" in out
    out = _serve(["--scan-blocks", "--steps", "2", "--requests", "1",
                  "--max-new", "4", "--d-model", "32", "--window", "32"])
    assert "served 1/1 requests" in out


def test_gpt_lm_save_every_raises_naming_item_17(tmp_path):
    """`--save-every` is ported (ROADMAP item 17): beside `--checkpoint`
    it commits a checkpoint every N steps, the newest two kept; alone it
    writes nothing, as the reference's."""
    from singa_tpu_torch import resilience, storage

    d = str(tmp_path / "ck")
    small = ["--device", "cpu", "--batch", "2", "--seq", "16", "--d-model",
             "16", "--heads", "2", "--sample-chars", "0", "--steps", "6"]
    gpt_lm.main(small + ["--save-every", "2", "--checkpoint", d])
    assert storage.get_driver(d).list(d) == [
        "LATEST", "step-00000004", "step-00000006"]
    manifest, _ = resilience.read_manifest(d)
    assert manifest["step"] == 6 and manifest["meta"] is None
    gpt_lm.main(small[:-1] + ["1", "--save-every", "1"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]


def test_cross_entropy_ignores_labels_outside_the_classes():
    logits = np.random.default_rng(0).standard_normal((4, 5)).astype(
        np.float32)
    labels = np.array([1, -1, 3, 5])
    want = ref_autograd.softmax_cross_entropy(
        tensor.from_numpy(logits), tensor.from_numpy(labels.astype(
            np.int32)))
    t = torch.from_numpy(logits).requires_grad_()
    got = autograd.softmax_cross_entropy(t, torch.from_numpy(labels))
    assert abs(float(np.asarray(want.data)) - 0.77304) < 1e-5
    np.testing.assert_allclose(got.item(), float(np.asarray(want.data)),
                               rtol=0, atol=1e-6)
    (g,) = torch.autograd.grad(got, t)
    ref_t = tensor.from_numpy(logits)
    ref_t.requires_grad = True
    ref_t.stores_grad = True
    ref_autograd.training = True
    loss = ref_autograd.softmax_cross_entropy(ref_t, tensor.from_numpy(
        labels.astype(np.int32)))
    ref_g = dict((id(p), gg) for p, gg in ref_autograd.grad_pairs(loss))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g[id(ref_t)].data),
                               rtol=TOL, atol=1e-7)
    assert np.all(g.numpy()[[1, 3]] == 0)  # the ignored rows
