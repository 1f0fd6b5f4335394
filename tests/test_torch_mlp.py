"""Port's MLP, its trainer and data helpers (singa_tpu_torch.models.mlp,
examples/mlp_mnist.py, utils/data.py, tensor.py) against the reference's
(singa_tpu.models.mlp, examples/mlp_mnist.py), on the CPU.

The reference MLP (784 -> 100 -> 10 on seeded weights, carried into the
port with `load_singa_tpu_params`), both with dropout rate 0 (the two
packages draw their masks differently by design), on one seeded batch of
64 synthetic MNIST images:

- the logits and the loss within 1e-5, the gradients at the carried
  weights within 1e-5 of each gradient's max|g|;
- 3 eager SGD(lr 0.05, momentum 0.9, weight decay 1e-5) steps, the
  judged mode (`compile(..., use_graph=False)`): the losses within rtol
  1e-5, every parameter and momentum slot within 1e-5;
- `device_batches` gives the reference's batch order, `load_mnist`'s
  synthetic fallback the reference's arrays, and `from_numpy`,
  `to_numpy` and `argmax` the reference's values;
- the trainer runs at `--device cpu --epochs 1 --batch 32`.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as ref_autograd
from singa_tpu import opt as ref_opt
from singa_tpu import tensor as ref_tensor
from singa_tpu.models import MLP as RefMLP
from singa_tpu.utils import data as ref_data
from singa_tpu_torch import autograd, opt, tensor
from singa_tpu_torch.examples import mlp_mnist
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models import MLP
from singa_tpu_torch.utils import data

LR, STEPS, BATCH = 0.05, 3, 64


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    ref_autograd.training = False


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """The synthetic MNIST set of both packages (no MNIST files under
    the data directory)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SINGA_DATA_DIR", str(tmp_path_factory.mktemp("no_mnist")))
    try:
        yield data.load_mnist(), ref_data.load_mnist()
    finally:
        mp.undo()


def _batch(mnist):
    xt, yt = mnist[0][:2]
    return xt[:BATCH], yt[:BATCH]


def _ref_model(x):
    ref_tensor.set_seed(0)
    m = RefMLP(perceptron_size=100, num_classes=10)
    m.dropout.p = 0.0
    m.eval()
    m(ref_tensor.from_numpy(x))  # build the lazy layers
    return m


@pytest.fixture(scope="module")
def reference(mnist):
    x, y = _batch(mnist)
    m = _ref_model(x)
    params0 = {k: np.asarray(v.data) for k, v in m.get_params().items()}
    ref_autograd.training = True
    try:
        logits = m.forward(ref_tensor.from_numpy(x))
        loss = ref_autograd.softmax_cross_entropy(logits, y)
        names = {id(t): n for n, t in m.get_params().items()}
        grads = {names[id(p)]: np.asarray(g.data)
                 for p, g in ref_autograd.backward(loss)}
    finally:
        ref_autograd.training = False
    m.set_optimizer(ref_opt.SGD(lr=LR, momentum=0.9, weight_decay=1e-5))
    xr, yr = ref_tensor.from_numpy(x), ref_tensor.from_numpy(y)
    m.compile([xr], is_train=True, use_graph=False)
    losses = [float(np.asarray(m(xr, yr)[1].data)) for _ in range(STEPS)]
    names = {id(t): n for n, t in m.get_params().items()}
    momenta = {names[pid]: np.asarray(s["momentum"])
               for pid, s in m.optimizer._slots.items()}
    return dict(params0=params0, logits=np.asarray(logits.data),
                loss=float(np.asarray(loss.data)), grads=grads,
                losses=losses, momenta=momenta,
                params={k: np.asarray(v.data)
                        for k, v in m.get_params().items()})


@pytest.fixture(scope="module")
def port(mnist, reference):
    x, y = (torch.from_numpy(a) for a in _batch(mnist))
    m = MLP(100, 10, device="cpu")
    m.dropout.p = 0.0
    load_singa_tpu_params(m, reference["params0"])
    autograd.training = True
    try:
        logits = m.forward(x)
        loss = autograd.softmax_cross_entropy(logits, y)
        names = {id(p): n for n, p in m.named_parameters()}
        grads = {names[id(p)]: g.numpy()
                 for p, g in autograd.grad_pairs(loss)}
    finally:
        autograd.training = False
    m.set_optimizer(opt.SGD(lr=LR, momentum=0.9, weight_decay=1e-5))
    m.compile([x], is_train=True, use_graph=False)
    losses = [m(x, y)[1].item() for _ in range(STEPS)]
    assert m._train_step is None  # eager: no graph step was made
    states = m.optimizer.dump_states()
    return dict(logits=logits.detach().numpy(), loss=loss.item(),
                grads=grads, losses=losses,
                momenta={k.split("//")[0]: v.numpy()
                         for k, v in states.items() if k != "__step__"},
                params={k: v.detach().numpy()
                        for k, v in m.named_parameters()})


def test_parameter_names_are_the_references(reference):
    m = MLP(100, 10, device="cpu")
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == {
        k: v.shape for k, v in reference["params0"].items()}


def test_logits_and_loss(reference, port):
    assert port["logits"].shape == (BATCH, 10)
    np.testing.assert_allclose(port["logits"], reference["logits"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port["loss"], reference["loss"], rtol=1e-5)


def test_gradients(reference, port):
    assert sorted(port["grads"]) == sorted(reference["grads"])
    for k, want in reference["grads"].items():
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(port["grads"][k] / scale, want / scale,
                                   atol=1e-5, err_msg=k)


def test_three_eager_sgd_steps(reference, port):
    np.testing.assert_allclose(port["losses"], reference["losses"],
                               rtol=1e-5)
    assert port["losses"][-1] < port["losses"][0]
    for k, want in reference["params"].items():
        np.testing.assert_allclose(port["params"][k], want, atol=1e-5,
                                   err_msg=k)
    assert sorted(port["momenta"]) == sorted(reference["momenta"])
    for k, want in reference["momenta"].items():
        np.testing.assert_allclose(port["momenta"][k], want, atol=1e-5,
                                   err_msg=k)


def test_load_mnist_synthetic_fallback_is_the_references(mnist):
    mine, ref = mnist
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert mine[0].shape == (4096, 784) and mine[2].shape == (512, 784)


def test_load_mnist_unflattened(monkeypatch, tmp_path):
    monkeypatch.setenv("SINGA_DATA_DIR", str(tmp_path))
    mine = data.load_mnist(n_train=100, n_val=10, flatten=False)
    ref = ref_data.load_mnist(n_train=100, n_val=10, flatten=False)
    assert mine[0].shape == (100, 1, 28, 28)
    assert mine[2].shape == (10, 1, 28, 28)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True),
                                               (True, False)])
def test_device_batches_order_is_the_references(shuffle, drop_last):
    x = np.arange(70 * 3, dtype=np.float32).reshape(70, 3)
    y = np.arange(70, dtype=np.int32)
    mine = list(data.device_batches(torch.from_numpy(x), torch.from_numpy(y),
                                    16, shuffle=shuffle, seed=3,
                                    drop_last=drop_last))
    ref = list(ref_data.device_batches(
        ref_tensor.from_numpy(x), ref_tensor.from_numpy(y), 16,
        shuffle=shuffle, seed=3, drop_last=drop_last))
    assert len(mine) == len(ref) == (4 if drop_last else 5)
    for (bx, by), (rx, ry) in zip(mine, ref):
        np.testing.assert_array_equal(bx.numpy(), np.asarray(rx.data))
        np.testing.assert_array_equal(by.numpy(), np.asarray(ry.data))


def test_tensor_helpers_match_the_reference():
    a = np.random.default_rng(2).normal(size=(4, 5))  # float64
    t = tensor.from_numpy(a, "cpu")
    r = ref_tensor.from_numpy(a)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(tensor.to_numpy(t),
                                  ref_tensor.to_numpy(r))
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(
            tensor.to_numpy(tensor.argmax(t, axis=axis)),
            ref_tensor.to_numpy(ref_tensor.argmax(r, axis=axis)))
    ids = tensor.from_numpy(np.arange(3, dtype=np.int64), "cpu")
    assert ids.dtype == torch.int64


def test_trainer_cli_on_the_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("SINGA_DATA_DIR", str(tmp_path))
    mlp_mnist.main(["--device", "cpu", "--epochs", "1", "--batch", "32"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "train (4096, 784), val (512, 784)" in out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("epoch 0:")]
    loss = float(line.split("loss ")[1].split()[0])
    acc = float(line.split("val_acc ")[1].split()[0])
    # at batch 32 and lr 0.05 the synthetic set trains unevenly in both
    # packages (the reference's own CLI test checks only that it runs)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
