"""Port's Char-RNN (singa_tpu_torch.models.char_rnn + its trainer)
against the reference's (singa_tpu.models.char_rnn, examples/char_rnn.py)
on carried-over weights.

A reference CharRNN (vocab 16, hidden 24, embed 8, 2 LSTM layers) gets
seeded random weights, which `load_singa_tpu_params` copies into the
port. Both sides compile with `use_graph=True` and take 3 Adam(lr 1e-2)
steps through direct `train_one_batch(x, y)` calls (the reference
trainers' style, routed through each side's graph step) on one seeded
(4, 12) batch, fp32 on both sides:

- the first step's logits within 1e-5 absolute, the losses within rtol
  1e-5;
- the gradients at the carried weights (the reference's from its tape)
  within 1e-4 of each gradient's max|g|;
- after the 3 steps, every parameter within 1e-5 absolute (an Adam step
  moves a weight by ~lr; entries whose first gradient is at rounding
  level, |g| < 1e-6, take Adam's g / (|g| + eps) of rounding noise on
  both sides and are held to Adam's step size, 2 lr per step, as in
  tests/test_torch_train_gpt.py), and the Adam slots m and v within
  1e-4 of each slot's max and the step counter equal.

The port's trainer runs end to end on the CPU as
tests/test_examples_cli.py::test_char_rnn_cli runs the reference's.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu import opt as jax_opt
from singa_tpu.models.char_rnn import CharRNN as JaxCharRNN
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import autograd, opt
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models import CharRNN
from tests.helper_torch_parity import randomize_params

ROOT = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=16, hidden_size=24, embed_dim=8, num_layers=2)
LR, STEPS = 1e-2, 3


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    jax_autograd.training = False


def _batch():
    ids = np.random.default_rng(1).integers(0, 16, (4, 13))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _ref_model(weights=None):
    m = JaxCharRNN(**KW)
    m.eval()
    m(from_numpy(_batch()[0]))  # build the lazy layers
    if weights is not None:
        m.set_params(weights)
    return m


@pytest.fixture(scope="module")
def weights():
    return randomize_params(_ref_model(), 0)


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's 3 graph-mode steps: first logits, losses, the
    gradients at the carried weights, the parameters and Adam's state
    after."""
    x, y = _batch()
    m = _ref_model(weights)
    jax_autograd.training = True
    try:
        logits = m.forward(from_numpy(x))
        loss = jax_autograd.softmax_cross_entropy(
            jax_autograd.reshape(logits, (-1, 16)), y.reshape(-1))
        names = {id(t): n for n, t in m.get_params().items()}
        grads = {names[id(p)]: np.asarray(g.data)
                 for p, g in jax_autograd.backward(loss)}
    finally:
        jax_autograd.training = False
    m.set_optimizer(jax_opt.Adam(lr=LR))
    m.compile([from_numpy(x)], is_train=True, use_graph=True)
    out = [m.train_one_batch(from_numpy(x), from_numpy(y))
           for _ in range(STEPS)]
    return dict(
        logits=np.asarray(out[0][0].data),
        losses=[float(np.asarray(loss.data)) for _, loss in out],
        grads=grads,
        params={k: np.asarray(v.data) for k, v in m.get_params().items()},
        states={k: np.asarray(v) for k, v in
                m.optimizer.dump_states().items()})


@pytest.fixture(scope="module")
def port(weights):
    x, y = (torch.from_numpy(a) for a in _batch())
    m = CharRNN(**KW, device="cpu")
    load_singa_tpu_params(m, weights)
    names = {id(p): n for n, p in m.named_parameters()}
    logits = m.forward(x)
    loss = autograd.softmax_cross_entropy(logits.reshape(-1, 16),
                                          y.reshape(-1))
    grads = {names[id(p)]: g.numpy() for p, g in autograd.grad_pairs(loss)}
    m.set_optimizer(opt.Adam(lr=LR))
    m.compile([x], is_train=True, use_graph=True)
    out = [m.train_one_batch(x, y) for _ in range(STEPS)]
    assert m._train_step is not None and m._train_step.captures == 1
    return dict(
        logits=out[0][0].detach().numpy(),
        losses=[loss.item() for _, loss in out], grads=grads,
        params={k: v.detach().numpy() for k, v in m.named_parameters()},
        states={k: v.numpy() for k, v in m.optimizer.dump_states().items()})


def test_parameter_names_are_the_references(weights):
    m = CharRNN(**KW, device="cpu")
    assert sorted(n for n, _ in m.named_parameters()) == sorted(weights)


def test_first_step_logits_and_losses(reference, port):
    assert port["logits"].shape == (4, 12, 16)
    np.testing.assert_allclose(port["logits"], reference["logits"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port["losses"], reference["losses"],
                               rtol=1e-5)
    assert port["losses"][-1] < port["losses"][0]


def test_gradients_match_the_reference_tape(reference, port):
    want, got = reference["grads"], port["grads"]
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=1e-4, rtol=0, err_msg=k)


def test_parameters_and_adam_slots_after_three_steps(reference, port):
    want, got = reference["params"], port["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        noise = np.abs(port["grads"][k]) < 1e-6
        np.testing.assert_allclose(got[k][~noise], want[k][~noise],
                                   atol=1e-5, rtol=0, err_msg=k)
        if noise.any():
            assert np.abs(got[k] - want[k])[noise].max() <= 2 * LR * STEPS
    want_s, got_s = reference["states"], port["states"]
    assert sorted(got_s) == sorted(want_s)
    assert int(got_s["__step__"]) == int(want_s["__step__"]) == STEPS
    for k in want_s:
        if k == "__step__":
            continue
        scale = max(float(np.abs(want_s[k]).max()), 1e-30)
        np.testing.assert_allclose(got_s[k] / scale, want_s[k] / scale,
                                   atol=1e-4, rtol=0, err_msg=k)


def test_trainer_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.char_rnn",
         "--device", "cpu", "--steps", "6", "--hidden", "32", "--embed",
         "16", "--layers", "1", "--seq-len", "16", "--batch", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step     0  loss" in out.stdout and "step     5  loss" in \
        out.stdout
    sample = out.stdout.split("--- sample ---\n")[1]
    assert sample.startswith("the ") and sample.endswith("\n")
    assert len(sample) == len("the ") + 200 + 1
