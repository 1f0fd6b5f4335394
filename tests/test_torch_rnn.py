"""Port's recurrent layers (singa_tpu_torch.layer RNN, LSTM, GRU,
CudnnRNN over the autograd recurrent ops) against the reference's
(singa_tpu.layer, `lax.scan` lattices) on carried-over weights.

Seeded numpy inputs and weights go through both packages, fp32 on both
sides: outputs within 1e-5 absolute; the gradients of every weight and
of x under a seeded cotangent (the reference's from its tape) within
1e-4 of each gradient's max|g|. Cases: LSTM at 1 and 2 layers and
bidirectional (2 layers), GRU (1 layer, and bidirectional), RNN with
tanh and relu, `return_state` with given initial states, `CudnnRNN`
sequence-major in each mode, and `remat=True`, which must give the same
values and gradients as without it (bitwise: the cells run again on the
same inputs).
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu import layer as jax_layer
from singa_tpu.tensor import Tensor, from_numpy
from singa_tpu_torch import autograd, layer
from singa_tpu_torch.model import load_singa_tpu_params
from tests.helper_torch_parity import rand, randomize_params, to_torch

ATOL, GRAD_RTOL = 1e-5, 1e-4
T, B, I, H = 7, 3, 5, 6

CASES = {
    "lstm_1": ("LSTM", dict(num_layers=1)),
    "lstm_2": ("LSTM", dict(num_layers=2)),
    "lstm_bidir_2": ("LSTM", dict(num_layers=2, bidirectional=True)),
    "gru_1": ("GRU", dict(num_layers=1)),
    "gru_bidir": ("GRU", dict(bidirectional=True)),
    "rnn_tanh": ("RNN", dict(nonlinearity="tanh")),
    "rnn_relu_2": ("RNN", dict(num_layers=2, nonlinearity="relu")),
    "last_hidden": ("LSTM", dict(bidirectional=True,
                                 return_sequences=False)),
}


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False
    jax_autograd.training = False


def _pair(cls, kw, x, seed=3, **port_kw):
    """The reference layer built on x with seeded weights, and the port's
    layer carrying them."""
    ref = getattr(jax_layer, cls)(H, **kw)
    ref(from_numpy(x))
    params = randomize_params(ref, seed)
    port = getattr(layer, cls)(H, **kw, **port_kw, input_size=x.shape[-1],
                               device="cpu")
    load_singa_tpu_params(port, params)
    return ref, port


def _ref_grads(ref, x, dy):
    jax_autograd.training = True
    try:
        xt = Tensor(data=x, requires_grad=True, stores_grad=True)
        y = ref(xt)
        names = {id(t): n for n, t in ref.get_params().items()}
        names[id(xt)] = "x"
        grads = {names[id(p)]: np.asarray(g.data) for p, g in
                 jax_autograd.backward(y, Tensor(data=dy))}
    finally:
        jax_autograd.training = False
    return np.asarray(y.data), grads


def _port_grads(port, x, dy):
    xt = to_torch(x).requires_grad_()
    y = port(xt)
    named = dict(port.named_parameters())
    gs = torch.autograd.grad(y, [xt, *named.values()], to_torch(dy))
    return (y.detach().numpy(),
            {n: g.numpy() for n, g in zip(["x", *named], gs)})


def _close_grads(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=GRAD_RTOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_reference(case):
    cls, kw = CASES[case]
    x = rand((B, T, I), 0)
    ref, port = _pair(cls, kw, x)
    width = H * (2 if kw.get("bidirectional") else 1)
    dy = rand((B, T, width) if kw.get("return_sequences", True)
              else (B, width), 1)
    want, want_g = _ref_grads(ref, x, dy)
    got, got_g = _port_grads(port, x, dy)
    assert got.shape == want.shape == dy.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "RNN"])
def test_return_state_with_initial_states(cls):
    """Final states of every (layer, direction), from given initial
    states: LSTM (hs, cs), the others hs."""
    kw = dict(num_layers=2, bidirectional=True, return_state=True)
    x = rand((B, T, I), 4)
    ref, port = _pair(cls, kw, x)
    n = 4  # layers x directions
    hs = [rand((B, H), 10 + i) for i in range(n)]
    cs = [rand((B, H), 20 + i) for i in range(n)]
    ref_hx = ([from_numpy(h) for h in hs], [from_numpy(c) for c in cs]) \
        if cls == "LSTM" else [from_numpy(h) for h in hs]
    port_hx = ([to_torch(h) for h in hs], [to_torch(c) for c in cs]) \
        if cls == "LSTM" else [to_torch(h) for h in hs]
    want_y, want_state = ref(from_numpy(x), ref_hx)
    with torch.no_grad():
        got_y, got_state = port(to_torch(x), port_hx)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y.data),
                               atol=ATOL, rtol=0)
    if cls == "LSTM":
        pairs = list(zip(got_state[0] + got_state[1],
                         want_state[0] + want_state[1]))
        assert len(pairs) == 2 * n
    else:
        pairs = list(zip(got_state, want_state))
        assert len(pairs) == n
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w.data),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["lstm", "gru", "tanh", "relu"])
def test_cudnn_rnn_is_sequence_major(mode):
    x = rand((T, B, I), 5)  # (T, B, in)
    ref = jax_layer.CudnnRNN(H, rnn_mode=mode, return_state=True)
    ref(from_numpy(x))
    params = randomize_params(ref, 6)
    port = layer.CudnnRNN(H, rnn_mode=mode, return_state=True,
                          input_size=I, device="cpu")
    assert not port.batch_first
    load_singa_tpu_params(port, params)
    want_y, want_state = ref(from_numpy(x))
    with torch.no_grad():
        got_y, got_state = port(to_torch(x))
    assert tuple(got_y.shape) == (T, B, H)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y.data),
                               atol=ATOL, rtol=0)
    want_h = want_state[0][0] if mode == "lstm" else want_state[0]
    got_h = got_state[0][0] if mode == "lstm" else got_state[0]
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h.data),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "RNN"])
def test_remat_gives_the_same_values_and_gradients(cls):
    kw = dict(num_layers=2, bidirectional=True)
    x = rand((B, T, I), 7)
    dy = rand((B, T, 2 * H), 8)
    ref, plain = _pair(cls, kw, x)
    _, remat = _pair(cls, kw, x, remat=True)
    assert remat.remat and not plain.remat
    y0, g0 = _port_grads(plain, x, dy)
    y1, g1 = _port_grads(remat, x, dy)
    np.testing.assert_array_equal(y1, y0)
    assert sorted(g1) == sorted(g0)
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)
    # and the reference's remat lattice agrees with both
    ref_remat = getattr(jax_layer, cls)(H, remat=True, **kw)
    ref_remat(from_numpy(x))
    ref_remat.set_params({k: np.asarray(v.data) for k, v in
                          ref.get_params().items()})
    want, want_g = _ref_grads(ref_remat, x, dy)
    np.testing.assert_allclose(y1, want, atol=ATOL, rtol=0)
    _close_grads(g1, want_g)


def test_ops_reject_an_unknown_nonlinearity():
    with pytest.raises(ValueError, match="nonlinearity"):
        layer.RNN(H, nonlinearity="gelu", input_size=I, device="cpu")
    with pytest.raises(ValueError, match="rnn_mode"):
        layer.CudnnRNN(H, rnn_mode="sigmoid", input_size=I,
                       device="cpu")
    z = torch.zeros(2, 1, I)
    with pytest.raises(ValueError, match="nonlinearity"):
        autograd.vanilla_rnn(z, torch.zeros(I, H), torch.zeros(H, H),
                             torch.zeros(H), torch.zeros(1, H),
                             nonlinearity="gelu")


def test_weights_are_uniform_in_one_over_sqrt_h():
    gen = torch.Generator().manual_seed(0)
    lstm = layer.LSTM(16, num_layers=2, bidirectional=True, input_size=I,
                      device="cpu", generator=gen)
    names = [n for n, _ in lstm.named_parameters()]
    assert names == [f"{k}_l{l}{d}" for l in range(2) for d in ("", "_r")
                     for k in ("w_ih", "w_hh", "b")]
    shapes = {n: tuple(p.shape) for n, p in lstm.named_parameters()}
    assert shapes["w_ih_l0"] == (I, 64) and shapes["w_ih_l1"] == (32, 64)
    assert shapes["w_hh_l1_r"] == (16, 64) and shapes["b_l0"] == (64,)
    for p in lstm.parameters():
        assert float(p.detach().abs().max()) <= 0.25
