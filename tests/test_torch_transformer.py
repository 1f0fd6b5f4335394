"""Port's transformer module (singa_tpu_torch.models.transformer) against
the reference's (singa_tpu.models.transformer) on carried-over weights.

Seeded numpy inputs and weights go through both packages, fp32 on both
sides (products sum in another order):

- `MultiHeadAttention` at d 64, H 2 (hd 32), T 24, causal, non-causal
  and with a key-padding mask (the plain attention on both sides):
  output, and the gradients of every weight and of x under a seeded
  cotangent, within atol 1e-5;
- non-causal at T 512 on d 128, H 2, hd 64, B 1, where both sides take
  the fused route (the reference's Pallas kernels in interpret mode, the
  port's kernels' plain versions): output and gradients within 1e-5;
- `BertForClassification` (vocab 64, d 128, 2 layers, H 2 of hd 64,
  dropout 0), at T 40 (plain attention) and T 512 (fused kernels on both
  sides): the parameter names, the state after compile, the first
  step's logits and loss, the gradients (the reference's from its
  tape), and after 3 AdamW(lr 1e-4) steps the losses (rtol 1e-5 and
  atol 1e-5: at T 512 the two sides' fp32 sums part by ~6e-6 once the
  weights have moved, on losses that fall to ~0.4) and every
  parameter (atol 1e-5; weights whose gradient is at rounding level, the
  K bias of each block, are held to Adam's step size instead, as in
  tests/test_torch_train_gpt.py);
- a forward with segment ids and a key-padding mask;
- `autograd.gelu` (both forms), `tanh`, `reshape` and the `Gelu` and
  `Tanh` layers.
"""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jax_autograd
from singa_tpu import layer as jax_layer
from singa_tpu import opt as jax_opt
from singa_tpu.models import transformer as jax_tf
from singa_tpu.tensor import Tensor, from_numpy
from singa_tpu_torch import autograd, layer, opt
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models import transformer as tf
from singa_tpu_torch.ops import flash_attention as fa
from tests.helper_torch_parity import (jax_flash, rand, randomize_params,
                                       to_torch)

ATOL = 1e-5
LR = 1e-4  # the bench's BERT rate
BERT = dict(vocab_size=64, d_model=128, num_layers=2, num_heads=2,
            max_len=512, dropout=0.0)


@pytest.fixture(autouse=True)
def _reset_process_flags():
    """The two packages' `training` flags are process-wide: leave them
    as the other test files expect."""
    yield
    autograd.training = False
    jax_autograd.training = False


def _ref_grads(fn, x, params, dy):
    """Output and {name: grad} (x's under "x") of a reference forward
    `fn(x_tensor)` under the cotangent dy, from the reference's tape."""
    jax_autograd.training = True
    xt = Tensor(data=x, requires_grad=True, stores_grad=True)
    y = fn(xt)
    names = {id(t): n for n, t in params.items()}
    names[id(xt)] = "x"
    grads = {names[id(p)]: np.asarray(g.data) for p, g in
             jax_autograd.backward(y, Tensor(data=dy))}
    jax_autograd.training = False
    return np.asarray(y.data), grads


def _port_grads(module, x, dy, *args):
    xt = to_torch(x).requires_grad_()
    y = module(xt, *args)
    named = dict(module.named_parameters())
    gs = torch.autograd.grad(y, [xt, *named.values()], to_torch(dy))
    return (y.detach().numpy(),
            {n: g.numpy() for n, g in zip(["x", *named], gs)})


def _close_all(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=1e-5,
                                   err_msg=k)


def _mha_pair(d, heads, causal, x, seed):
    ref = jax_tf.MultiHeadAttention(heads, causal=causal)
    ref(from_numpy(x))  # build the lazy weights
    params = randomize_params(ref, seed)
    port = tf.MultiHeadAttention(heads, causal=causal, d_model=d,
                                 device="cpu")
    load_singa_tpu_params(port, params)
    return ref, port


def _padding_mask(b, t, seed):
    lengths = np.random.default_rng(seed).integers(t // 2, t, b)
    return (np.arange(t)[None] < lengths[:, None])[:, None, None, :]


@pytest.mark.parametrize("case", ["causal", "noncausal", "key_padding"])
def test_mha_matches_reference(case):
    b, t, d = 2, 24, 64
    x = rand((b, t, d), 0)
    dy = rand((b, t, d), 1)
    ref, port = _mha_pair(d, 2, case == "causal", x, 2)
    mask = _padding_mask(b, t, 3) if case == "key_padding" else None
    want, want_g = _ref_grads(lambda xt: ref(xt, mask), x,
                              ref.get_params(), dy)
    got, got_g = _port_grads(port, x, dy, mask)
    np.testing.assert_allclose(got, want, atol=ATOL)
    _close_all(got_g, want_g)


def test_mha_noncausal_t512_takes_the_fused_route_on_both_sides(
        monkeypatch):
    b, t, d = 1, 512, 128
    x = rand((b, t, d), 4)
    dy = rand((b, t, d), 5)
    ref, port = _mha_pair(d, 2, False, x, 6)
    routes = {"ref": 0, "fwd": 0, "bwd": 0}
    jf = jax_flash()
    real_ref, real_fwd, real_bwd = (jf.flash_attention_qkv, fa._flash_fwd,
                                    fa._flash_bwd)

    def ref_qkv(*a, **kw):
        routes["ref"] += 1
        return real_ref(*a, **kw)

    def fwd(*a):
        routes["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        routes["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(jf, "flash_attention_qkv", ref_qkv)
    monkeypatch.setattr(fa, "_flash_fwd", fwd)
    monkeypatch.setattr(fa, "_flash_bwd", bwd)
    launches = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
                fa.FLASH_BWD_DKV_LAUNCHES)
    want, want_g = _ref_grads(ref, x, ref.get_params(), dy)
    got, got_g = _port_grads(port, x, dy)
    assert routes == {"ref": 1, "fwd": 1, "bwd": 1}
    # the CPU ran the plain versions: no launch was counted
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
            fa.FLASH_BWD_DKV_LAUNCHES) == launches
    np.testing.assert_allclose(got, want, atol=ATOL)
    _close_all(got_g, want_g)


@pytest.fixture(scope="module")
def bert_weights():
    ref = jax_tf.BertForClassification(3, **BERT)
    ref.eval()
    ref(from_numpy(np.zeros((1, 8), np.int32)))  # build the lazy weights
    return randomize_params(ref, 10)


def _port_bert(weights):
    m = tf.BertForClassification(3, **BERT, device="cpu")
    load_singa_tpu_params(m, weights)
    return m


def _bert_batch(t):
    rng = np.random.default_rng(t)
    b = 2 if t < 512 else 1
    return (rng.integers(0, 64, (b, t)).astype(np.int32),
            rng.integers(0, 3, b).astype(np.int32))


def test_bert_parameter_names_are_the_reference_names(bert_weights):
    port = _port_bert(bert_weights)
    assert {k: v.shape for k, v in bert_weights.items()} == {
        k: tuple(v.shape) for k, v in port.named_parameters()}
    assert "bert.encoder.blocks.1.attn.w_qkv" in bert_weights
    assert "bert.pooler.W" in bert_weights and "head.b" in bert_weights


@pytest.mark.parametrize("t", [40, 512])
def test_bert_classification_trains_like_the_reference(bert_weights, t):
    x, y = _bert_batch(t)
    ref = jax_tf.BertForClassification(3, **BERT)
    ref(from_numpy(np.zeros((1, 8), np.int32)))
    ref.set_params(bert_weights)
    params = ref.get_params()
    # the reference's gradients, from its tape at the seeded weights
    _, want_g = _ref_grads(
        lambda _: jax_autograd.softmax_cross_entropy(
            ref.forward(from_numpy(x)), y),
        np.zeros(1, np.float32), params, np.ones((), np.float32))
    want_g.pop("x", None)

    ref.set_optimizer(jax_opt.AdamW(lr=LR))
    xr, yr = from_numpy(x), from_numpy(y)
    ref.compile([xr], is_train=True, use_graph=True)
    want_compiled = {k: np.asarray(v.data) for k, v in params.items()}
    want_logits, want_losses = None, []
    for _ in range(3):
        out, loss = ref(xr, yr)
        if want_logits is None:
            want_logits = np.asarray(out.data)
        want_losses.append(float(np.asarray(loss.data)))
    want_after = {k: np.asarray(v.data) for k, v in
                  ref.get_params().items()}

    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    port = _port_bert(bert_weights)
    port.set_optimizer(opt.AdamW(lr=LR))
    port.compile([xt], is_train=True, use_graph=True)
    _close_all({k: v.detach().numpy() for k, v in
                port.named_parameters()}, want_compiled)
    logits = port.forward(xt)
    loss = autograd.softmax_cross_entropy(logits, yt)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               atol=ATOL)
    np.testing.assert_allclose(loss.item(), want_losses[0], rtol=1e-5)
    names = {id(p): n for n, p in port.named_parameters()}
    got_g = {names[id(p)]: g.numpy() for p, g in autograd.grad_pairs(loss)}
    # the segment table is not reached without seg_ids, on either side
    assert "bert.seg.table" not in got_g
    _close_all(got_g, want_g)

    losses = [port(xt, yt)[1].item() for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=ATOL)
    assert losses[-1] < losses[0]
    got_after = {k: v.detach().numpy() for k, v in port.named_parameters()}
    assert sorted(got_after) == sorted(want_after)
    for k in want_after:
        noise = np.abs(got_g.get(k, np.ones(1))) < 1e-6
        noise = np.broadcast_to(noise, want_after[k].shape)
        np.testing.assert_allclose(got_after[k][~noise],
                                   want_after[k][~noise], atol=ATOL,
                                   err_msg=k)
        if noise.any():
            assert np.abs(got_after[k] - want_after[k])[noise].max() <= (
                2 * LR * 3), k


def test_bert_with_segments_and_padding_mask_matches_reference(
        bert_weights):
    x, _ = _bert_batch(40)
    seg = (np.arange(40) >= 20).astype(np.int32)[None].repeat(2, 0)
    mask = _padding_mask(2, 40, 11)
    ref = jax_tf.BertForClassification(3, **BERT)
    ref(from_numpy(np.zeros((1, 8), np.int32)))
    ref.set_params(bert_weights)
    ref.eval()
    want = np.asarray(ref(from_numpy(x), from_numpy(seg), mask).data)
    port = _port_bert(bert_weights)
    port.eval()
    got = port(torch.from_numpy(x), torch.from_numpy(seg),
               torch.from_numpy(mask))
    assert not got.requires_grad  # eval mode records no tape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    unmasked = port(torch.from_numpy(x), torch.from_numpy(seg))
    assert not torch.allclose(unmasked, got, atol=1e-3)  # the mask acts


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_erf", "tanh",
                                  "Gelu", "Tanh", "reshape"])
def test_activation_functions_match_reference(name):
    x = rand((3, 5, 8), 12, scale=2.0)
    ref_fn, port_fn = {
        "gelu_tanh": (jax_autograd.gelu, autograd.gelu),
        "gelu_erf": (lambda t: jax_autograd.gelu(t, approximate=False),
                     lambda t: autograd.gelu(t, approximate=False)),
        "tanh": (jax_autograd.tanh, autograd.tanh),
        "Gelu": (jax_layer.Gelu(), layer.Gelu()),
        "Tanh": (jax_layer.Tanh(), layer.Tanh()),
        "reshape": (lambda t: jax_autograd.reshape(t, (15, 8)),
                    lambda t: autograd.reshape(t, (15, 8))),
    }[name]
    want = np.asarray(ref_fn(from_numpy(x)).data)
    got = port_fn(to_torch(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_scan_stack_ffn_is_the_gelu_layer():
    """`ScanTransformerStack`'s FFN and `TransformerEncoderLayer`'s apply
    one function: a one-block stack equals an encoder layer on the same
    weights."""
    stack = layer.ScanTransformerStack(1, 2, d_model=64, device="cpu")
    enc = tf.TransformerEncoderLayer(2, dropout=0.0, d_model=64,
                                     device="cpu")
    from singa_tpu_torch.models.gpt import _BLOCK_NAMES

    with torch.no_grad():
        for name in stack.STACKED:
            enc.get_parameter(_BLOCK_NAMES[name]).copy_(
                getattr(stack, name)[0])
        x = to_torch(rand((2, 16, 64), 13))
        torch.testing.assert_close(enc(x), stack(x), rtol=0, atol=1e-6)


def test_bert_presets_have_the_reference_widths(monkeypatch):
    seen = []
    monkeypatch.setattr(tf.Bert, "__init__",
                        lambda self, **kw: seen.append(kw))
    tf.bert_base(device="cpu")
    tf.bert_small(device="cpu")
    assert seen == [
        dict(d_model=768, num_layers=12, num_heads=12, device="cpu"),
        dict(d_model=128, num_layers=2, num_heads=4, vocab_size=1000,
             max_len=128, device="cpu")]


@pytest.mark.parametrize("kw", [{"tp_axis": "model", "moe_experts": 4},
                                {"tp_axis": "model", "moe_experts": 4,
                                 "moe_axis": "model"},
                                {"seq_axis": "sp", "tp_axis": "sp"},
                                {"seq_impl": "allgather"},
                                {"tp_axis": "model", "moe_experts": 2,
                                 "moe_axis": None}])
def test_distributed_options_raise_naming_the_roadmap(kw):
    """Every distributed option of the encoder is ported (MoE in
    tests/test_torch_moe_model.py); what the reference refuses still
    raises: MoE beside tp without a distinct moe_axis, tp and seq on
    one axis, an unknown seq_impl. A dense model records no MoE aux."""
    with pytest.raises((NotImplementedError, ValueError),
                       match="DISTINCT|distinct|seq_impl"):
        tf.Bert(**BERT, **kw, device="cpu")
    assert tf.collect_moe_aux(tf.bert_small(device="cpu")) == []
    moe = tf.Bert(**BERT, moe_experts=4, moe_axis="expert", device="cpu")
    assert moe.encoder.blocks[0].ffn.w1.pspec == ("expert", None, None)
    bert = tf.Bert(**BERT, seq_axis="sp", ring_flash=True,
                   seq_impl="ulysses", device="cpu")
    attn = bert.encoder.blocks[0].attn
    assert (attn.seq_axis, attn.ring_flash, attn.seq_impl) == (
        "sp", True, "ulysses")
