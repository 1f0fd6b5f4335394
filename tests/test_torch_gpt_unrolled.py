"""Port's unrolled GPT decoder (`GPT(scan_blocks=False)`, the reference's
default) against the reference's on carried-over weights, and against
the port's scanned decoder on the same weights (`unstack_params`).

A reference GPT(vocab 128, d 128, L 2, H 4, max_len 256, dropout 0.0),
unrolled, gets seeded random weights, which `load_singa_tpu_params`
copies into the port. Then:

- forward logits within atol 1e-4 at T 256, where both sides take the
  fused-flash path (Pallas in interpret mode, the kernels' plain
  versions), and at T 64 (plain attention);
- one SGD(lr=1.0) step, whose parameter change is minus the gradient:
  every gradient within atol 1e-5, at T 256 and T 64;
- greedy cached `generate` token-identical; eager
  `generate(use_cache=False)` token-identical, greedy and sampled (both
  sides draw with numpy's generator from `seed`), and equal to the
  cached path once the prompt fills the window;
- the port's unrolled and scanned decoders on the same weights: equal
  logits and gradients (atol 1e-6), and one `ServingEngine` stream mix
  token-identical;
- `GPT()` with default arguments builds the reference's default (the
  unrolled decoder with dropout 0.1); `remat=True` is accepted and
  changes nothing on one device; the example trainer without
  --scan-blocks trains and samples.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu import opt as jax_opt
from singa_tpu.models.gpt import GPT as JaxGPT
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import autograd, opt
from singa_tpu_torch.examples.serve_gpt import seeded_weights
from singa_tpu_torch.layer import ScanTransformerStack
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models.gpt import GPT, unstack_params
from singa_tpu_torch.models.transformer import TransformerEncoder
from singa_tpu_torch.serving import Request, ServingEngine
from tests.helper_torch_parity import randomize_params

ROOT = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=128, d_model=128, num_layers=2, num_heads=4,
          max_len=256, dropout=0.0)


@pytest.fixture(autouse=True)
def _reset_process_flags():
    yield
    autograd.training = False


@pytest.fixture(scope="module")
def pair():
    ref = JaxGPT(**KW)
    ref.eval()
    ref(from_numpy(np.zeros((1, 8), np.int32)))  # materialize lazy params
    params = randomize_params(ref, 0)
    port = GPT(**KW, device="cpu")
    port.eval()
    load_singa_tpu_params(port, params)
    return ref, port, params


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


def test_parameter_names_are_the_reference_names(pair):
    _, port, params = pair
    assert isinstance(port.decoder, TransformerEncoder)
    assert {k: v.shape for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in port.named_parameters()}
    assert "decoder.blocks.1.attn.w_qkv" in params


@pytest.mark.parametrize("t", [256, 64])
def test_forward_logits_match_reference(pair, t):
    ref, port, _ = pair
    ids = _ids((2, t), 1)
    want = np.asarray(ref(from_numpy(ids)).data)
    got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, t, 128)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _batch(t):
    ids = _ids((2, t + 1), 2)
    return ids[:, :-1], ids[:, 1:]


@pytest.mark.parametrize("t", [256, 64])
def test_one_sgd_step_is_the_reference_gradient(pair, t):
    _, _, params = pair
    x, y = _batch(t)
    ref = JaxGPT(**KW)
    ref(from_numpy(np.zeros((1, 8), np.int32)))
    ref.set_params(params)
    ref.set_optimizer(jax_opt.SGD(lr=1.0))
    ref.compile([from_numpy(x)], is_train=True, use_graph=True)
    ref(from_numpy(x), from_numpy(y))
    want = {k: np.asarray(v.data) for k, v in ref.get_params().items()}

    port = GPT(**KW, device="cpu")
    load_singa_tpu_params(port, params)
    port.set_optimizer(opt.SGD(lr=1.0))
    port.compile([torch.from_numpy(x)], is_train=True, use_graph=True)
    port(torch.from_numpy(x), torch.from_numpy(y))
    got = {k: v.detach().numpy() for k, v in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        want_grad = params[k] - want[k]
        assert np.abs(want_grad).max() > 0, k  # every parameter is reached
        np.testing.assert_allclose(params[k] - got[k], want_grad, atol=1e-5,
                                   err_msg=k)


def test_cached_generate_is_token_identical(pair):
    ref, port, _ = pair
    prompt = _ids((2, 20), 3)
    want = ref.generate(prompt, n_new=16, window=32)
    got = port.generate(prompt, n_new=16, window=32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_eager_generate_is_token_identical(pair, temperature):
    ref, port, _ = pair
    prompt = _ids((2, 20), 4)
    kw = dict(n_new=6, window=32, temperature=temperature, seed=5,
              use_cache=False)
    want = ref.generate(prompt, **kw)
    got = port.generate(prompt, **kw)
    np.testing.assert_array_equal(got, want)
    assert not port.training and not autograd.training


def test_eager_generate_equals_cached_once_the_window_is_full(pair):
    _, port, _ = pair
    prompt = _ids((2, 32), 6)
    np.testing.assert_array_equal(
        port.generate(prompt, n_new=6, window=32, use_cache=False),
        port.generate(prompt, n_new=6, window=32))


@pytest.fixture(scope="module")
def twins():
    """The port's scanned and unrolled decoders on one set of weights."""
    scanned = GPT(**KW, scan_blocks=True, device="cpu")
    weights = seeded_weights(scanned, 7)
    load_singa_tpu_params(scanned, weights)
    unrolled = GPT(**KW, device="cpu")
    load_singa_tpu_params(unrolled, unstack_params(weights))
    assert isinstance(scanned.decoder, ScanTransformerStack)
    return scanned, unrolled


def _grads(m, x, y):
    loss = autograd.softmax_cross_entropy(
        m.forward(x).reshape(-1, 128), y.reshape(-1))
    names = {id(p): n for n, p in m.named_parameters()}
    return loss, {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}


def test_unrolled_equals_scanned_on_the_same_weights(twins):
    scanned, unrolled = twins
    x, y = (torch.from_numpy(a).long() for a in _batch(256))
    autograd.training = True
    loss_s, g_s = _grads(scanned, x, y)
    loss_u, g_u = _grads(unrolled, x, y)
    torch.testing.assert_close(loss_u, loss_s, rtol=0, atol=1e-6)
    got = unstack_params({k: v.numpy() for k, v in g_s.items()})
    assert sorted(got) == sorted(g_u)
    for k, v in g_u.items():
        np.testing.assert_allclose(v.numpy(), got[k], atol=1e-6, err_msg=k)


def test_serving_engine_streams_equal_the_scanned_twin(twins):
    rng = np.random.default_rng(8)
    spec = [(5, 12), (30, 9), (17, 14)]
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n, _ in spec]
    streams = []
    for m in twins:
        eng = ServingEngine(m, slots=2, block_size=16, window=64)
        reqs = [Request(i, p, n_new, temperature=0.7 * (i % 2), seed=i)
                for i, (p, (_, n_new)) in enumerate(zip(prompts, spec))]
        pending = reqs[::-1]
        while eng.n_active or pending:
            if pending and eng.n_active < 2:  # admitted as slots free
                eng.admit(pending.pop())
                continue
            eng.step()
        assert eng.decode_compiles == 1
        streams.append([r.tokens for r in reqs])
    assert [len(s) for s in streams[0]] == [n for _, n in spec]
    assert streams[0] == streams[1]


def test_default_gpt_is_the_reference_default():
    m = GPT(device="cpu")
    assert isinstance(m.decoder, TransformerEncoder)
    assert m.decoder.n_blocks == 12 and m.decoder.num_heads == 12
    assert m.vocab_size == 50257 and m.pos.table.shape == (1024, 768)
    drops = [mod.p for mod in m.modules() if type(mod).__name__ == "Dropout"]
    assert drops == [0.1] * (1 + 2 * 12)


def test_remat_is_accepted_and_changes_nothing_on_one_device(pair):
    _, port, params = pair
    m = GPT(**KW, remat=True, device="cpu")
    load_singa_tpu_params(m, params)
    assert all(b.attn.remat for b in m.decoder.blocks)
    x, y = (torch.from_numpy(a).long() for a in _batch(64))
    autograd.training = True
    _, want = _grads(port, x, y)
    _, got = _grads(m, x, y)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_example_trainer_trains_and_samples_the_default_decoder():
    out = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.gpt_lm",
         "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
         "--d-model", "32", "--heads", "2", "--sample-chars", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.stdout.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0], out.stdout
    sample = out.stdout.split("--- sample ---\n")[1].splitlines()[0]
    assert len(sample) == 32 + 8


def test_speculative_engine_takes_unrolled_target_and_draft(twins):
    """Greedy speculative streams equal the target's solo `generate`,
    with an unrolled target and an unrolled draft."""
    from singa_tpu_torch.serving import SpeculativeEngine

    _, target = twins
    draft = GPT(vocab_size=128, d_model=32, num_layers=1, num_heads=2,
                max_len=256, dropout=0.0, device="cpu")
    eng = SpeculativeEngine(target, draft, spec_k=3, slots=2, block_size=16,
                            window=64)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (7, 21)]
    reqs = [Request(i, p, 10) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(r)
    while eng.n_active:
        eng.step()
    for p, r in zip(prompts, reqs):
        want = target.generate(p, n_new=10, window=64)[0, len(p):]
        assert r.tokens == want.tolist()
