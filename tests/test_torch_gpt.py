"""Port's GPT (singa_tpu_torch.models.gpt) against the reference's
(singa_tpu.models.gpt) on carried-over weights.

A reference GPT(vocab 128, d 128, L 2, H 4, max_len 256, scan_blocks)
gets seeded random weights, which `load_singa_tpu_params` copies into
the port. Then:

- forward logits match at T=256, where both sides take the fused-flash
  path (atol 1e-4, fp32 on both sides);
- greedy cached `generate` (prompt (2, 20), 16 new tokens, window 32:
  12 grow and 4 slide steps) is token-identical.
"""

import numpy as np
import pytest
import torch

from singa_tpu.models.gpt import GPT as JaxGPT
from singa_tpu.tensor import from_numpy
from singa_tpu_torch.models.gpt import GPT, gpt_medium
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.ops import flash_attention as fa
from tests.helper_torch_parity import randomize_params

KW = dict(vocab_size=128, d_model=128, num_layers=2, num_heads=4,
          max_len=256, dropout=0.0, scan_blocks=True)


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


def test_parameter_names_and_layouts_match(pair):
    ref, port, params = pair
    assert {k: v.shape for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in port.named_parameters()}


def test_forward_logits_match_reference(pair):
    ref, port, _ = pair
    ids = np.random.default_rng(1).integers(0, 128, (2, 256)).astype(
        np.int32)
    want = np.asarray(ref(from_numpy(ids)).data)
    before = fa.FLASH_FWD_LAUNCHES
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert fa.FLASH_FWD_LAUNCHES == before  # CPU: the plain version ran
    assert got.shape == (2, 256, 128)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_greedy_generate_is_token_identical(pair):
    ref, port, _ = pair
    prompt = np.random.default_rng(2).integers(0, 128, (2, 20)).astype(
        np.int32)
    want = ref.generate(prompt, n_new=16, window=32)
    got = port.generate(prompt, n_new=16, window=32)
    assert got.dtype == np.int32 and got.shape == (2, 36)
    np.testing.assert_array_equal(got, want)


def test_prefill_matches_the_kernel_path_forward(pair):
    """The chip check's cross-check, at test size: the prefill's logits
    (plain attention) equal `model(ctx)` on the same padded window."""
    _, port, _ = pair
    ids = torch.from_numpy(
        np.random.default_rng(3).integers(0, 128, (2, 256)))
    ids[:, 200:] = 0
    prefill = port._decode_fns(256)[0]
    with torch.no_grad():
        logits, kc, vc = prefill(port._functional_params(), ids)
        want = port(ids)
    assert kc.shape == vc.shape == (2, 2, 4, 256, 32)
    np.testing.assert_allclose(logits[:, :200].numpy(),
                               want[:, :200].numpy(), atol=1e-4)


def test_sampling_is_deterministic_per_seed(pair):
    _, port, _ = pair
    prompt = np.random.default_rng(4).integers(0, 128, (2, 10))
    a = port.generate(prompt, 8, window=16, temperature=1.0, seed=5)
    b = port.generate(prompt, 8, window=16, temperature=1.0, seed=5)
    c = port.generate(prompt, 8, window=16, temperature=1.0, seed=6)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :10], prompt)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_carry_over_refuses_mismatched_names(pair, fault):
    _, _, params = pair
    params = dict(params)
    if fault == "missing":
        del params["decoder.w1"]
        err = KeyError
    elif fault == "extra":
        params["decoder.w3"] = params["decoder.w1"]
        err = KeyError
    else:
        params["head.W"] = params["head.W"][:, :64]
        err = ValueError
    with pytest.raises(err):
        load_singa_tpu_params(GPT(**KW, device="cpu"), params)


@pytest.mark.parametrize("kw", [{"scan_blocks": False, "moe_experts": 2},
                                {"dropout": 0.1},
                                {"tp_axis": "model"}, {"seq_axis": "sp"},
                                {"moe_experts": 2}, {"pp_axis": "pipe"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP|dropout"):
        GPT(**{**KW, **kw}, device="cpu")


def test_gpt_medium_has_the_reference_defaults(monkeypatch):
    seen = {}
    monkeypatch.setattr(GPT, "__init__",
                        lambda self, **kw: seen.update(kw))
    gpt_medium(device="cpu")
    assert seen == dict(vocab_size=32768, d_model=1024, num_layers=12,
                        num_heads=8, max_len=1024, dropout=0.0,
                        scan_blocks=True, remat_policy="none",
                        device="cpu")
