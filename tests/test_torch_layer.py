"""Port's layers (singa_tpu_torch.layer) against the reference's
(singa_tpu.layer) on the same weights and inputs, atol 1e-4 (fp32 on
both sides; products sum in another order).

The scanned stack runs at d=128, H=4 (hd 32, where the reference's head
group `_qkv_group` is 4): at T=32 both sides take the plain attention,
at T=256 both cross the fused-flash threshold (Pallas in interpret mode
on the reference side, the kernel's plain version on the port's).
"""

import numpy as np
import pytest
import torch

from singa_tpu import layer as jax_layer
from singa_tpu.tensor import from_numpy
from singa_tpu_torch import autograd, layer
from singa_tpu_torch.model import load_singa_tpu_params
from tests.helper_torch_parity import rand, randomize_params, to_torch

ATOL = 1e-4


def _run_jax(lyr, x):
    return np.asarray(lyr(from_numpy(x)).data)


def test_layernorm_matches_reference():
    x = rand((3, 7, 64), 0, scale=3.0) + 2.0
    ref = jax_layer.LayerNorm()
    _run_jax(ref, x)
    params = randomize_params(ref, 1)
    port = layer.LayerNorm(64, device="cpu")
    load_singa_tpu_params(port, params)
    np.testing.assert_allclose(port(to_torch(x)).detach().numpy(),
                               _run_jax(ref, x), atol=ATOL)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_reference(bias):
    x = rand((4, 5, 48), 2)
    ref = jax_layer.Linear(80, bias=bias)
    _run_jax(ref, x)
    params = randomize_params(ref, 3)
    port = layer.Linear(48, 80, bias=bias, device="cpu")
    assert port.W.shape == (48, 80)  # (in, out), as in the reference
    load_singa_tpu_params(port, params)
    np.testing.assert_allclose(port(to_torch(x)).detach().numpy(),
                               _run_jax(ref, x), atol=ATOL)


def test_embedding_matches_reference():
    ids = np.random.default_rng(4).integers(0, 50, (3, 9)).astype(np.int32)
    ref = jax_layer.Embedding(50, 16)
    params = randomize_params(ref, 5)
    port = layer.Embedding(50, 16, device="cpu")
    load_singa_tpu_params(port, params)
    np.testing.assert_array_equal(
        port(torch.from_numpy(ids).long()).detach().numpy(),
        np.asarray(ref(from_numpy(ids)).data))


def test_dropout_is_identity_in_eval_and_scales_in_train():
    x = torch.ones(1000)
    d = layer.Dropout(0.5)
    kept = d(x)
    assert set(kept.unique().tolist()) <= {0.0, 2.0}
    d.eval()
    assert torch.equal(d(x), x)


@pytest.mark.parametrize("t,causal", [(32, True), (256, True),
                                      (32, False)])
def test_scan_stack_matches_reference(t, causal):
    x = rand((2, t, 128), 6)
    ref = jax_layer.ScanTransformerStack(2, 4, causal=causal)
    _run_jax(ref, x)
    params = randomize_params(ref, 7)
    port = layer.ScanTransformerStack(2, 4, 128, causal=causal,
                                      device="cpu")
    assert [n for n, _ in port.named_parameters()] == list(port.STACKED)
    assert list(port.STACKED) == list(ref.STACKED)
    load_singa_tpu_params(port, params)
    with torch.no_grad():
        got = port(to_torch(x)).numpy()
    np.testing.assert_allclose(got, _run_jax(ref, x), atol=ATOL)


def test_scan_stack_under_autocast_keeps_bf16_activations():
    port = layer.ScanTransformerStack(1, 4, 128, causal=True, device="cpu")
    x = to_torch(rand((1, 16, 128), 8))
    with torch.no_grad():
        want = port(x)
        with autograd.autocast():
            got = port(x.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=0.1)


@pytest.mark.parametrize("kw", [{"tp_axis": "model"},
                                {"zero3_axis": "data"},
                                {"seq_axis": "sp"}, {"overlap": True},
                                {"remat": "per_block"}])
def test_scan_stack_refuses_what_belongs_to_later_slices(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer.ScanTransformerStack(1, 4, 128, device="cpu", **kw)
