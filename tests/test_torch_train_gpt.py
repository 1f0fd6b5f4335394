"""Port's GPT training (singa_tpu_torch.models.gpt + opt + model) against
the reference's (singa_tpu) on carried-over weights.

A reference GPT(vocab 128, d 128, L 2, H 4, max_len 256, scan_blocks,
dropout 0.0) gets seeded random weights, which `load_singa_tpu_params`
copies into the port. Both sides compile with `use_graph=True` and train
on the same seeded batch, y = x shifted by one:

- T=256, where both take the fused flash path (Pallas in interpret mode
  on the reference side, the kernels' plain versions on the port's): 3
  AdamW steps, per-step losses within rtol 1e-5 and every parameter
  after the steps within atol 1e-5 (fp32 on both sides; an AdamW step
  moves a weight by ~lr = 1e-3, so this is 1% of one step). Weights whose
  first gradient is at rounding level (|g| < 1e-6: the K bias, whose
  gradient is 0 analytically, as softmax ignores a shift shared by a
  row) take Adam's g / (|g| + eps) of rounding noise on both sides, so
  they are held only to Adam's step size, 2 lr per step;
- one SGD(lr=1.0) step, whose parameter change is minus the gradient:
  the gradient oracle, per parameter within atol 1e-5 on gradients of
  order 1e-1;
- the same at T=64, where both sides use `full_attention`.
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
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.ops import flash_attention as fa
from tests.helper_torch_parity import randomize_params

ROOT = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=128, d_model=128, num_layers=2, num_heads=4,
          max_len=256, dropout=0.0, scan_blocks=True)
LR = 1e-3


@pytest.fixture(autouse=True)
def _reset_process_flags():
    """`autograd.training` and the autocast policy are process-wide, as
    in the reference: leave them as the other test files expect."""
    yield
    autograd.training = False
    autograd.set_autocast(False)


@pytest.fixture(scope="module")
def weights():
    ref = JaxGPT(**KW)
    ref.eval()
    ref(from_numpy(np.zeros((1, 8), np.int32)))  # materialize lazy params
    return randomize_params(ref, 0)


def _batch(t, seed=1):
    ids = np.random.default_rng(seed).integers(0, 128, (2, t + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _ref_train(weights, make_opt, t, steps):
    m = JaxGPT(**KW)
    m(from_numpy(np.zeros((1, 8), np.int32)))
    m.set_params(weights)
    m.set_optimizer(make_opt(jax_opt))
    x, y = (from_numpy(a) for a in _batch(t))
    m.compile([x], is_train=True, use_graph=True)
    losses = [float(np.asarray(m(x, y)[1].data)) for _ in range(steps)]
    return losses, {k: np.asarray(v.data) for k, v in
                    m.get_params().items()}


def _port(weights, remat="none"):
    m = GPT(**KW, remat_policy=remat, device="cpu")
    load_singa_tpu_params(m, weights)
    return m


def _port_train(weights, make_opt, t, steps):
    m = _port(weights)
    m.set_optimizer(make_opt(opt))
    x, y = (torch.from_numpy(a) for a in _batch(t))
    m.compile([x], is_train=True, use_graph=True)
    losses = [m(x, y)[1].item() for _ in range(steps)]
    return m, losses, {k: v.detach().numpy() for k, v in
                       m.named_parameters()}


@pytest.mark.parametrize("t", [256, 64])
def test_adamw_steps_match_reference(weights, t):
    make = (lambda mod: mod.AdamW(lr=LR))
    want_losses, want = _ref_train(weights, make, t, 3)
    before = fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES
    port, losses, got = _port_train(weights, make, t, 3)
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES) == before
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert sorted(got) == sorted(want)
    g0 = _grads(_port(weights), t)
    for k in want:
        noise = np.abs(g0[k].numpy()) < 1e-6
        np.testing.assert_allclose(got[k][~noise], want[k][~noise],
                                   atol=1e-5, err_msg=k)
        if noise.any():
            assert np.abs(got[k] - want[k])[noise].max() <= 2 * LR * 3, k
    states = port.optimizer.dump_states()
    assert int(states["__step__"]) == 3
    assert "decoder.w_qkv//m" in states and "head.W//v" in states

    # scoring still works after training, on the trained weights
    port.eval()
    ids = torch.from_numpy(_batch(t, seed=2)[0])
    scores = port(ids)
    assert not scores.requires_grad  # eval mode records no tape
    with torch.no_grad():
        ref_scores = port.forward(ids)
    assert scores.shape == (2, t, 128)
    assert torch.equal(scores, ref_scores)


@pytest.mark.parametrize("t", [256, 64])
def test_one_sgd_step_is_the_reference_gradient(weights, t):
    make = (lambda mod: mod.SGD(lr=1.0))
    _, want = _ref_train(weights, make, t, 1)
    _, _, got = _port_train(weights, make, t, 1)
    for k in want:
        want_grad = weights[k] - want[k]
        got_grad = weights[k] - got[k]
        assert np.abs(want_grad).max() > 0, k  # every parameter is reached
        np.testing.assert_allclose(got_grad, want_grad, atol=1e-5,
                                   err_msg=k)


def _grads(m, t):
    x, y = (torch.from_numpy(a) for a in _batch(t))
    logits = m.forward(x)
    loss = autograd.softmax_cross_entropy(logits.reshape(-1, 128),
                                          y.reshape(-1))
    names = {id(p): n for n, p in m.named_parameters()}
    return {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}


def test_remat_policies_give_the_same_gradients(weights):
    want = _grads(_port(weights), 256)
    assert len(want) == len(list(_port(weights).parameters()))
    for policy in ("per_block", "dots_saveable"):
        got = _grads(_port(weights, policy), 256)
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6,
                                       msg=f"{policy} {k}")


@pytest.mark.parametrize("policy,fwd_per_block", [
    ("none", 1), ("per_block", 2), ("dots_saveable", 2)])
def test_kernel_calls_per_step_by_remat_policy(weights, monkeypatch, policy,
                                               fwd_per_block):
    """One step at T=256 (the fused flash path) runs the forward kernel
    once per block, and once more per block when the policy recomputes
    the block in backward (a kernel is no matrix product to the
    dots_saveable policy, as a Pallas call is none to the reference's);
    the dQ and dK/dV kernels run once per block under every policy."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa._flash_fwd, fa._flash_bwd

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(fa, "_flash_fwd", fwd)
    monkeypatch.setattr(fa, "_flash_bwd", bwd)
    m = _port(weights, policy)
    m.set_optimizer(opt.SGD(lr=0.1))
    x, y = (torch.from_numpy(a) for a in _batch(256))
    m.compile([x], is_train=True, use_graph=True)
    calls.update(fwd=0, bwd=0)
    m(x, y)
    blocks = KW["num_layers"]
    assert calls == {"fwd": fwd_per_block * blocks, "bwd": blocks}


def test_train_one_batch_routes_like_the_reference(weights):
    """Before compile a call scores; after compile(is_train=True) both
    `model(x, y)` and `model.train_one_batch(x, y)` take a step; eval()
    routes calls back to forward."""
    m = _port(weights)
    x, y = (torch.from_numpy(a) for a in _batch(32))
    assert m(x).shape == (2, 32, 128)
    m.set_optimizer(opt.SGD(lr=0.1))
    m.compile([x], is_train=True, use_graph=True)
    assert m.memory_estimate is None  # no captured step in this slice
    w0 = m.head.W.detach().clone()
    logits, loss = m(x, y)
    assert logits.shape == (2, 32, 128) and loss.dim() == 0
    _, loss2 = m.train_one_batch(x, y, dist_option="sparse-topk")
    assert m.optimizer.step_counter == 2 and loss2 < loss
    assert not torch.equal(m.head.W, w0)
    m.eval()
    assert m(x).shape == (2, 32, 128) and not autograd.training
    m.train()
    assert autograd.training
    m.eval()


def test_bf16_precision_trains():
    m = GPT(**KW, device="cpu")
    m.set_optimizer(opt.AdamW(lr=LR))
    x, y = (torch.from_numpy(a) for a in _batch(64))
    try:
        m.compile([x], is_train=True, use_graph=True, precision="bf16")
        assert autograd.autocast_enabled()
        logits, loss = m(x, y)
    finally:
        autograd.set_autocast(False)
        m.eval()
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert torch.isfinite(loss)


def test_example_trainer_lowers_the_loss():
    out = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.examples.gpt_lm",
         "--device", "cpu", "--steps", "3", "--scan-blocks", "--batch", "4",
         "--seq", "32", "--d-model", "32", "--heads", "2",
         "--sample-chars", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.stdout.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0], out.stdout
    assert "--- sample ---" in out.stdout


@pytest.mark.parametrize("flag", [["--shard-states", "--scan-blocks"],
                                  ["--shard-states"],
                                  ["--virtual-devices", "8"],
                                  ["--checkpoint", "ckpt.zip"]])
def test_example_trainer_refuses_unported_options(flag):
    """On either decoder (the unrolled default, or --scan-blocks)."""
    from singa_tpu_torch.examples import gpt_lm

    argv = ["--device", "cpu", "--steps", "1", *flag]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gpt_lm.main(argv)
