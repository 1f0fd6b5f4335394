#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (singa_tpu_torch) on one card.

Run from the repository root on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in the checkout, timed;
3. hold the flash-attention forward kernel against its plain PyTorch
   version on the card: the fused layout at gpt_medium's shape (fp32,
   fp32 with mxu_bf16, bf16), the head-split layout with Tq != Tk
   (causal and not), head dims 32 and 64, causal rows with an empty
   set (Tq > Tk, exact 0); a tensor needing grad must be refused (the
   backward kernels come later); print max|d|, the kernel's,
   the plain version's and F.scaled_dot_product_attention's times (the
   last as a yardstick only, where its masking is the same) and the
   data-sheet bound;
4. the main path: gpt_medium at full width (seeded random weights carried
   in through load_singa_tpu_params) scores 4 x 1024 tokens with
   `model(ids)`, which must launch the kernel exactly 12 times, then
   `generate` answers 4 prompts of 224 tokens (48 new, window 256);
   the launch counts are read around exactly these two calls;
5. check the results: logits finite and equal to the same model with the
   kernel switched off; greedy tokens equal across two runs; the
   prefill's logits (plain attention) equal `model(ctx)` (the kernel) on
   the same padded window; print tokens/s;
6. print the `kernels` line, then the result line.

fp32 products run in full fp32: TF32 is off for matmuls and cuDNN.
"""

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet, HBM3
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}  # non-tensor fp32; dense bf16
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, tq, tk, d, causal, elem_bytes, kind):
    """Least time (ms) for one attention forward: the larger of bytes
    (q, k, v read once, O and lse written once) over the memory rate and
    the two products' operations on the (q, k) pairs this mask keeps
    over the peak rate for the operand type."""
    flops = 4.0 * b * h * kept_pairs(tq, tk, causal) * d
    nbytes = elem_bytes * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


CASES = [
    # name, layout, B, H, Tq, Tk, hd, causal, dtype, mxu_bf16, tolerance
    ("gpt_medium_fused_fp32", "fused", 4, 8, 1024, 1024, 128, True,
     "float32", False, 1e-4),
    ("gpt_medium_fused_fp32_mxu_bf16", "fused", 4, 8, 1024, 1024, 128,
     True, "float32", True, 2e-2),
    ("gpt_medium_fused_bf16", "fused", 4, 8, 1024, 1024, 128, True,
     "bfloat16", False, 2e-2),
    ("split_causal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, True,
     "float32", False, 1e-4),
    ("split_noncausal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, False,
     "float32", False, 1e-4),
    ("fused_hd64_t1000", "fused", 4, 16, 1000, 1000, 64, True, "float32",
     False, 1e-4),
    ("split_hd32_t500", "split", 4, 32, 500, 500, 32, True, "float32",
     False, 1e-4),
    # Tq > Tk causal: the first Tq - Tk rows see no key and must be 0
    ("split_empty_rows_tq200_tk70", "split", 2, 4, 200, 70, 64, True,
     "float32", False, 1e-4),
]
# Tolerances: fp32 kernel and plain version differ only in summation
# order (1e-4 on values of order 1); where operands or O are bf16, one
# bf16 rounding step of O (2^-9 relative) and p rounded at another
# running max than the plain version's whole-row max (2e-2).


def run_case(torch, fa, case):
    import torch.nn.functional as F

    name, layout, b, h, tq, tk, d, causal, dt, mxu, tol = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if layout == "fused":
        qkv = randn(b, tq, 3 * h * d)
        q, k, v = fa._split_qkv(qkv, h)
        out = torch.empty((b, tq, h * d), dtype=dtype, device="cuda")
        o = fa._heads(out, h)
    else:
        q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        o = torch.empty_like(q)
    scale = d ** -0.5
    lse = fa._flash_fwd(q, k, v, o, causal, scale, mxu)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal, scale, mxu)
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    empty = max(0, tq - tk) if causal else 0
    zero_rows = bool((o[:, :, :empty] == 0).all())
    ms = cuda_ms(torch, lambda: fa._flash_fwd(q, k, v, o, causal, scale,
                                              mxu))
    plain_ms = cuda_ms(torch, lambda: fa._flash_fwd_plain(
        q, k, v, causal, scale, mxu), iters=5)
    library_ms = library_err = None
    if not causal or tq <= tk:  # with Tq > Tk a row is empty: SDPA's NaN
        # SDPA's is_causal is top-left: give it the bottom-right mask
        mask = bottom_right(torch, tq, tk) if causal and tq != tk else None

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale,
                is_causal=causal and mask is None)

        library_err = (sdpa().float() - o_ref.float()).abs().max().item()
        library_ms = cuda_ms(torch, sdpa)
    kind = "bf16" if (mxu or dtype == torch.bfloat16) else "fp32"
    bound_ms, bound_by = attention_bound(b, h, tq, tk, d, causal,
                                         q.element_size(), kind)
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, max_abs_err=err_o,
               lse_max_abs_err=err_lse, tolerance=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=library_err, bound_ms=bound_ms,
               bound_by=bound_by, empty_rows=empty, empty_rows_zero=zero_rows,
               ok=err_o <= tol and err_lse <= tol and zero_rows)
    print("case " + json.dumps(row), flush=True)
    return row


def backward_bounds(b, h, tq, tk, d, causal, elem_bytes, kind):
    """Least times (ms, bound_by) for the attention backward, from this
    mask's kept (q, k) pairs: each kernel's own products and bytes (dQ:
    S, dP, dQ; dK/dV: S, dP, dV, dK; each reads q, k, v, dO, lse and
    delta once and writes its gradients once) and the whole backward
    (the five products; q, k, v, O, dO, lse, delta read, dq, dk, dv
    written)."""
    pairs = kept_pairs(tq, tk, causal)
    rows = 4 * b * h * tq * 2  # lse and delta, fp32
    q_b, kv_b = elem_bytes * b * h * tq * d, elem_bytes * b * h * tk * d
    reads = 2 * q_b + 2 * kv_b + rows  # q, dO, k, v, lse, delta
    out = {}
    for name, n_products, nbytes in (
            ("dq", 3, reads + q_b), ("dkv", 4, reads + 2 * kv_b),
            ("total", 5, reads + q_b + q_b + 2 * kv_b)):  # + O; dq dk dv
        flops = 2.0 * n_products * b * h * pairs * d
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes > t_ops else "operations")
    return out


def kept_pairs(tq, tk, causal):
    """(q, k) pairs the mask keeps: all, or k <= q + (Tk - Tq)."""
    if not causal:
        return tq * tk
    i = np.arange(tq)
    return int(np.clip(i + (tk - tq) + 1, 0, tk).sum())


def bottom_right(torch, tq, tk):
    """The bottom-right causal mask as SDPA's boolean attn_mask."""
    return torch.ones(tq, tk, dtype=torch.bool, device="cuda").tril(tk - tq)


BWD_CASES = [
    # name, layout, B, H, Tq, Tk, hd, causal, dtype, mxu_bf16,
    # lse cotangent, tolerance
    ("gpt_medium_fused_fp32", "fused", 4, 8, 1024, 1024, 128, True,
     "float32", False, False, 1e-4),
    ("gpt_medium_fused_fp32_mxu_bf16", "fused", 4, 8, 1024, 1024, 128,
     True, "float32", True, False, 2e-2),
    ("gpt_medium_fused_bf16", "fused", 4, 8, 1024, 1024, 128, True,
     "bfloat16", False, False, 2e-2),
    ("split_causal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, True,
     "float32", False, False, 1e-4),
    ("split_noncausal_tq384_tk1000", "split", 2, 8, 384, 1000, 128, False,
     "float32", False, False, 1e-4),
    ("fused_hd64_t1000", "fused", 4, 16, 1000, 1000, 64, True, "float32",
     False, False, 1e-4),
    ("split_hd32_t500", "split", 4, 32, 500, 500, 32, True, "float32",
     False, False, 1e-4),
    # Tq > Tk causal: the first Tq - Tk rows see no key; their dq is 0
    ("split_empty_rows_tq200_tk70", "split", 2, 4, 200, 70, 64, True,
     "float32", False, False, 1e-4),
    ("split_lse_cotangent_tq384_tk1000", "split", 2, 8, 384, 1000, 128,
     True, "float32", False, True, 1e-4),
]
# Tolerances are on max|d| / max(1, max|plain|) per gradient. fp32: the
# kernel and the plain version differ only in summation order (1e-4).
# bf16 inputs: each gradient is written in bf16 (2^-9 relative); with
# mxu_bf16, p and dS round to bf16 at scores that differ in the last bit
# from the plain version's (2e-2).


def run_bwd_case(torch, fa, case):
    """Hold the dQ and dK/dV kernels against `_flash_bwd_plain` on one
    case; time both kernels, the plain version, SDPA's backward (where
    its masking is the same) and give the bounds."""
    import torch.nn.functional as F

    (name, layout, b, h, tq, tk, d, causal, dt, mxu, with_glse,
     tol) = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def grads_like():
        """Fresh (dq, dk, dv): views into one (B, T, 3d) gradient of qkv
        in the fused layout."""
        if layout == "fused":
            return fa._split_qkv(torch.empty(
                (b, tq, 3 * h * d), dtype=dtype, device="cuda"), h)
        dq = torch.empty((b, h, tq, d), dtype=dtype, device="cuda")
        dk = torch.empty((b, h, tk, d), dtype=dtype, device="cuda")
        return dq, dk, torch.empty_like(dk)

    if layout == "fused":
        q, k, v = fa._split_qkv(randn(b, tq, 3 * h * d), h)
        out = torch.empty((b, tq, h * d), dtype=dtype, device="cuda")
        o = fa._heads(out, h)
        do = fa._heads(randn(b, tq, h * d), h)
    else:
        q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        o = torch.empty_like(q)
        do = randn(b, h, tq, d)
    scale = d ** -0.5
    lse = fa._flash_fwd(q, k, v, o, causal, scale, mxu)
    delta = (do.float() * o.float()).sum(-1)
    if with_glse:
        delta = delta - torch.randn(b, h, tq, generator=gen, device="cuda")

    def kernel():
        grads = grads_like()
        fa._flash_bwd(q, k, v, do, lse, delta, *grads, causal, scale, mxu)
        return grads

    before = (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    check((fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES)
          == (before[0] + 1, before[1] + 1),
          f"{name}: _flash_bwd did not launch both kernels once")
    again = kernel()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
    want = fa._flash_bwd_plain(q, k, v, do, lse, delta, causal, scale, mxu)
    errs, rel = {}, {}
    for gname, x, y in zip(("dq", "dk", "dv"), got, want):
        diff = (x.float() - y.float()).abs().max().item()
        errs[gname] = diff
        rel[gname] = diff / max(1.0, y.float().abs().max().item())
    empty = max(0, tq - tk) if causal else 0
    zero_rows = bool((got[0][:, :, :empty] == 0).all())

    dq_out, dk_out, dv_out = grads_like()
    ms_dq = cuda_ms(torch, lambda: fa._flash_bwd_dq(
        q, k, v, do, lse, delta, dq_out, causal, scale, mxu))
    ms_dkv = cuda_ms(torch, lambda: fa._flash_bwd_dkv(
        q, k, v, do, lse, delta, dk_out, dv_out, causal, scale, mxu))
    ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, lambda: fa._flash_bwd_plain(
        q, k, v, do, lse, delta, causal, scale, mxu), iters=5)

    library_ms = None
    if not with_glse and (not causal or tq <= tk):
        # SDPA's is_causal is top-left: give it the bottom-right mask
        mask = bottom_right(torch, tq, tk) if causal and tq != tk else None
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        ref_o = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale,
            is_causal=causal and mask is None)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref_o, (qs, ks, vs), do, retain_graph=True))
        del ref_o
    kind = "bf16" if (mxu or dtype == torch.bfloat16) else "fp32"
    bounds = backward_bounds(b, h, tq, tk, d, causal, q.element_size(),
                             kind)
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, lse_cotangent=with_glse,
               max_abs_err=errs, rel_err=rel, tolerance=tol, ms=ms,
               ms_dq=ms_dq, ms_dkv=ms_dkv, plain_ms=plain_ms,
               library_ms=library_ms,
               bound_ms={k: v[0] for k, v in bounds.items()},
               bound_by={k: v[1] for k, v in bounds.items()},
               empty_rows=empty, empty_rows_zero=zero_rows,
               bitwise_repeat=bitwise,
               ok=max(rel.values()) <= tol and zero_rows and bitwise)
    print("bwd_case " + json.dumps(row), flush=True)
    return row


def seeded_params(model, seed):
    """Random weights for every parameter, from numpy with `seed`, with
    the scales of the reference's initialisers."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".table"):
            a = 0.1 * rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith(("ln1_s", "ln2_s", "scale")):
            a = 1.0 + 0.05 * rng.standard_normal(shape, dtype=np.float32)
        elif len(shape) >= 2:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(shape[-2] ** -0.5)
        else:
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        out[name] = a
    return out




def ptxas_summary(log):
    """One line per kernel from nvcc's -Xptxas -v report: registers and
    spill bytes."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .\S*?(flash_[a-z_]+_kernel)"
                      r"ILi(\d+)E(f|13__nv_bfloat16)", line)
        if m:
            name = (f"{m.group(1)}<{m.group(2)}, "
                    f"{'float' if m.group(3) == 'f' else 'bf16'}>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def counts(fa):
    return {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES}


def reset_counts(fa):
    fa.FLASH_FWD_LAUNCHES = 0
    fa.FLASH_BWD_DQ_LAUNCHES = 0
    fa.FLASH_BWD_DKV_LAUNCHES = 0


def main_grads(torch, model, x, y):
    """{name: grad} of the mean next-token loss at the current weights."""
    from singa_tpu_torch import autograd

    loss = autograd.softmax_cross_entropy(
        model.forward(x).reshape(-1, model.vocab_size), y.reshape(-1))
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}


def train_path(torch, fa, model, rng):
    """The training path: gpt_medium, AdamW(lr=3e-4), compile, kernel-on
    against kernel-off gradients, one counted step, five more, one bf16
    step. Returns the launches of the counted step and the numbers."""
    from singa_tpu_torch import autograd, opt

    seq = torch.from_numpy(rng.integers(0, model.vocab_size,
                                        (4, 1025))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    model.set_optimizer(opt.AdamW(lr=3e-4))
    model.compile([x], is_train=True, use_graph=True)

    # gradients with the kernels on and off, at the seeded weights
    on = main_grads(torch, model, x, y)
    fa.set_flash_enabled(False)
    try:
        off = main_grads(torch, model, x, y)
    finally:
        fa.set_flash_enabled(True)
    check(sorted(on) == sorted(off) == sorted(
        n for n, _ in model.named_parameters()), "gradients not complete")
    grad_tol = 1e-3  # of each parameter's max|grad|; summation order only
    worst = max((on[n] - off[n]).abs().max().item()
                / max(off[n].abs().max().item(), 1e-30) for n in on)
    print(f"train grads, kernels on vs off: worst max|d| / max|grad| "
          f"{worst:.3e} over {len(on)} parameters (tol {grad_tol})",
          flush=True)
    check(worst <= grad_tol, "kernel-path gradients disagree")
    del on, off

    # one step, counted alone
    torch.cuda.synchronize()
    reset_counts(fa)
    t = time.perf_counter()
    _, loss = model(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = counts(fa)
    print(f"train step 1: {first_s:.3f} s, launches {launches}",
          flush=True)
    check(launches == {"flash_fwd": 12, "flash_bwd_dq": 12,
                       "flash_bwd_dkv": 12},
          f"one step launched {launches}, not 12 of each kernel")
    losses = [loss.item()]
    step_s = []
    for _ in range(5):
        t = time.perf_counter()
        _, loss = model(x, y)
        losses.append(loss.item())  # waits for the step's end
        step_s.append(time.perf_counter() - t)
    step_ms = 1e3 * sum(step_s) / len(step_s)
    print(f"train losses {losses}", flush=True)
    print(f"train: {step_ms:.2f} ms per 4x1024 step (mean of steps 2-6), "
          f"{4 * 1024 / step_ms * 1e3:.1f} tokens/s", flush=True)
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "the loss did not fall over 6 steps")

    # one bf16 step: autocast on, so the kernels get bf16 operands
    seen = []
    real_fwd, real_bwd = fa._flash_fwd, fa._flash_bwd
    fa._flash_fwd = lambda q, *a: seen.append(("fwd", q.dtype)) or real_fwd(
        q, *a)
    fa._flash_bwd = lambda q, *a: seen.append(("bwd", q.dtype)) or real_bwd(
        q, *a)
    try:
        model.compile([x], is_train=True, use_graph=True, precision="bf16")
        reset_counts(fa)
        t = time.perf_counter()
        _, loss_bf16 = model(x, y)
        loss_bf16 = loss_bf16.item()
        bf16_s = time.perf_counter() - t
        bf16_launches = counts(fa)
    finally:
        fa._flash_fwd, fa._flash_bwd = real_fwd, real_bwd
        autograd.set_autocast(False)
    print(f"train bf16 step: loss {loss_bf16:.4f}, {bf16_s:.3f} s (first "
          f"bf16 step), launches {bf16_launches}, kernel operand dtypes "
          f"{sorted(set(str(d) for _, d in seen))}", flush=True)
    check(np.isfinite(loss_bf16), "non-finite bf16 loss")
    check(bf16_launches == launches, "the bf16 step launched otherwise")
    check({d for _, d in seen} == {torch.bfloat16} and
          {k for k, _ in seen} == {"fwd", "bwd"},
          "the bf16 step did not run the kernels on bf16 operands")
    model.eval()
    return launches, dict(step_ms=step_ms, tokens_per_s=4 * 1024 / step_ms
                          * 1e3, losses=losses, grad_rel_err=worst,
                          loss_bf16=loss_bf16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build, one nvcc per source, all started together
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name in sorted(libs):
        for line in ptxas_summary(_build.build_log(name)):
            print(f"ptxas {line}", flush=True)

    # 3. the kernels against their plain versions
    rows = [run_case(torch, fa, c) for c in CASES]
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"forward kernel disagrees with its plain version: {bad}")
    bwd_rows = [run_bwd_case(torch, fa, c) for c in BWD_CASES]
    bad = [r["case"] for r in bwd_rows if not r["ok"]]
    check(not bad, f"backward kernels disagree with their plain version, "
                   f"repeat or leave an empty row non-zero: {bad}")

    # 4. the scoring and generate paths, counted
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, SEED))
    model.eval()
    rng = np.random.default_rng(SEED)
    vocab = model.vocab_size
    ids = torch.from_numpy(rng.integers(0, vocab, (4, 1024))).cuda()
    prompts = rng.integers(0, vocab, (4, 224))
    torch.cuda.synchronize()

    reset_counts(fa)
    with torch.inference_mode():
        t = time.perf_counter()
        logits = model(ids)
        torch.cuda.synchronize()
        fwd_first_s = time.perf_counter() - t
    fwd_launches = fa.FLASH_FWD_LAUNCHES
    t = time.perf_counter()
    toks = model.generate(prompts, n_new=48, window=256)
    gen_first_s = time.perf_counter() - t
    serve_launches = counts(fa)
    print(f"serve path: forward {fwd_first_s:.3f} s ({fwd_launches} kernel "
          f"launches), generate {gen_first_s:.3f} s; launches "
          f"{serve_launches}", flush=True)
    check(fwd_launches == 12,
          f"model(ids) launched the kernel {fwd_launches} times, not 12")
    check(serve_launches["flash_bwd_dq"] == 0, "scoring ran a backward")

    # 5. results of the serving path
    check(tuple(logits.shape) == (4, 1024, vocab), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.inference_mode():
        fa.set_flash_enabled(False)
        try:
            logits_plain = model(ids)
        finally:
            fa.set_flash_enabled(True)
    err = (logits - logits_plain).abs().max().item()
    tol = 2e-3  # fp32 through 12 post-LN blocks; summation order differs
    print(f"forward logits vs kernel off: max|d| {err:.3e} (tol {tol})",
          flush=True)
    check(err <= tol, "forward logits disagree with the plain attention")
    del logits_plain

    with torch.inference_mode():
        fwd_ms = cuda_ms(torch, lambda: model(ids), iters=5, warmup=1)
    print(f"forward: {fwd_ms:.3f} ms per 4x1024 batch, "
          f"{4 * 1024 / fwd_ms * 1e3:.1f} tokens/s", flush=True)

    check(toks.shape == (4, 272), f"generate shape {toks.shape}")
    check(np.array_equal(toks[:, :224], prompts), "prompt not preserved")
    check(bool(((toks >= 0) & (toks < vocab)).all()), "token out of range")
    t = time.perf_counter()
    toks2 = model.generate(prompts, n_new=48, window=256)
    gen_s = time.perf_counter() - t
    check(np.array_equal(toks, toks2), "greedy generate is not deterministic")
    print(f"generate: {gen_s:.3f} s for 4 x 48 new tokens, "
          f"{4 * 48 / gen_s:.1f} tokens/s (32 grow + 16 slide steps)",
          flush=True)

    prefill = model._decode_fns(256)[0]
    ctx = torch.zeros((4, 256), dtype=torch.long, device="cuda")
    ctx[:, :224] = torch.from_numpy(prompts).cuda()
    with torch.inference_mode():
        logits_prefill, _, _ = prefill(model._functional_params(), ctx)
        logits_kernel = model(ctx)
    err_p = (logits_prefill[:, :224] - logits_kernel[:, :224]).abs().max()
    err_p = err_p.item()
    print(f"prefill (plain) vs model(ctx) (kernel): max|d| {err_p:.3e} "
          f"(tol {tol})", flush=True)
    check(err_p <= tol, "prefill logits disagree with the kernel path")
    del logits, logits_kernel, logits_prefill

    # 6. the training path, counted around one step
    train_launches, train = train_path(torch, fa, model, rng)

    # 7. report
    fwd, bwd = rows[0], bwd_rows[0]
    common = dict(route="cuda", shape=fwd["shape"], card=card)
    kernels = [
        dict(name="flash_fwd", source="singa_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="singa_tpu/ops/flash_attention.py:829",
             also_replaces="singa_tpu/ops/flash_attention.py:263",
             launches=train_launches["flash_fwd"],
             launches_by_path={"score": fwd_launches,
                               "train_step": train_launches["flash_fwd"]},
             max_abs_err=fwd["max_abs_err"], ms=fwd["ms"],
             plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
             **common)]
    for name, key, sites in (
            ("flash_bwd_dq", "dq", (":872", ":426")),
            ("flash_bwd_dkv", "dkv", (":911", ":449"))):
        kernels.append(dict(
            name=name, source="singa_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"singa_tpu/ops/flash_attention.py{sites[0]}",
            also_replaces=f"singa_tpu/ops/flash_attention.py{sites[1]}",
            launches=train_launches[name],
            max_abs_err=max(bwd["max_abs_err"][g] for g in (
                ("dq",) if key == "dq" else ("dk", "dv"))),
            ms=bwd[f"ms_{key}"], plain_ms=bwd["plain_ms"],
            bound_ms=bwd["bound_ms"][key], bound_by=bwd["bound_by"][key],
            library_ms=bwd["library_ms"],
            plain_and_library_compute="dq, dk and dv together",
            **common))
    print("train " + json.dumps(train), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
