#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (singa_tpu_torch) on one card.

Run from the repository root on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in the order they run (any failure raises and exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in the checkout (one nvcc per
   source, all started together) and print each kernel's registers and
   spills; then a census of the kernels' SASS (`cuobjdump -sass`):
   tensor-core products (HMMA, HGMMA), asynchronous or 16-byte global
   loads (LDGSTS, UTMALDG, LDG.E.128) and ldmatrix (LDSM) per kernel
   instantiation; every instantiation of the forward, the dQ and the
   dK/dV kernel must have products and such loads, and the max-pool
   backward's 16-byte vector instantiations such loads;
3. hold the flash-attention forward kernel against its plain PyTorch
   version: the fused layout at gpt_medium's shape (fp32, fp32 with
   mxu_bf16, bf16), the head-split layout with Tq != Tk (causal and
   not), head dims 32 and 64, causal rows with no key (Tq > Tk, exact 0);
   print max|d|, the kernel's, the plain version's and
   F.scaled_dot_product_attention's times (the last as a yardstick only,
   where its masking is the same) and the data-sheet bound at the rate of
   the kernel's arithmetic (fp32: three TF32 passes, 165 TFLOP/s; bf16:
   989), with the fp32 FMA figure (67 TFLOP/s) beside it;
4. the same for the dQ and dK/dV backward kernels (9 cases, with bitwise
   repeats, exact-zero empty rows and an lse cotangent);
5. hold the max-pool backward kernel (K2a) against its plain version on
   ReLU-clamped inputs (exact-zero ties): the reference's eight cases,
   the ResNet-50 stem shape in fp32 and bf16 (which must take the
   kernel's 16-byte vector route), the pools of vgg16_cifar,
   alexnet_cifar and the ImageNet AlexNet at batch 128, a plateau of
   tied values (x rounded to a few levels) under overlapping k3 s1 p1
   windows at batch 128, x in channels-first memory (which must take
   the kernel's one-channel route, in fp32 and bf16) and k7 s1 windows
   (taken in chunks);
   the same selected positions, max|d| within 1e-6 (fp32) or 1e-2 (bf16)
   of max(1, max|plain|), a bitwise repeat; and the default route
   (PyTorch's max-pool backward) must pick the same positions; print the
   kernel's, the plain version's and that library backward's times and
   the bytes bound;
6. gpt_medium at full width (seeded random weights carried in through
   load_singa_tpu_params) scores 4 x 1024 tokens with `model(ids)`,
   which must launch the forward kernel exactly 12 times, then
   `generate` answers 4 prompts of 224 tokens (48 new, window 256); the
   logits equal the same model with the kernel off, greedy tokens
   repeat, the prefill's logits equal `model(ctx)`; print tokens/s;
7. gpt_medium trains on 4 x 1024 with AdamW: kernel-on against
   kernel-off gradients, one step counted alone (exactly 12 launches of
   each flash kernel), 6 steps whose loss must fall, one bf16 step;
8. ResNet-50 at full width trains on a seeded (128, 3, 224, 224) batch
   through the reference's entry points (`resnet50`, seeded states
   through load_singa_tpu_states, `set_image_layout("NHWC")`, SGD(lr
   0.05, momentum 0.9), `compile(..., precision="fp32")`, `model(x, y)`)
   with the max-pool kernel switched on: kernel-on against kernel-off
   gradients, one step counted alone (exactly 1 K2a launch; 0 with the
   switch off), 6 steps whose loss must fall, moved and finite
   BatchNorm statistics, a finite eval-mode forward, images/s with the
   switch on and off in turns, one bf16 step that runs the kernel on
   bf16;
9. print the `kernels` line (gpt_medium's fused fp32 shape, with the
   bf16 figures and the SASS census beside), then the result line.

fp32 products run in full fp32: TF32 is off for matmuls and cuDNN.
"""

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet, HBM3
# H100 SXM data sheet, dense: fp32 outside the tensor cores; fp32 as three
# TF32 passes on the tensor cores (495 / 3); bf16
PEAK_FLOPS = {"fp32": 67e12, "tf32x3": 495e12 / 3, "bf16": 989e12}
#: SASS opcodes counted per kernel: tensor-core products, asynchronous or
#: 16-byte global loads, and ldmatrix
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "LDG.E.128", "LDSM")
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
    over the peak rate of `kind` (a key of PEAK_FLOPS)."""
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
    bf16 = mxu or dtype == torch.bfloat16
    # fp32 products run as three TF32 passes; the FMA figure stays beside
    bound_ms, bound_by = attention_bound(b, h, tq, tk, d, causal,
                                         q.element_size(),
                                         "bf16" if bf16 else "tf32x3")
    bound_fma_ms = attention_bound(b, h, tq, tk, d, causal,
                                   q.element_size(),
                                   "bf16" if bf16 else "fp32")[0]
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, max_abs_err=err_o,
               lse_max_abs_err=err_lse, tolerance=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=library_err, bound_ms=bound_ms,
               bound_fma_ms=bound_fma_ms,
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
    written). `kind` is a key of PEAK_FLOPS."""
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
    bf16 = mxu or dtype == torch.bfloat16
    fma = backward_bounds(b, h, tq, tk, d, causal, q.element_size(),
                          "bf16" if bf16 else "fp32")
    tc = backward_bounds(b, h, tq, tk, d, causal, q.element_size(),
                         "bf16" if bf16 else "tf32x3")
    # both kernels run on the tensor cores (three TF32 passes in fp32):
    # their bounds at that rate, the FMA figures beside
    bounds = tc
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, lse_cotangent=with_glse,
               max_abs_err=errs, rel_err=rel, tolerance=tol, ms=ms,
               ms_dq=ms_dq, ms_dkv=ms_dkv, plain_ms=plain_ms,
               library_ms=library_ms,
               bound_ms={k: v[0] for k, v in bounds.items()},
               bound_by={k: v[1] for k, v in bounds.items()},
               bound_fma_ms={k: v[0] for k, v in fma.items()},
               empty_rows=empty, empty_rows_zero=zero_rows,
               bitwise_repeat=bitwise,
               ok=max(rel.values()) <= tol and zero_rows and bitwise)
    print("bwd_case " + json.dumps(row), flush=True)
    return row


POOL_CASES = [
    # name, x (N, H, W, C), window, strides, pads, dtype, options
    # ("levels": x rounded to multiples of 1/levels, plateaus of ties;
    # "channels_first": x in NCHW memory, the kernel's scalar route); the
    # first eight are the reference's (tests/test_max_pool_kernel.py)
    ("ref_stem_like", (2, 16, 16, 8), (3, 3), (2, 2), (1, 1), "float32",
     {}),
    ("ref_odd_hw", (2, 15, 17, 8), (3, 3), (2, 2), (1, 1), "float32", {}),
    ("ref_k2s2_bf16", (2, 16, 16, 8), (2, 2), (2, 2), (0, 0), "bfloat16",
     {}),
    ("ref_asymmetric", (1, 9, 11, 4), (3, 2), (1, 2), (1, 0), "float32",
     {}),
    ("ref_stride1", (2, 12, 12, 8), (3, 3), (1, 1), (1, 1), "float32",
     {}),
    ("ref_c16", (2, 16, 16, 16), (3, 3), (2, 2), (1, 1), "float32", {}),
    ("ref_odd_h_bf16", (1, 14, 16, 8), (3, 3), (2, 2), (1, 1), "bfloat16",
     {}),
    ("ref_c64_bf16", (2, 16, 16, 64), (3, 3), (2, 2), (1, 1), "bfloat16",
     {}),
    # the main path's shape first: ResNet-50's stem max-pool at batch 128
    ("resnet50_stem_fp32", (128, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     "float32", {}),
    ("resnet50_stem_bf16", (128, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     "bfloat16", {}),
    ("vgg16_cifar_first_pool", (128, 32, 32, 64), (2, 2), (2, 2), (0, 0),
     "float32", {}),
    ("alexnet_cifar_first_pool", (128, 16, 16, 64), (2, 2), (2, 2), (0, 0),
     "float32", {}),
    ("alexnet_first_pool", (128, 55, 55, 64), (3, 3), (2, 2), (0, 0),
     "float32", {}),
    # first-match ties at size: x in {0, 0.5, 1, ...}, overlapping windows
    ("plateau_k3s1p1", (128, 56, 56, 64), (3, 3), (1, 1), (1, 1),
     "float32", {"levels": 2}),
    # the kernel's other routes: one channel per item, windows in chunks
    ("channels_first_scalar_route", (16, 28, 28, 64), (3, 3), (2, 2),
     (1, 1), "float32", {"channels_first": True}),
    ("k7_s1_chunked", (16, 28, 28, 64), (7, 7), (1, 1), (3, 3),
     "float32", {}),
    ("channels_first_scalar_route_bf16", (16, 28, 28, 64), (3, 3), (2, 2),
     (1, 1), "bfloat16", {"channels_first": True}),
]
POOL_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# Tolerances are on max|d| / max(1, max|plain|): both sum at most
# ceil(k/s)^2 values of dy in fp32, in another order (fp32: 1e-6); in bf16
# dx is rounded once to bf16 from sums that may differ in the last fp32
# bit (1e-2, as the reference's own test holds its kernel).


def run_pool_case(torch, mp, case):
    """Hold the max-pool backward kernel against `_max_pool_bwd_plain`
    and PyTorch's default route (its max-pool backward) on one case; time
    the kernel, the plain version and that library backward."""
    name, shape, win, strd, pad, dt, opts = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn(shape, generator=gen, device="cuda").clamp_min(0)
    if "levels" in opts:
        x = (x * opts["levels"]).round() / opts["levels"]
    x = x.to(dtype)
    if opts.get("channels_first"):
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    y = mp._fwd(x, win, strd, pad)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    # the kernel's route for these operands (dx as the wrapper makes it)
    vector_width = mp._vector_width(x, y, dy, torch.empty(
        shape, dtype=dtype, device="cuda"))

    before = mp.MAX_POOL_BWD_LAUNCHES
    got = mp._max_pool_bwd(x, y, dy, win, strd, pad)
    torch.cuda.synchronize()
    check(mp.MAX_POOL_BWD_LAUNCHES == before + 1,
          f"{name}: _max_pool_bwd did not launch the kernel once")
    bitwise = torch.equal(got, mp._max_pool_bwd(x, y, dy, win, strd, pad))
    want = mp._max_pool_bwd_plain(x, y, dy, win, strd, pad)
    same = torch.equal(got != 0, want != 0)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(1.0, want.float().abs().max().item())

    # the default route: PyTorch's max-pool and its autograd backward
    xg = x.detach().requires_grad_()
    mp.set_pool_kernel_enabled(False)
    (default,) = torch.autograd.grad(mp.maxpool2d_nhwc(xg, win, strd, pad),
                                     xg, dy)
    default_same = torch.equal(default != 0, want != 0)
    default_rel = ((default.float() - want.float()).abs().max().item()
                   / max(1.0, want.float().abs().max().item()))

    xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, idx = torch.ops.aten.max_pool2d_with_indices(xn, win, strd, pad)

    def library():
        return torch.ops.aten.max_pool2d_with_indices_backward(
            dyn, xn, win, strd, pad, (1, 1), False, idx)

    ms = cuda_ms(torch, lambda: mp._max_pool_bwd(x, y, dy, win, strd, pad))
    plain_ms = cuda_ms(torch, lambda: mp._max_pool_bwd_plain(
        x, y, dy, win, strd, pad), iters=5)
    library_ms = cuda_ms(torch, library)
    nbytes = x.element_size() * 2 * (x.numel() + y.numel())
    row = dict(case=name, shape=list(shape), window=list(win),
               strides=list(strd), pads=list(pad), dtype=dt, options=opts,
               vector_width=vector_width, max_abs_err=err, rel_err=rel,
               tolerance=POOL_TOL[dt],
               same_positions=same, bitwise_repeat=bitwise,
               default_route_same_positions=default_same,
               default_route_rel_err=default_rel, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=nbytes / PEAK_BYTES_S * 1e3,
               bound_by="bytes",
               ok=(same and bitwise and rel <= POOL_TOL[dt] and default_same
                   and default_rel <= POOL_TOL[dt]))
    print("pool_case " + json.dumps(row), flush=True)
    return row


def cnn_states(shapes, seed):
    """Seeded values, from numpy, for a CNN's parameters and buffers given
    as {name: shape}: He-scaled OIHW conv weights, (in, out) Linear
    weights at 1/sqrt(in), BatchNorm scales near 1, small offsets and
    biases, running statistics near (0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        shape = tuple(shape)
        a = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("running_var"):
            a = 1.0 + 0.2 * rng.random(shape, dtype=np.float32)
        elif name.endswith("scale"):
            a = 1.0 + 0.1 * a
        elif len(shape) == 4:
            a *= np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
        elif len(shape) == 2:
            a *= np.float32(shape[0] ** -0.5)
        else:  # biases, offsets, running means
            a *= np.float32(0.1)
        out[name] = a
    return out


def cnn_grads(model, x, y):
    """{name: grad} of the mean cross-entropy at the current weights, in
    training mode; the BatchNorm running statistics are put back."""
    import torch

    from singa_tpu_torch import autograd

    buffers = {k: b.clone() for k, b in model.named_buffers()}
    loss = autograd.softmax_cross_entropy(model.forward(x), y)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(buffers[k])
    return grads


def resnet_path(torch, fa, mp):
    """ResNet-50 at full width trains on one seeded ImageNet-shape batch
    with the max-pool kernel on (the sequence of bench.py's
    bench_framework). Returns the counted step's launches and the
    numbers."""
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_states
    from singa_tpu_torch.models.resnet import resnet50

    m = resnet50(num_classes=1000, device="cuda")
    states = cnn_states({n: t.shape for n, t in [*m.named_parameters(),
                                                 *m.named_buffers()]}, SEED)
    load_singa_tpu_states(m, states)
    m.set_image_layout("NHWC")
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    batch = 128
    x = torch.randn((batch, 3, 224, 224), generator=gen, device="cuda")
    y = torch.arange(batch, device="cuda") % 1000
    mp.set_pool_kernel_enabled(True)
    t = time.perf_counter()
    m.compile([x], is_train=True, use_graph=True, precision="fp32")
    torch.cuda.synchronize()
    print(f"resnet50: {sum(p.numel() for p in m.parameters())} parameters, "
          f"compile {time.perf_counter() - t:.3f} s", flush=True)

    # gradients with the kernel on and off, at the seeded weights
    on = cnn_grads(m, x, y)
    mp.set_pool_kernel_enabled(False)
    off = cnn_grads(m, x, y)
    mp.set_pool_kernel_enabled(True)
    check(sorted(on) == sorted(off) == sorted(
        n for n, _ in m.named_parameters()), "resnet gradients not complete")
    grad_tol = 1e-3  # of each parameter's max|grad|: cuDNN's order only
    worst = max((on[n] - off[n]).abs().max().item()
                / max(off[n].abs().max().item(), 1e-30) for n in on)
    print(f"resnet50 grads, max-pool kernel on vs off: worst max|d| / "
          f"max|grad| {worst:.3e} over {len(on)} parameters (tol "
          f"{grad_tol})", flush=True)
    check(worst <= grad_tol, "kernel-path ResNet gradients disagree")
    del on, off

    # one step, counted alone
    torch.cuda.synchronize()
    reset_counts(fa, mp)
    t = time.perf_counter()
    _, loss = m(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = counts(fa, mp)
    print(f"resnet50 step 1: {first_s:.3f} s, launches {launches}",
          flush=True)
    check(launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0, "max_pool_bwd": 1},
          f"one ResNet-50 step launched {launches}, not 1 max-pool kernel")
    losses = [loss.item()]
    for _ in range(5):
        _, loss = m(x, y)
        losses.append(loss.item())
    print(f"resnet50 losses {losses}", flush=True)
    check(all(np.isfinite(losses)), "non-finite ResNet-50 loss")
    check(losses[-1] < losses[0], "the ResNet-50 loss did not fall")

    # BatchNorm: the running statistics moved and are finite
    moved = finite = 0
    for k, b in m.named_buffers():
        finite += int(bool(torch.isfinite(b).all()))
        moved += int(not np.array_equal(b.cpu().numpy(), states[k]))
    n_buf = len(list(m.named_buffers()))
    print(f"resnet50 BatchNorm buffers: {moved}/{n_buf} moved, "
          f"{finite}/{n_buf} finite", flush=True)
    check(moved == finite == n_buf, "BatchNorm statistics did not move or "
                                    "are not finite")
    m.eval()
    with torch.inference_mode():
        scores = m(x)
    m.train()
    check(tuple(scores.shape) == (batch, 1000)
          and bool(torch.isfinite(scores).all()),
          "eval-mode ResNet-50 scores are not finite (128, 1000)")
    del scores

    # throughput with the switch on and off, in turns (on, off, off, on)
    rates = {True: [], False: []}
    for enabled in (True, False, False, True):
        mp.set_pool_kernel_enabled(enabled)
        m(x, y)  # the first step after a switch is not timed
        torch.cuda.synchronize()
        reset_counts(fa, mp)
        t = time.perf_counter()
        for _ in range(5):
            _, loss = m(x, y)
        loss.item()
        dt = time.perf_counter() - t
        check(mp.MAX_POOL_BWD_LAUNCHES == (5 if enabled else 0),
              f"switch {enabled}: {mp.MAX_POOL_BWD_LAUNCHES} launches in "
              f"5 steps")
        rates[enabled].append(5 * batch / dt)
    mp.set_pool_kernel_enabled(True)
    on_rate, off_rate = (float(np.mean(rates[k])) for k in (True, False))
    print(f"resnet50 fp32 training: {on_rate:.1f} images/s with the "
          f"max-pool kernel, {off_rate:.1f} without (windows of 5 steps, "
          f"on/off/off/on: {rates[True]} / {rates[False]})", flush=True)

    # one bf16 step from the seeded states: autocast on, so the kernel
    # gets bf16 operands
    load_singa_tpu_states(m, states)
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    seen = []
    real = mp._max_pool_bwd
    mp._max_pool_bwd = lambda x_, *a: seen.append(x_.dtype) or real(x_, *a)
    try:
        m.compile([x], is_train=True, use_graph=True, precision="bf16")
        reset_counts(fa, mp)
        _, loss_bf16 = m(x, y)
        loss_bf16 = loss_bf16.item()
        bf16_launches = counts(fa, mp)
    finally:
        mp._max_pool_bwd = real
        autograd.set_autocast(False)
    print(f"resnet50 bf16 step: loss {loss_bf16:.4f}, launches "
          f"{bf16_launches}, kernel operand dtypes {seen}", flush=True)
    check(np.isfinite(loss_bf16), "non-finite bf16 ResNet-50 loss")
    check(bf16_launches == launches, "the bf16 step launched otherwise")
    check(seen == [torch.bfloat16], "the bf16 step did not run the "
                                    "max-pool kernel on bf16 operands")
    mp.set_pool_kernel_enabled(False)
    return launches, dict(images_per_s_kernel_on=on_rate,
                          images_per_s_kernel_off=off_rate,
                          rates=[rates[True], rates[False]], losses=losses,
                          grad_rel_err=worst, loss_bf16=loss_bf16,
                          first_step_s=first_s)


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




def kernel_name(mangled):
    """`flash_fwd_kernel<128, float, 0>` for a mangled kernel
    instantiation in `mangled`, or None."""
    import re

    m = re.search(
        r"([a-z_]+_kernel)I((?:Li-?\d+E|Lb[01]E|f|13__nv_bfloat16)+)E",
        mangled)
    if not m:
        return None
    names = {"f": "float", "13__nv_bfloat16": "bf16", "0": "false",
             "1": "true"}
    args = re.findall(r"Li(-?\d+)E|Lb([01])E|(f|13__nv_bfloat16)",
                      m.group(2))
    return f"{m.group(1)}<" + ", ".join(num or names[flag or typ]
                                        for num, flag, typ in args) + ">"


def ptxas_summary(log):
    """One line per kernel from nvcc's -Xptxas -v report: registers and
    spill bytes."""
    import re

    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def sass_census(lib_path, cuobjdump):
    """{kernel instantiation: {opcode: count}} of SASS_OPS in a built
    library, from `cuobjdump -sass`."""
    import re

    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    census, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = kernel_name(line)
            if name:
                census[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            op = m.group(1)
            base = op.split(".")[0]
            if base in census[name]:
                census[name][base] += 1
            elif base == "LDG" and ".128" in op:
                census[name]["LDG.E.128"] += 1
    return census


def counts(fa, mp):
    """Every kernel's launch count."""
    return {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
            "max_pool_bwd": mp.MAX_POOL_BWD_LAUNCHES}


def reset_counts(fa, mp):
    fa.FLASH_FWD_LAUNCHES = 0
    fa.FLASH_BWD_DQ_LAUNCHES = 0
    fa.FLASH_BWD_DKV_LAUNCHES = 0
    mp.MAX_POOL_BWD_LAUNCHES = 0


def main_grads(torch, model, x, y):
    """{name: grad} of the mean next-token loss at the current weights."""
    from singa_tpu_torch import autograd

    loss = autograd.softmax_cross_entropy(
        model.forward(x).reshape(-1, model.vocab_size), y.reshape(-1))
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}


def train_path(torch, fa, mp, model, rng):
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
    reset_counts(fa, mp)
    t = time.perf_counter()
    _, loss = model(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = counts(fa, mp)
    print(f"train step 1: {first_s:.3f} s, launches {launches}",
          flush=True)
    check(launches == {"flash_fwd": 12, "flash_bwd_dq": 12,
                       "flash_bwd_dkv": 12, "max_pool_bwd": 0},
          f"one step launched {launches}, not 12 of each flash kernel")
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
        reset_counts(fa, mp)
        t = time.perf_counter()
        _, loss_bf16 = model(x, y)
        loss_bf16 = loss_bf16.item()
        bf16_s = time.perf_counter() - t
        bf16_launches = counts(fa, mp)
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
    from singa_tpu_torch.ops import max_pool as mp

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
    # the SASS of the tensor-core kernels: their products and copies
    from pathlib import Path

    cuobjdump = str(Path(_build._find_nvcc()).parent / "cuobjdump")
    sass = {}
    for name in ("flash_fwd", "flash_bwd", "max_pool_bwd"):
        for fn, ops in sass_census(libs[name], cuobjdump).items():
            sass[fn] = ops
            print(f"sass {fn}: " + ", ".join(f"{k} {v}" for k, v in
                                             ops.items()), flush=True)

    def wide_loads(ops):
        return ops["LDGSTS"] + ops["UTMALDG"] + ops["LDG.E.128"] > 0

    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel"):
        insts = {fn: ops for fn, ops in sass.items()
                 if fn.startswith(kernel + "<")}
        check(insts and all(ops["HMMA"] + ops["HGMMA"] > 0
                            and wide_loads(ops) for ops in insts.values()),
              f"{kernel}: an instantiation without tensor-core products or "
              f"asynchronous / 16-byte loads in its SASS: {insts}")
    # the max-pool backward's 16-byte channel-vector instantiations
    insts = {fn: ops for fn, ops in sass.items() if fn.startswith((
        "max_pool_bwd_kernel<float, 4,", "max_pool_bwd_kernel<bf16, 8,"))}
    check(len(insts) == 4 and all(wide_loads(o) for o in insts.values()),
          f"max_pool_bwd_kernel: a vector instantiation without 16-byte or "
          f"asynchronous loads in its SASS: {insts}")

    # 3-5. the kernels against their plain versions
    rows = [run_case(torch, fa, c) for c in CASES]
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"forward kernel disagrees with its plain version: {bad}")
    bwd_rows = [run_bwd_case(torch, fa, c) for c in BWD_CASES]
    bad = [r["case"] for r in bwd_rows if not r["ok"]]
    check(not bad, f"backward kernels disagree with their plain version, "
                   f"repeat or leave an empty row non-zero: {bad}")
    pool_rows = [run_pool_case(torch, mp, c) for c in POOL_CASES]
    bad = [r["case"] for r in pool_rows if not r["ok"]]
    check(not bad, f"max-pool kernel or default route disagrees with the "
                   f"plain version, or does not repeat: {bad}")
    routes = {r["case"]: r["vector_width"] for r in pool_rows}
    check(routes["resnet50_stem_fp32"] == 4
          and routes["resnet50_stem_bf16"] == 8
          and routes["channels_first_scalar_route"] == 1
          and routes["channels_first_scalar_route_bf16"] == 1,
          f"the stem cases did not take the 16-byte vector route, or the "
          f"channels-first case not the scalar one: {routes}")

    # 6. the scoring and generate paths, counted
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, SEED))
    model.eval()
    rng = np.random.default_rng(SEED)
    vocab = model.vocab_size
    ids = torch.from_numpy(rng.integers(0, vocab, (4, 1024))).cuda()
    prompts = rng.integers(0, vocab, (4, 224))
    torch.cuda.synchronize()

    reset_counts(fa, mp)
    with torch.inference_mode():
        t = time.perf_counter()
        logits = model(ids)
        torch.cuda.synchronize()
        fwd_first_s = time.perf_counter() - t
    fwd_launches = fa.FLASH_FWD_LAUNCHES
    t = time.perf_counter()
    toks = model.generate(prompts, n_new=48, window=256)
    gen_first_s = time.perf_counter() - t
    serve_launches = counts(fa, mp)
    print(f"serve path: forward {fwd_first_s:.3f} s ({fwd_launches} kernel "
          f"launches), generate {gen_first_s:.3f} s; launches "
          f"{serve_launches}", flush=True)
    check(fwd_launches == 12,
          f"model(ids) launched the kernel {fwd_launches} times, not 12")
    check(serve_launches["flash_bwd_dq"] == 0, "scoring ran a backward")

    # results of the serving path
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

    # 7. the GPT training path, counted around one step
    train_launches, train = train_path(torch, fa, mp, model, rng)
    del model
    torch.cuda.empty_cache()

    # 8. the CNN training path: ResNet-50, counted around one step
    resnet_launches, resnet = resnet_path(torch, fa, mp)

    # 9. report: the fused fp32 shape, with the bf16 figures beside
    fwd, bwd, pool, pool16 = rows[0], bwd_rows[0], *pool_rows[8:10]
    fwd16, bwd16 = rows[2], bwd_rows[2]
    common = dict(route="cuda", shape=fwd["shape"], card=card)

    def sass_of(kernel):
        return {fn: ops for fn, ops in sass.items()
                if fn.startswith(kernel + "<")}

    kernels = [
        dict(name="flash_fwd", source="singa_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="singa_tpu/ops/flash_attention.py:829",
             also_replaces="singa_tpu/ops/flash_attention.py:263",
             launches=train_launches["flash_fwd"],
             launches_by_path={"score": fwd_launches,
                               "train_step": train_launches["flash_fwd"]},
             max_abs_err=fwd["max_abs_err"], ms=fwd["ms"],
             plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_fma_ms=fwd["bound_fma_ms"],
             bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
             bf16=dict(max_abs_err=fwd16["max_abs_err"], ms=fwd16["ms"],
                       plain_ms=fwd16["plain_ms"],
                       bound_ms=fwd16["bound_ms"],
                       bound_by=fwd16["bound_by"],
                       library_ms=fwd16["library_ms"]),
             sass=sass_of("flash_fwd_kernel"), **common)]
    for name, key, sites in (
            ("flash_bwd_dq", "dq", (":872", ":426")),
            ("flash_bwd_dkv", "dkv", (":911", ":449"))):
        grads = ("dq",) if key == "dq" else ("dk", "dv")
        kernels.append(dict(
            name=name, source="singa_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"singa_tpu/ops/flash_attention.py{sites[0]}",
            also_replaces=f"singa_tpu/ops/flash_attention.py{sites[1]}",
            launches=train_launches[name],
            max_abs_err=max(bwd["max_abs_err"][g] for g in grads),
            ms=bwd[f"ms_{key}"], plain_ms=bwd["plain_ms"],
            bound_ms=bwd["bound_ms"][key], bound_by=bwd["bound_by"][key],
            bound_fma_ms=bwd["bound_fma_ms"][key],
            library_ms=bwd["library_ms"],
            plain_and_library_compute="dq, dk and dv together",
            bf16=dict(max_abs_err=max(bwd16["max_abs_err"][g]
                                      for g in grads),
                      ms=bwd16[f"ms_{key}"], plain_ms=bwd16["plain_ms"],
                      bound_ms=bwd16["bound_ms"][key],
                      bound_by=bwd16["bound_by"][key],
                      library_ms=bwd16["library_ms"]),
            sass=sass_of(f"{name}_kernel"), **common))
    kernels.append(dict(
        name="max_pool_bwd", route="cuda",
        source="singa_tpu_torch/ops/csrc/max_pool_bwd.cu",
        replaces="singa_tpu/ops/max_pool.py:287",
        launches=resnet_launches["max_pool_bwd"],
        max_abs_err=pool["max_abs_err"], ms=pool["ms"],
        plain_ms=pool["plain_ms"], bound_ms=pool["bound_ms"],
        bound_by=pool["bound_by"], library_ms=pool["library_ms"],
        library="aten max_pool2d_with_indices_backward", shape=pool["shape"],
        dtype=pool["dtype"], vector_width=pool["vector_width"],
        bf16=dict(max_abs_err=pool16["max_abs_err"], ms=pool16["ms"],
                  plain_ms=pool16["plain_ms"], bound_ms=pool16["bound_ms"],
                  bound_by=pool16["bound_by"],
                  library_ms=pool16["library_ms"],
                  vector_width=pool16["vector_width"]),
        sass=sass_of("max_pool_bwd_kernel"), card=card))
    print("train " + json.dumps(train), flush=True)
    print("resnet50_train " + json.dumps(resnet), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
