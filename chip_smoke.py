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
   not), head dims 32 and 64, causal rows with no key (Tq > Tk, exact 0),
   and BERT-base's fused shape (16 x 512, 12 heads of hd 64, non-causal)
   in fp32 and bf16;
   print max|d|, the kernel's, the plain version's and
   F.scaled_dot_product_attention's times (the last as a yardstick only,
   where its masking is the same) and the data-sheet bound at the rate of
   the kernel's arithmetic (fp32: three TF32 passes, 165 TFLOP/s; bf16:
   989), with the fp32 FMA figure (67 TFLOP/s) beside it;
4. the same for the dQ and dK/dV backward kernels (11 cases, with
   bitwise repeats, exact-zero empty rows, an lse cotangent and the two
   BERT-base cases);
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
7. gpt_medium serves through `ServingEngine` (slots 8, block 16,
   window 1024, prefill batch 2, an fp32 pool of 513 blocks): 16
   seeded requests (prompts 64-768, max_new 32-128, half greedy, half
   sampled at 0.8) admitted as slots free. The decode step must be one
   captured CUDA Graph (`decode_compiles == 1`), every request must end
   with exactly max_new tokens and the allocator drain; `peek_logits`
   rows must equal the dense `decode_step` (teacher-forced on each
   stream) within 2e-3, every token must equal the dense pick wherever
   the top-2 margin is at least 2e-3, and each sampled stream solo
   `generate` up to its first near-tie. Prints the step's device time
   captured and uncaptured (in turns), the paged gathers' share, decode
   tokens/s, the per-token p50/p95 of `serve_token_ms`, prefill ms per
   batch and the pool's bytes; then the same short mix on fp32, bf16
   and int8 pools of one pool_bytes (capacity, step time, logit gap to
   fp32 within 0.15), and 8 requests on a 512-token shared prefix cold
   and warm (suffix-only prefill, warm streams equal cold ones up to
   the first near-tie, prefill ms of each);
   then the serving stack around the engine, each phase with the launch
   counts set to 0 before it and printed after (none reaches a kernel):
   `serve spec`, `SpeculativeEngine(spec_k=4)` on 8 requests (prompts
   64-512, max_new 32-64, half sampled at 0.8) with the target as its
   own draft and with `gpt_draft(target)` (seed-1 weights), and the
   plain engine on the same mix, in turns (plain, self, tiny, tiny,
   self, plain): propose and verify each one captured graph, exact
   max_new, the allocator drains, greedy streams equal the dense picks
   outside near-ties, the self draft accepts >= 0.9, a second run
   repeats every stream; prints propose and verify ms (CUDA events),
   tokens per round, decode tokens/s and the round's bound. `serve
   frontend`: `Frontend` over the engine with the serve mix
   (priorities high/normal/background, tenants a/b), FIFO, overlapped
   and chunk-scheduled (budget 2) in turns, each stream equal to FIFO's
   up to its first near-tie (FIFO's to the dense picks); per-token
   p50/p95 and the decode-stall p95; then a SIGTERM the process sends
   itself at a stream's 64th token, with a drain budget of 32 tokens.
   `serve router`: `ReplicaRouter` over two engines (prefix cache,
   parallel pump), 16 requests on 4 shared 256-token prefixes, replica
   0 killed mid-stream (affinity hits, requeued streams equal to the
   dense picks, each token delivered once, the quorum in healthz), and
   a serial pump on two fresh engines giving the same streams; then
   one `ProcessReplica` child (`python -m singa_tpu_torch.serving.router
   --gpt-medium`) serves 4 requests equal to the in-process engine's and
   exits 0 on stop;
8. gpt_medium trains on 4 x 1024 with AdamW: kernel-on against
   kernel-off gradients, one step counted alone (exactly 12 launches of
   each flash kernel), 6 steps whose loss must fall, one bf16 step;
   then `gpt_medium(scan_blocks=False, dropout=0.0)`, the reference's
   default unrolled decoder, on the scanned model's seeded weights
   (`unstack_params`): scoring 4 x 1024 (12 forward launches) and one
   training step's gradients (12 launches of each kernel) equal the
   scanned model's, one counted AdamW step, cached `generate` gives the
   scanned model's tokens, and `generate(use_cache=False)` (4 prompts
   filling the window of 256, 8 new; 96 forward launches) equals the
   cached tokens up to the first near-tie;
   then BERT-base at full width (`BertForClassification(2)`, vocab
   30522, 12 layers, d 768, 12 heads, max_len 512) trains at bench.py's
   chip shape, 16 x 512, with seeded weights, `AdamW(lr=1e-4)`,
   `compile(..., precision=...)` and `model(ids, y)`: a dropout-0 twin's
   logits and gradients with the kernels on against off, one fp32 step
   counted alone (exactly 12 launches of each kernel), a batch padded
   with a key mask (0 launches, logits equal to the kernel-off model's),
   the bench's dropout-0.1 model for 6 steps whose loss must fall, then
   tokens/s and TFLOP/s (bench.py's analytic count) with the kernels on
   and off in turns, and the same in bf16 (12 launches of each bf16
   kernel per step, a finite loss that falls);
9. ResNet-50 at full width trains on a seeded (128, 3, 224, 224) batch
   through the reference's entry points (`resnet50`, seeded states
   through load_singa_tpu_states, `set_image_layout("NHWC")`, SGD(lr
   0.05, momentum 0.9), `compile(..., precision="fp32")`, `model(x, y)`)
   with the max-pool kernel switched on: kernel-on against kernel-off
   gradients, one step counted alone (exactly 1 K2a launch; 0 with the
   switch off), 6 steps whose loss must fall, moved and finite
   BatchNorm statistics, a finite eval-mode forward, images/s with the
   switch on and off in turns, one bf16 step that runs the kernel on
   bf16;
10. print the `kernels` line (gpt_medium's fused fp32 shape, with the
   bf16 figures, the BERT-base shape's figures and launches per step, and
   the SASS census beside), then the result line.

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
    # BERT-base at bench.py's chip shape: non-causal, 12 heads of hd 64
    ("bert_base_fused_fp32", "fused", 16, 12, 512, 512, 64, False,
     "float32", False, 1e-4),
    ("bert_base_fused_bf16", "fused", 16, 12, 512, 512, 64, False,
     "bfloat16", False, 2e-2),
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
    ("bert_base_fused_fp32", "fused", 16, 12, 512, 512, 64, False,
     "float32", False, False, 1e-4),
    ("bert_base_fused_bf16", "fused", 16, 12, 512, 512, 64, False,
     "bfloat16", False, False, 2e-2),
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


def named_grads(model, loss):
    """{name: grad} of every parameter of `model` that `loss` reaches."""
    from singa_tpu_torch import autograd

    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: g for p, g in autograd.grad_pairs(loss)}


def worst_rel(a, b):
    """max over the names of b of max|a - b| / max|b|."""
    return max((a[n] - b[n]).abs().max().item()
               / max(b[n].abs().max().item(), 1e-30) for n in b)


def cnn_grads(model, x, y):
    """{name: grad} of the mean cross-entropy at the current weights, in
    training mode; the BatchNorm running statistics are put back."""
    import torch

    from singa_tpu_torch import autograd

    buffers = {k: b.clone() for k, b in model.named_buffers()}
    grads = named_grads(model, autograd.softmax_cross_entropy(
        model.forward(x), y))
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
    worst = worst_rel(on, off)
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
    the scales of the reference's initialisers: `serve_gpt.seeded_weights`,
    which the spool server's process entry uses too, so a process
    replica serves the same weights as this process."""
    from singa_tpu_torch.examples.serve_gpt import seeded_weights

    return seeded_weights(model, seed)


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

    return named_grads(model, autograd.softmax_cross_entropy(
        model.forward(x).reshape(-1, model.vocab_size), y.reshape(-1)))


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
    worst = worst_rel(on, off)
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


# -- BERT-base and the unrolled GPT ------------------------------------------

BERT_BATCH, BERT_SEQ = 16, 512  # bench.py's chip shape for --model bert


def bert_train_flops(batch, seq, d_model=768, n_layers=12, ffn_mult=4):
    """Analytic FLOPs of one BERT training step, as bench.py's
    `_bert_train_flops` counts them (matrix products only, backward ~ 2x
    forward): per layer forward, QKV and output projections 8*B*T*d^2,
    the FFN 4*B*T*d*(ffn_mult*d), attention scores and context
    4*B*T^2*d."""
    proj = 8 * batch * seq * d_model * d_model
    ffn = 4 * batch * seq * d_model * (ffn_mult * d_model)
    attn = 4 * batch * seq * seq * d_model
    return 3 * n_layers * (proj + ffn + attn)


def bert_rates(torch, fa, m, ids, y, steps=3):
    """Tokens/s of `m(ids, y)` with the flash kernels on and off, in
    turns (on, off, off, on), each window after one untimed step; the
    launches of each window are checked (12 per kernel per step, or
    0)."""
    rates = {True: [], False: []}
    for enabled in (True, False, False, True):
        fa.set_flash_enabled(enabled)
        m(ids, y)
        torch.cuda.synchronize()
        before = fa.FLASH_FWD_LAUNCHES
        t = time.perf_counter()
        for _ in range(steps):
            _, loss = m(ids, y)
        loss.item()
        dt = time.perf_counter() - t
        n = fa.FLASH_FWD_LAUNCHES - before
        check(n == (12 * steps if enabled else 0),
              f"flash {enabled}: {n} forward launches in {steps} steps")
        rates[enabled].append(steps * ids.numel() / dt)
    fa.set_flash_enabled(True)
    return rates


def bert_path(torch, fa, mp):
    """BERT-base at full width trains at bench.py's chip shape (16 x 512)
    through `BertForClassification`, `AdamW(lr=1e-4)`, `compile` and
    `model(ids, y)`: the fused flash kernels run non-causally at hd 64
    with 12 heads. Returns the counted fp32 step's launches and the
    numbers."""
    from singa_tpu_torch import autograd, opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.transformer import BertForClassification

    rng = np.random.default_rng(SEED + 1)
    ids = torch.from_numpy(rng.integers(0, 30522, (BERT_BATCH, BERT_SEQ)))
    ids = ids.cuda()
    y = torch.arange(BERT_BATCH, device="cuda") % 2
    flops = bert_train_flops(BERT_BATCH, BERT_SEQ)

    # the dropout-0 twin: kernel on against kernel off
    m = BertForClassification(2, max_len=BERT_SEQ, dropout=0.0,
                              device="cuda")
    weights = seeded_params(m, SEED)
    load_singa_tpu_params(m, weights)
    m.set_optimizer(opt.AdamW(lr=1e-4))
    m.compile([ids], is_train=True, use_graph=True, precision="fp32")
    print(f"bert_base: {sum(p.numel() for p in m.parameters())} "
          f"parameters", flush=True)
    sides = {}
    for enabled in (True, False):
        fa.set_flash_enabled(enabled)
        logits = m.forward(ids)
        loss = autograd.softmax_cross_entropy(logits, y)
        sides[enabled] = (logits.detach(), named_grads(m, loss))
    fa.set_flash_enabled(True)
    (l_on, g_on), (l_off, g_off) = sides[True], sides[False]
    check(sorted(g_on) == sorted(g_off) == sorted(
        n for n, _ in m.named_parameters() if n != "bert.seg.table"),
        "BERT gradients not complete (every parameter but the segment "
        "table, which no seg_ids reach)")
    logit_err = (l_on - l_off).abs().max().item()
    worst = worst_rel(g_on, g_off)
    tol = 1e-3  # of each max|grad| (logits: absolute); summation order
    print(f"bert kernel on vs off: logits max|d| {logit_err:.3e}, grads "
          f"worst max|d| / max|grad| {worst:.3e} over {len(g_on)} "
          f"parameters (tol {tol})", flush=True)
    check(logit_err <= tol and worst <= tol, "BERT kernel path disagrees")
    del sides, g_on, g_off

    # one fp32 step, counted alone
    torch.cuda.synchronize()
    reset_counts(fa, mp)
    t = time.perf_counter()
    _, loss = m(ids, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = counts(fa, mp)
    print(f"bert fp32 step 1: {first_s:.3f} s, loss {loss.item():.4f}, "
          f"launches {launches}", flush=True)
    check(launches == {"flash_fwd": 12, "flash_bwd_dq": 12,
                       "flash_bwd_dkv": 12, "max_pool_bwd": 0},
          f"one BERT step launched {launches}, not 12 of each flash kernel")

    # a padded batch with a key mask: the plain attention, no kernel
    lengths = rng.integers(BERT_SEQ // 4, BERT_SEQ + 1, BERT_BATCH)
    mask = (torch.arange(BERT_SEQ, device="cuda")[None]
            < torch.from_numpy(lengths).cuda()[:, None])[:, None, None]
    m.eval()
    with torch.inference_mode():
        reset_counts(fa, mp)
        masked = m(ids, None, mask)
        masked_launches = counts(fa, mp)
        fa.set_flash_enabled(False)
        masked_off = m(ids, None, mask)
        fa.set_flash_enabled(True)
    m.train()
    print(f"bert masked batch (lengths {lengths.min()}-{lengths.max()}): "
          f"launches {masked_launches}, logits equal to the kernel-off "
          f"model's: {bool(torch.equal(masked, masked_off))}", flush=True)
    check(sum(masked_launches.values()) == 0,
          f"a masked BERT batch launched {masked_launches}")
    check(torch.equal(masked, masked_off) and bool(
        torch.isfinite(masked).all()), "masked BERT logits differ")
    del m, masked, masked_off
    torch.cuda.empty_cache()

    # the bench's model (dropout 0.1): 6 steps, then tokens/s on and off
    m = BertForClassification(2, max_len=BERT_SEQ, device="cuda")
    load_singa_tpu_params(m, weights)
    m.set_optimizer(opt.AdamW(lr=1e-4))
    m.compile([ids], is_train=True, use_graph=True, precision="fp32")
    losses = [m(ids, y)[1].item() for _ in range(6)]
    print(f"bert fp32 losses (dropout 0.1) {losses}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the BERT fp32 loss did not fall over 6 steps")
    rates = {"fp32": bert_rates(torch, fa, m, ids, y)}

    # bf16: autocast on, so the kernels get bf16 operands
    seen = []
    real_fwd, real_bwd = fa._flash_fwd, fa._flash_bwd
    fa._flash_fwd = lambda q, *a: seen.append(q.dtype) or real_fwd(q, *a)
    fa._flash_bwd = lambda q, *a: seen.append(q.dtype) or real_bwd(q, *a)
    try:
        load_singa_tpu_params(m, weights)
        m.set_optimizer(opt.AdamW(lr=1e-4))
        m.compile([ids], is_train=True, use_graph=True, precision="bf16")
        reset_counts(fa, mp)
        _, loss = m(ids, y)
        losses_bf16 = [loss.item()]
        bf16_launches = counts(fa, mp)
        losses_bf16 += [m(ids, y)[1].item() for _ in range(5)]
        rates["bf16"] = bert_rates(torch, fa, m, ids, y)
    finally:
        fa._flash_fwd, fa._flash_bwd = real_fwd, real_bwd
        autograd.set_autocast(False)
    print(f"bert bf16: launches of step 1 {bf16_launches}, losses "
          f"{losses_bf16}, kernel operand dtypes "
          f"{sorted(set(map(str, seen)))}", flush=True)
    check(bf16_launches == launches, "the bf16 BERT step launched otherwise")
    check(set(seen) == {torch.bfloat16},
          "the bf16 BERT step did not run the kernels on bf16 operands")
    check(all(np.isfinite(losses_bf16)) and losses_bf16[-1] < losses_bf16[0],
          "the BERT bf16 loss is not finite or did not fall")
    out = dict(first_step_s=first_s, losses=losses, losses_bf16=losses_bf16,
               logit_err=logit_err, grad_rel_err=worst,
               masked_launches=masked_launches, flops_per_step=flops)
    for prec, r in rates.items():
        for enabled, key in ((True, "on"), (False, "off")):
            tok_s = float(np.mean(r[enabled]))
            step_ms = BERT_BATCH * BERT_SEQ / tok_s * 1e3
            out[f"{prec}_kernel_{key}"] = dict(
                tokens_per_s=tok_s, step_ms=step_ms,
                tflops=flops / step_ms * 1e-9, windows=r[enabled])
            print(f"bert {prec} kernel {key}: {step_ms:.2f} ms per "
                  f"{BERT_BATCH}x{BERT_SEQ} step, {tok_s:.1f} tokens/s, "
                  f"{flops / step_ms * 1e-9:.1f} TFLOP/s (windows "
                  f"{r[enabled]})", flush=True)
    del m
    torch.cuda.empty_cache()
    return launches, out


def gpt_unrolled_path(torch, fa, mp, scanned, ids, prompts):
    """`gpt_medium(scan_blocks=False, dropout=0.0)`, the reference's
    default unrolled decoder at gpt_medium's width, on the scanned
    model's seeded weights carried to its blocks' names: scoring, one
    training step's gradients, cached and eager `generate`, each
    against the scanned model. Returns the launches of each part."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium, unstack_params

    weights = seeded_params(scanned, SEED)
    load_singa_tpu_params(scanned, weights)
    m = gpt_medium(scan_blocks=False, dropout=0.0, device="cuda")
    load_singa_tpu_params(m, unstack_params(weights))
    scanned.eval()
    m.eval()
    launches, out = {}, {}

    with torch.inference_mode():
        reset_counts(fa, mp)
        logits = m(ids)
        launches["score"] = counts(fa, mp)
        err = (logits - scanned(ids)).abs().max().item()
    print(f"gpt unrolled scoring: launches {launches['score']}, logits vs "
          f"the scanned model max|d| {err:.3e}", flush=True)
    check(launches["score"]["flash_fwd"] == 12,
          f"unrolled scoring launched {launches['score']}")
    check(err <= 2e-3, "unrolled logits differ from the scanned model's")
    out["score_err"] = err
    del logits

    x, y = ids, torch.roll(ids, -1, dims=1)
    m.train()
    scanned.train()
    m.set_optimizer(opt.AdamW(lr=3e-4))
    m.compile([x], is_train=True, use_graph=True)
    g_s = main_grads(torch, scanned, x, y)
    reset_counts(fa, mp)
    g_u = main_grads(torch, m, x, y)
    launches["grads"] = counts(fa, mp)
    worst = worst_rel(g_u, unstack_params(g_s))
    print(f"gpt unrolled gradients: launches {launches['grads']}, worst "
          f"max|d| / max|grad| against the scanned model {worst:.3e} over "
          f"{len(g_u)} parameters", flush=True)
    check(sorted(g_u) == sorted(n for n, _ in m.named_parameters()),
          "unrolled gradients not complete")
    check(launches["grads"] == {"flash_fwd": 12, "flash_bwd_dq": 12,
                                "flash_bwd_dkv": 12, "max_pool_bwd": 0},
          f"the unrolled gradients launched {launches['grads']}")
    check(worst <= 1e-3, "unrolled gradients differ from the scanned ones")
    out["grad_rel_err"] = worst
    del g_s, g_u
    reset_counts(fa, mp)
    _, loss = m(x, y)
    launches["train_step"] = counts(fa, mp)
    check(launches["train_step"] == launches["grads"] and np.isfinite(
        loss.item()), f"the unrolled step launched {launches['train_step']}")
    scanned.eval()
    m.eval()
    load_singa_tpu_params(m, unstack_params(weights))
    torch.cuda.empty_cache()

    toks = m.generate(prompts, n_new=48, window=256)
    check(np.array_equal(toks, scanned.generate(prompts, n_new=48,
                                                window=256)),
          "unrolled cached generate differs from the scanned model's")

    # the eager loop from full windows: cached slides recompute the
    # window with plain attention, eager runs the forward (the kernel)
    full = toks[:, :256]
    reset_counts(fa, mp)
    t = time.perf_counter()
    eager = m.generate(full, n_new=8, window=256, use_cache=False)
    eager_s = time.perf_counter() - t
    launches["eager_generate"] = counts(fa, mp)
    cached = m.generate(full, n_new=8, window=256)
    margins = []
    with torch.inference_mode():
        for j in range(8):
            ctx = torch.from_numpy(cached[:, j:j + 256]).cuda()
            top = m(ctx)[:, -1].float().topk(2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
    margins = np.stack(margins, axis=1)
    agree = all(same_until_near_tie(a, b, mg) for a, b, mg in zip(
        eager[:, 256:], cached[:, 256:], margins))
    print(f"gpt unrolled generate: cached equals the scanned model's; eager "
          f"(4 x 8 new, window 256) {eager_s:.3f} s, launches "
          f"{launches['eager_generate']}, equals cached up to the first "
          f"near-tie: {agree} (min margin {margins.min():.3e})", flush=True)
    check(launches["eager_generate"]["flash_fwd"] == 8 * 12,
          f"eager generate launched {launches['eager_generate']}")
    check(agree, "eager generate differs from the cached path")
    out["eager_min_margin"] = float(margins.min())
    del m
    torch.cuda.empty_cache()
    return launches, out


# -- the serving path ---------------------------------------------------------

#: the serve phase's tolerance for logits against the dense decode path:
#: fp32 through 12 post-LN blocks, products of another batch width (as
#: the scoring check's)
SERVE_LOGIT_TOL = 2e-3
#: the quantized pools' logit gap to the fp32 engine
#: (tests/test_serving_int8.py's bound)
KV_GAP_TOL = 0.15
SERVE_WINDOW = 1024


def serve_requests(rng, vocab, n, lo, hi, new_lo, new_hi, window):
    """n requests from `rng`: prompt lengths in [lo, hi], max_new in
    [new_lo, new_hi], prompt + max_new <= window; even ones greedy, odd
    ones sampled at temperature 0.8."""
    from singa_tpu_torch.serving import Request

    out = []
    for i in range(n):
        max_new = int(rng.integers(new_lo, new_hi + 1))
        t0 = int(rng.integers(lo, min(hi, window - max_new) + 1))
        out.append(Request(i, rng.integers(0, vocab, t0).astype(np.int32),
                           max_new, temperature=0.0 if i % 2 == 0 else 0.8,
                           seed=SEED + i))
    return out


def dense_logits(torch, model, prompt, tokens, window):
    """The dense cached path's logits for every token of a stream,
    teacher-forced on `tokens`: row j scores token j (row 0 from the
    prefill at t0 - 1, row j from `decode_step` on token j - 1)."""
    prefill, decode_step = model._decode_fns(window)[:2]
    pv = model._functional_params()
    t0 = len(prompt)
    ctx = torch.zeros((1, window), dtype=torch.long, device="cuda")
    ctx[0, :t0] = torch.from_numpy(prompt).cuda()
    toks = torch.tensor(tokens, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        logits, kc, vc = prefill(pv, ctx)
        rows = [logits[0, t0 - 1]]
        for j in range(len(tokens) - 1):
            rows.append(decode_step(pv, kc, vc, toks[j:j + 1], t0 + j)[0])
    return torch.stack(rows)


def dense_picks(torch, req, dense):
    """(tokens, margins) the dense logits give a request: argmax for a
    greedy one; for a sampled one the Gumbel-max of `pick_rows` with the
    request's seed at each token's index, its margin scaled back to
    logit units."""
    from singa_tpu_torch.models.gpt import gumbel_noise

    n = dense.shape[0]
    scores, unit = dense.float(), 1.0
    if req.temperature > 0:
        temps = torch.full((n,), max(req.temperature, 1e-6),
                           device=dense.device)
        seeds = torch.full((n,), req.seed, dtype=torch.long,
                           device=dense.device)
        idx = torch.arange(n, device=dense.device)
        scores = scores / temps[:, None] + gumbel_noise(seeds, idx,
                                                        dense.shape[1])
        unit = req.temperature
    top = scores.topk(2, dim=-1)
    margin = (top.values[:, 0] - top.values[:, 1]) * unit
    return top.indices[:, 0].cpu().numpy(), margin.cpu().numpy()


def first_near_tie(margins, tol):
    near = np.flatnonzero(margins < tol)
    return int(near[0]) if near.size else len(margins)


def step_bound(model, eng, lengths):
    """Least time (ms) of one decode step: the larger of the bytes it
    must move (every weight once, the live K/V rows read once, one new
    K/V row per slot and layer written) over the memory rate, and its
    fp32 operations (the weight products for every slot, QK and PV over
    the live rows) over the FMA rate."""
    n_w = sum(p.numel() for p in model.parameters())
    n_emb = model.tok.table.numel() + model.pos.table.numel()
    row = 2 * eng._n_layers * eng.heads * eng.hd  # K and V, every layer
    live = int(sum(lengths)) + len(lengths)
    nbytes = 4 * (n_w + row * live + row * len(lengths))
    flops = (2.0 * (n_w - n_emb) * eng.slots
             + 2.0 * eng._n_layers * eng.heads * eng.hd * 2 * live)
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["fp32"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations")


def time_decode_step(torch, eng):
    """Device ms of the decode step captured (a graph replay) and
    uncaptured (the same function launched from Python), in turns in
    this process (captured, uncaptured, uncaptured, captured), and of
    the paged gathers alone: every layer's K and V, each made the
    contiguous (S, H, W, hd) tensor the step's einsums copy it into."""
    with torch.inference_mode():
        eng._upload()
        cap, unc = [], []
        for captured in (True, False, False, True):
            fn = eng._run_step if captured else eng._step_fn
            (cap if captured else unc).append(
                cuda_ms(torch, fn, iters=30, warmup=3))
        pt = eng._step_inputs()[0]

        def gathers():
            for pools in (eng.kpools, eng.vpools):
                for pool in pools:
                    eng._kv.gather(pool, pt).contiguous()

        gather = cuda_ms(torch, gathers, iters=30, warmup=3)
    return cap, unc, gather


def serve_path(torch, model):
    """The serving path: gpt_medium through `ServingEngine` (8 slots,
    block 16, window 1024, prefill batch 2, fp32 pool), 16 requests
    admitted as slots free; the oracle against the dense cached path;
    the bf16 and int8 pools at one pool_bytes; the prefix cache."""
    from singa_tpu_torch.observability import metrics
    from singa_tpu_torch.serving import Request, ServingEngine

    W = SERVE_WINDOW
    vocab = model.vocab_size
    rng = np.random.default_rng(SEED)
    eng = ServingEngine(model, slots=8, block_size=16, window=W,
                        prefill_batch=2)
    check(eng._graph is not None and eng.decode_compiles == 1,
          "the decode step was not captured as a CUDA Graph")
    reqs = serve_requests(rng, vocab, 16, 64, 768, 32, 128, W)
    print(f"serve: {len(reqs)} requests, prompts "
          f"{sorted(len(r.prompt) for r in reqs)}, max_new "
          f"{sorted(r.max_new for r in reqs)}; pool {eng.pool_bytes} "
          f"bytes, {eng.allocator.capacity} blocks", flush=True)

    queue, snaps, prefill, step_s, timed = list(reqs), [], [], [], None
    metrics.reset()
    metrics.enable()
    t_all = time.perf_counter()
    while queue or eng.n_active:
        batch = []
        while queue and len(batch) < eng.free_slots:
            batch.append(queue.pop(0))
        if batch:
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.admit_many(batch)  # reads the first tokens back: synced
            prefill.append(((time.perf_counter() - t) * 1e3,
                            -(-len(batch) // eng.prefill_batch)))
        if timed is None and eng.n_active == eng.slots:
            timed = time_decode_step(torch, eng)
            bound = step_bound(model, eng, eng.lengths)
        if eng.steps % 20 == 0:
            logits = eng.peek_logits()
            for s in np.flatnonzero(eng.active):
                r = eng._reqs[s]
                snaps.append((r.rid, len(r.tokens), logits[s].copy()))
        t = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t)
    wall_s = time.perf_counter() - t_all
    hist = metrics.histogram("serve_token_ms")
    p50, p95 = hist.percentile(0.5), hist.percentile(0.95)
    metrics.disable()

    n_decode = sum(len(r.tokens) - 1 for r in reqs)
    cap, unc, gather_ms = timed
    batch_ms = [ms / n for ms, n in prefill]
    stats = dict(
        requests=len(reqs), decode_tokens=n_decode, steps=eng.steps,
        wall_s=wall_s, decode_tokens_per_s=n_decode / sum(step_s),
        step_ms_host_mean=1e3 * sum(step_s) / len(step_s),
        token_ms_p50=p50, token_ms_p95=p95,
        step_ms_captured=cap, step_ms_uncaptured=unc,
        gather_ms=gather_ms, gather_share=gather_ms / min(cap),
        step_bound_ms=bound[0], step_bound_by=bound[1],
        prefill_ms_per_batch=batch_ms, pool_bytes=eng.pool_bytes,
        decode_compiles=eng.decode_compiles)
    print(f"serve: decode step {min(cap):.3f} ms captured, {min(unc):.3f} "
          f"ms uncaptured (in turns: {cap[0]:.3f} {unc[0]:.3f} "
          f"{unc[1]:.3f} {cap[1]:.3f}); paged gathers {gather_ms:.3f} ms "
          f"({100 * stats['gather_share']:.1f}% of the captured step); "
          f"bound {bound[0]:.3f} ms ({bound[1]})", flush=True)
    print(f"serve: {n_decode} decode tokens in {eng.steps} steps, "
          f"{stats['decode_tokens_per_s']:.1f} decode tokens/s, host step "
          f"{stats['step_ms_host_mean']:.3f} ms mean; per-token p50 "
          f"{p50:.3f} ms, p95 {p95:.3f} ms (serve_token_ms); prefill "
          f"{np.mean(batch_ms):.3f} ms per batch of 2 (mean of "
          f"{len(batch_ms)} admissions); {wall_s:.3f} s in all", flush=True)
    check(eng.decode_compiles == 1,
          f"{eng.decode_compiles} decode captures, not 1")
    check(all(r.done and len(r.tokens) == r.max_new for r in reqs),
          "a request did not finish with exactly max_new tokens")
    check(eng.allocator.used_blocks == 0 and not eng.allocator._ref,
          "the allocator did not drain")
    del eng
    torch.cuda.empty_cache()

    # the oracle: the engine's logits against the dense cached path, its
    # tokens against the dense picks wherever the top-2 margin clears
    # the tolerance, and the sampled streams against solo generate
    dense = {r.rid: dense_logits(torch, model, r.prompt, r.tokens, W)
             for r in reqs}
    err = max(float(np.abs(row - dense[rid][m].cpu().numpy()).max())
              for rid, m, row in snaps)
    print(f"serve oracle: peek_logits vs dense decode_step over "
          f"{len(snaps)} slot rows: max|d| {err:.3e} (tol "
          f"{SERVE_LOGIT_TOL})", flush=True)
    check(err <= SERVE_LOGIT_TOL, "engine logits disagree with the dense "
                                  "decode path")
    near_streams, skipped, gen_checked = 0, 0, 0
    for r in reqs:
        want, margin = dense_picks(torch, r, dense[r.rid])
        got = np.asarray(r.tokens)
        clear = margin >= SERVE_LOGIT_TOL
        bad = np.flatnonzero(clear & (got != want))
        check(bad.size == 0, f"request {r.rid} ({'sampled' if r.temperature
              else 'greedy'}) differs from the dense path at clear "
              f"positions {bad[:5]}")
        near_streams += int(not clear.all())
        skipped += int((~clear).sum())
        if r.temperature > 0:
            f = first_near_tie(margin, SERVE_LOGIT_TOL)
            solo = model.generate(r.prompt, r.max_new, window=W,
                                  temperature=r.temperature,
                                  seed=r.seed)[0, len(r.prompt):]
            check(np.array_equal(solo[:f], got[:f]),
                  f"sampled request {r.rid} differs from solo generate "
                  f"before its first near-tie ({f})")
            gen_checked += f
    print(f"serve oracle: every stream equals the dense picks at every "
          f"position whose top-2 margin is >= {SERVE_LOGIT_TOL}; "
          f"{near_streams} streams had a near-tie ({skipped} positions "
          f"skipped); the 8 sampled streams equal solo generate over "
          f"{gen_checked} tokens, up to their first near-tie", flush=True)
    stats.update(logit_err=err, near_tie_streams=near_streams,
                 near_tie_positions=skipped)
    del dense
    torch.cuda.empty_cache()

    stats["kv_formats"] = serve_kv_formats(torch, model, rng)
    stats["prefix_cache"] = serve_prefix(torch, model, rng)
    return stats


def serve_kv_formats(torch, model, rng):
    """The same short mix on fp32, bf16 and int8 pools of one
    pool_bytes: capacity, step time and the logit gap to fp32."""
    from singa_tpu_torch.serving import Request, ServingEngine, \
        kv_block_bytes

    W = SERVE_WINDOW
    dec = model.decoder
    budget = 256 * kv_block_bytes(dec.n_blocks, dec.num_heads,
                                  model.d_model // dec.num_heads, 16, "fp32")
    mix = serve_requests(rng, model.vocab_size, 8, 64, 256, 16, 16, W)
    out, ref = {}, None
    for kv in ("fp32", "bf16", "int8"):
        eng = ServingEngine(model, slots=8, block_size=16, window=W,
                            prefill_batch=2, kv_dtype=kv,
                            pool_bytes=budget)
        reqs = [Request(r.rid, r.prompt, r.max_new, 0.0, r.seed)
                for r in mix]
        eng.admit_many(reqs)
        used = eng.allocator.used_blocks
        logits = eng.peek_logits()
        ref = logits if ref is None else ref
        gap = float(np.abs(logits - ref).max())
        step_s = []
        while eng.n_active:
            t = time.perf_counter()
            eng.step()
            step_s.append(time.perf_counter() - t)
        cap = eng.allocator.capacity
        out[kv] = dict(pool_bytes=eng.pool_bytes, blocks=cap,
                       requests_of_256_tokens=cap // 16, blocks_used=used,
                       step_ms=1e3 * float(np.mean(step_s)),
                       logit_gap_to_fp32=gap)
        print(f"serve kv {kv}: pool {eng.pool_bytes} bytes holds {cap} "
              f"blocks ({cap // 16} requests of 256 tokens); the mix "
              f"took {used}; step {out[kv]['step_ms']:.3f} ms; logit gap "
              f"to fp32 {gap:.3e} (tol {KV_GAP_TOL})", flush=True)
        check(gap <= KV_GAP_TOL, f"{kv} pool logits diverge from fp32")
        check(eng.decode_compiles == 1, f"{kv}: decode recaptured")
        del eng
        torch.cuda.empty_cache()
    check(out["int8"]["blocks"] >= 1.9 * out["fp32"]["blocks"]
          and out["bf16"]["blocks"] >= 1.9 * out["fp32"]["blocks"],
          "the quantized pools do not multiply capacity")
    return out


def serve_prefix(torch, model, rng):
    """8 requests share a 512-token prefix: cold (no prefix cache) and
    warm (the cache on) admissions, greedy streams compared up to the
    first near-tie of the dense path."""
    from singa_tpu_torch.serving import Request, ServingEngine

    W = SERVE_WINDOW
    shared = rng.integers(0, model.vocab_size, 512).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, model.vocab_size, int(rng.integers(16, 65))).astype(np.int32)])
        for _ in range(8)]
    runs = {}
    for warm in (False, True):
        eng = ServingEngine(model, slots=8, block_size=16, window=W,
                            prefill_batch=2, prefix_cache=warm)
        rounds = []
        for _ in range(2):  # the second round is timed: warm, captured
            reqs = [Request(i, p, 32) for i, p in enumerate(prompts)]
            eng.admit(reqs[0])
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.admit_many(reqs[1:])
            ms = (time.perf_counter() - t) * 1e3 / (len(reqs) - 1)
            while eng.n_active:
                eng.step()
            rounds.append((reqs, ms, dict(eng.prefix_stats)))
        runs[warm] = rounds
        check(eng.decode_compiles == 1, "prefix run recaptured the step")
        del eng
        torch.cuda.empty_cache()
    (cold, _, _), (_, cold_ms, _) = runs[False]
    (hot, hot_first_ms, st), (_, hot_ms, _) = runs[True]
    check(st["hits"] == 7 and st["misses"] == 1
          and all(r.cached_tokens == 512 for r in hot[1:]),
          f"warm admissions did not map the shared prefix: {st}")
    same = 0
    for c, h in zip(cold, hot):
        _, margin = dense_picks(torch, c, dense_logits(
            torch, model, c.prompt, c.tokens, W))
        f = first_near_tie(margin, SERVE_LOGIT_TOL)
        check(np.array_equal(np.asarray(c.tokens[:f]),
                             np.asarray(h.tokens[:f])),
              f"warm stream {h.rid} differs from cold before position {f}")
        same += f
    print(f"serve prefix: {st}; admission ms per request of the 7 on "
          f"the shared prefix (second round): cold {cold_ms:.3f} (full "
          f"prefill, batches of 2), warm {hot_ms:.3f} (suffix only; "
          f"{hot_first_ms:.3f} in the first round, its captures "
          f"included); warm streams equal cold over {same} tokens, up to "
          f"each first near-tie", flush=True)
    return dict(cold_prefill_ms=cold_ms, warm_prefill_ms=hot_ms,
                warm_first_round_ms=hot_first_ms, stats=st,
                tokens_compared=same)


# -- the serving stack around the engine ---------------------------------------

SPEC_K = 4
#: priority lanes and tenants cycled over the frontend and router mixes
LANES = ("high", "normal", "background")
TENANTS = ("a", "b")


def fresh(reqs):
    """Unserved copies of `reqs` (a Request accumulates its tokens)."""
    from singa_tpu_torch.serving import Request

    return [Request(r.rid, r.prompt, r.max_new, r.temperature, r.seed)
            for r in reqs]


def oracle(torch, model, reqs, what):
    """{rid: dense margins}, after holding every stream to the dense
    picks wherever the top-2 margin clears SERVE_LOGIT_TOL; returns the
    margins and the number of positions skipped as near-ties."""
    margins, skipped = {}, 0
    for r in reqs:
        want, margin = dense_picks(torch, r, dense_logits(
            torch, model, r.prompt, r.tokens, SERVE_WINDOW))
        got = np.asarray(r.tokens)
        clear = margin >= SERVE_LOGIT_TOL
        bad = np.flatnonzero(clear & (got != want))
        check(bad.size == 0, f"{what}: request {r.rid} differs from the "
                             f"dense path at clear positions {bad[:5]}")
        margins[r.rid] = margin
        skipped += int((~clear).sum())
    torch.cuda.empty_cache()
    return margins, skipped


def same_until_near_tie(a, b, margin):
    """Whether token lists a and b agree up to the first near-tie of
    the dense path (exact where the margins clear the tolerance)."""
    f = first_near_tie(margin, SERVE_LOGIT_TOL)
    return list(a[:f]) == list(b[:f]) and len(a) == len(b)


def round_bound(model, draft, eng, lengths):
    """Least time (ms) of one speculative round: the larger of the bytes
    it must move (the target's weights once, the draft's once per
    micro-step, the live K/V rows of each cache once per pass over it,
    K+1 new rows per slot and layer in each) over the memory rate, and
    its fp32 operations over the FMA rate."""
    kp1 = eng.spec_k + 1
    s = len(lengths)
    n_w = sum(p.numel() for p in model.parameters())
    n_e = model.tok.table.numel() + model.pos.table.numel()
    d_w = sum(p.numel() for p in draft.parameters())
    d_e = draft.tok.table.numel() + draft.pos.table.numel()
    row_t = 2 * eng._n_layers * eng.heads * eng.hd
    row_d = 2 * eng._d_layers * eng.d_heads * eng.d_hd
    live = int(sum(lengths)) + s * kp1
    nbytes = 4 * (n_w + kp1 * d_w + row_t * (live + s * kp1)
                  + row_d * (kp1 * live + s * kp1))
    flops = (2.0 * (n_w - n_e) * s * kp1 + 2.0 * (d_w - d_e) * s * kp1
             + 2.0 * row_t * live * kp1 + 2.0 * row_d * live * kp1)
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["fp32"]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b > t_o else "operations")


def drive(eng, reqs):
    """Admit the requests of `reqs` not admitted yet (those without a
    first token) as slots free, and step until every stream ends:
    (decode tokens from step(), summed step walls in s, the streams
    stepped summed over steps)."""
    queue = [r for r in reqs if not r.tokens]
    step_s, streams = [], 0
    while queue or eng.n_active:
        batch = []
        while queue and len(batch) < eng.free_slots:
            batch.append(queue.pop(0))
        if batch:
            eng.admit_many(batch)
        streams += eng.n_active
        t = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t)
    n_dec = sum(len(r.tokens) - 1 for r in reqs)
    return n_dec, sum(step_s), streams


def serve_spec(torch, model, card):
    """`SpeculativeEngine(spec_k=4)` at gpt_medium's width on 8
    requests (prompts 64-512, max_new 32-64, half sampled at 0.8),
    with the target as its own draft and with `gpt_draft(target)`
    (seed-1 weights), against the plain engine on the same mix, in
    turns."""
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_draft
    from singa_tpu_torch.serving import ServingEngine, SpeculativeEngine

    W = SERVE_WINDOW
    tiny = gpt_draft(model)
    load_singa_tpu_params(tiny, seeded_params(tiny, SEED + 1))
    tiny.eval()
    mix = serve_requests(np.random.default_rng(SEED + 7), model.vocab_size,
                         8, 64, 512, 32, 64, W)
    kw = dict(slots=8, block_size=16, window=W)
    runs, out = {}, {}
    for which in ("plain", "self", "tiny", "tiny", "self", "plain"):
        if which == "plain":
            eng = ServingEngine(model, **kw)
        else:
            eng = SpeculativeEngine(model, model if which == "self" else tiny,
                                    spec_k=SPEC_K, **kw)
            check(eng._propose_graph is not None
                  and eng._verify_graph is not None,
                  "propose or verify was not captured as a CUDA Graph")
        reqs = fresh(mix)
        timed = None
        if which != "plain":
            # propose and verify replayed alone, with every slot live;
            # their writes land in rows the next round rewrites first
            eng.admit_many(reqs)
            with torch.inference_mode():
                eng._upload()
                proposed = eng._run_propose()
                timed = (cuda_ms(torch, eng._run_propose, iters=10),
                         cuda_ms(torch, lambda: eng._run_verify(proposed),
                                 iters=10),
                         round_bound(model, eng.draft_model, eng,
                                     eng.lengths))
        n_dec, wall, streams = drive(eng, reqs)
        check(all(r.done and len(r.tokens) == r.max_new for r in reqs),
              f"{which}: a request did not end with exactly max_new tokens")
        check(eng.allocator.used_blocks == 0 and not eng.allocator._ref,
              f"{which}: the allocator did not drain")
        check(eng.decode_compiles == 1, f"{which}: decode recaptured")
        row = dict(decode_tokens_per_s=n_dec / wall, decode_tokens=n_dec,
                   steps=eng.steps)
        if which != "plain":
            check(eng.verify_compiles == 1, f"{which}: verify recaptured")
            row.update(propose_ms=timed[0], verify_ms=timed[1],
                       round_bound_ms=timed[2][0], round_bound_by=timed[2][1],
                       acceptance=eng.acceptance_rate,
                       tokens_per_round=n_dec / streams, rounds=eng.steps)
        runs.setdefault(which, []).append((reqs, row))
        print(f"serve spec [{which}]: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()) + f" ({card})", flush=True)
        del eng
        torch.cuda.empty_cache()
    for which in ("self", "tiny"):
        (a, _), (b, _) = runs[which]
        check([r.tokens for r in a] == [r.tokens for r in b],
              f"{which} draft: a second run gave other streams")
    check(runs["self"][0][1]["acceptance"] >= 0.9,
          f"self draft acceptance {runs['self'][0][1]['acceptance']:.3f} "
          f"< 0.9")
    plain = runs["plain"][0][0]
    margins, skipped = oracle(torch, model, [r for r in plain
                                             if r.temperature == 0],
                              "serve spec plain")
    for which in ("self", "tiny"):
        for r in runs[which][0][0]:
            if r.temperature == 0:
                want, margin = dense_picks(torch, r, dense_logits(
                    torch, model, r.prompt, r.tokens, W))
                clear = margin >= SERVE_LOGIT_TOL
                bad = np.flatnonzero(clear & (np.asarray(r.tokens) != want))
                check(bad.size == 0, f"{which} draft: greedy request "
                                     f"{r.rid} differs from the dense "
                                     f"picks at {bad[:5]}")
                skipped += int((~clear).sum())
    torch.cuda.empty_cache()
    for which in ("plain", "self", "tiny"):
        out[which] = [row for _, row in runs[which]]
    out["near_tie_positions"] = skipped
    print(f"serve spec: greedy streams of both drafts equal the dense "
          f"picks at every clear position ({skipped} near-tie positions "
          f"skipped); sampled streams repeat; tokens/s in turns: " +
          ", ".join(f"{w} " + "/".join(f"{r['decode_tokens_per_s']:.1f}"
                                       for r in out[w])
                    for w in ("plain", "self", "tiny")) + f" ({card})",
          flush=True)
    return out


def serve_frontend(torch, model, card):
    """`Frontend` over one plain engine with the serve mix (16 requests,
    priorities cycled high/normal/background, tenants a/b), FIFO,
    `overlap_prefill=True` and `ChunkedScheduler(chunk_budget=2)` in
    turns; then one SIGTERM drain with `drain_token_budget=32`, the
    process signalling itself at the 64th token of a stream."""
    import os
    import signal

    from singa_tpu_torch.observability import metrics
    from singa_tpu_torch.serving import (
        ChunkedScheduler, Frontend, ServingEngine)

    W = SERVE_WINDOW
    mix = serve_requests(np.random.default_rng(SEED), model.vocab_size, 16,
                         64, 768, 32, 128, W)
    eng = ServingEngine(model, slots=8, block_size=16, window=W)

    # the drain's trigger: the 64th token of the longest of the streams
    # admitted first (shorter ones have finished by then, and queued
    # requests wait for their slots)
    longest = max(mix[:8], key=lambda r: r.max_new).rid

    def serve(mode, budget=None, on_64=None):
        fe = Frontend(eng, drain_token_budget=budget,
                      overlap_prefill=mode == "overlap",
                      sched=(ChunkedScheduler(chunk_budget=2)
                             if mode == "chunked" else None))
        seen = {"n": 0}

        def cb(tok, done, rid):
            if rid == longest:
                seen["n"] += 1
                if on_64 is not None and seen["n"] == 64:
                    on_64()

        hs = [fe.submit(r.prompt, r.max_new, temperature=r.temperature,
                        seed=r.seed, rid=r.rid,
                        on_token=lambda t, d, rid=r.rid: cb(t, d, rid),
                        priority=LANES[i % 3], tenant=TENANTS[i % 2])
              for i, r in enumerate(mix)]
        metrics.reset()
        metrics.enable()
        t = time.perf_counter()
        report = fe.run()
        wall = time.perf_counter() - t
        tok, stall = (metrics.histogram("serve_token_ms"),
                      metrics.histogram("serve_decode_stall_ms"))
        metrics.disable()
        row = dict(token_ms_p50=tok.percentile(0.5),
                   token_ms_p95=tok.percentile(0.95),
                   stall_ms_p95=stall.percentile(0.95),
                   stall_ms_max=stall.percentile(1.0),
                   wall_s=wall, steps=eng.steps)
        return hs, report, row

    runs = {}
    for mode in ("fifo", "overlap", "chunked", "chunked", "overlap", "fifo"):
        steps0 = eng.steps
        hs, report, row = serve(mode)
        row["steps"] = eng.steps - steps0
        check(all(h.status == "done" and len(h.tokens) == h.request.max_new
                  for h in hs), f"frontend {mode}: a stream did not finish "
                                f"with exactly max_new tokens")
        check(eng.allocator.used_blocks == 0 and eng.decode_compiles == 1,
              f"frontend {mode}: pool not drained or step recaptured")
        runs.setdefault(mode, []).append((hs, row))
        print(f"serve frontend [{mode}]: per-token p50 "
              f"{row['token_ms_p50']:.3f} ms, p95 {row['token_ms_p95']:.3f}"
              f" ms; decode stall p95 {row['stall_ms_p95']:.3f} ms (max "
              f"{row['stall_ms_max']:.3f}); {row['wall_s']:.3f} s, "
              f"{row['steps']} steps ({card})", flush=True)
    fifo = [h.request for h in runs["fifo"][0][0]]
    margins, skipped = oracle(torch, model, fifo, "frontend fifo")
    for mode in ("overlap", "chunked"):
        for hs, _ in runs[mode]:
            for h in hs:
                check(same_until_near_tie(h.tokens, runs["fifo"][0][0][
                    h.rid].tokens, margins[h.rid]),
                    f"frontend {mode}: stream {h.rid} differs from FIFO "
                    f"before its first near-tie")

    # the drain: the process signals itself after 64 streamed tokens
    hs, report, row = serve("fifo", budget=32, on_64=lambda: os.kill(
        os.getpid(), signal.SIGTERM))
    done = [h for h in hs if h.status == "done"]
    queued_back = [h for h in hs if h.status == "preempted"
                   and not h.tokens]
    check(report["drained"], "the SIGTERM did not drain the frontend")
    check(queued_back and all(h.rid in report["preempted"]
                              for h in queued_back),
          "no queued request was handed back without tokens")
    check(report["drain_tokens"] <= 32 + eng.slots,
          f"drain_tokens {report['drain_tokens']} > budget + slots")
    for h in done:
        check(len(h.tokens) == h.request.max_new and same_until_near_tie(
            h.tokens, runs["fifo"][0][0][h.rid].tokens, margins[h.rid]),
            f"drained stream {h.rid} is not intact")
    check(done, "no stream completed across the drain")
    check(eng.allocator.used_blocks == 0, "the drain leaked blocks")
    drain = dict(drained=report["drained"],
                 drain_tokens=report["drain_tokens"],
                 completed=len(done), preempted=len(report["preempted"]),
                 queued_back_without_tokens=len(queued_back))
    print(f"serve frontend drain: {drain} (budget 32, slots {eng.slots})",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return dict(runs={m: [row for _, row in v] for m, v in runs.items()},
                near_tie_positions=skipped, drain=drain)


def serve_router(torch, model, card):
    """`ReplicaRouter` over two local gpt_medium engines (one model, a
    pool and graphs each, prefix cache on, parallel pump): 4 openers,
    then 16 requests on their 4 shared 256-token prefixes; replica 0 is
    killed mid-stream. The same requests through a serial pump on two
    fresh engines, without the kill, give the same streams. Then one
    `ProcessReplica` child through the port's spool-server entry serves
    4 requests."""
    import json as json_module
    import os
    import shutil
    from pathlib import Path

    from singa_tpu_torch.serving import (
        Frontend, ProcessReplica, ReplicaRouter, Request, ServingEngine)

    W = SERVE_WINDOW
    vocab = model.vocab_size
    rng = np.random.default_rng(SEED + 11)
    prefixes = [rng.integers(0, vocab, 256).astype(np.int32)
                for _ in range(4)]
    openers = [np.concatenate([p, rng.integers(0, vocab, 16)])
               for p in prefixes]
    reqs = []
    for i in range(16):
        prompt = np.concatenate([prefixes[i % 4], rng.integers(
            0, vocab, int(rng.integers(16, 65)))]).astype(np.int32)
        reqs.append(Request(i, prompt, int(rng.integers(32, 49)),
                            0.0 if i % 2 == 0 else 0.8, SEED + i))

    def route(parallel, kill):
        engines = [ServingEngine(model, slots=8, block_size=16, window=W,
                                 prefix_cache=True) for _ in range(2)]
        router = ReplicaRouter(engines, parallel_pump=parallel)
        t = time.perf_counter()
        for i, p in enumerate(openers):
            router.submit(p, 8, rid=f"open{i}")
        router.run()
        seen = {r.rid: [] for r in reqs}
        handles = [router.submit(
            r.prompt, r.max_new, temperature=r.temperature, seed=r.seed,
            rid=r.rid, on_token=lambda tok, done, rid=r.rid:
            seen[rid].append(tok), priority=LANES[i % 3],
            tenant=TENANTS[i % 2]) for i, r in enumerate(reqs)]
        health = None
        if kill:
            for _ in range(10000):
                if sum(len(v) for v in seen.values()) >= 96:
                    break
                router.pump()
            router.kill_replica(0)
            health = router.healthz()
        router.run()
        wall = time.perf_counter() - t
        router.close()
        check(all(e.decode_compiles == 1 for e in engines),
              "a replica recaptured its decode step")
        return router, engines, handles, seen, health, wall

    router, engines, handles, seen, health_killed, wall = route(True, True)
    check(router.parallel_pump, "the parallel pump is off")
    st = dict(router.stats)
    busy = dict(router.replica_busy_s)
    print(f"serve router: {st}; healthz after the kill: status "
          f"{health_killed['status']}, live {health_killed['live']} of "
          f"{health_killed['replicas']}, quorum {health_killed['quorum']}; "
          f"{wall:.3f} s in all; replica busy s {busy} ({card})",
          flush=True)
    check(st["affinity_hits"] > 0, "no affinity hit")
    check(st["replica_deaths"] == 1 and st["requeued"] > 0,
          "the kill requeued nothing")
    check(health_killed["status"] == "degraded"
          and health_killed["live"] == 1 and health_killed["quorum"] == 2,
          f"healthz after the kill: {health_killed}")
    for h in handles:
        check(h.status == "done" and len(h.tokens) == h.max_new,
              f"routed stream {h.rid} did not finish with max_new tokens")
        check(seen[h.rid] == h.tokens,
              f"routed stream {h.rid}: a token was delivered twice or lost")
    for r, h in zip(reqs, handles):
        r.tokens = list(h.tokens)
    requeued = [r for r, h in zip(reqs, handles) if h.attempts > 1]
    margins, skipped = oracle(torch, model, reqs, "router")
    hits = [e.prefix_hits for e in engines]
    router.revive_replica(0)
    check(router.healthz()["status"] == "ok", "revive did not restore ok")
    del router, engines
    torch.cuda.empty_cache()
    serial = route(False, False)
    for r, h in zip(reqs, serial[2]):
        check(h.status == "done" and same_until_near_tie(
            h.tokens, r.tokens, margins[r.rid]),
            f"stream {r.rid}: the serial pump differs from the parallel "
            f"one before its first near-tie")
    same = sum(h.tokens == r.tokens for r, h in zip(reqs, serial[2]))
    print(f"serve router: the serial pump without the kill gives the "
          f"parallel run's streams ({same}/16 exactly; {serial[5]:.3f} s, "
          f"busy s {dict(serial[0].replica_busy_s)}) ({card})", flush=True)
    del serial
    torch.cuda.empty_cache()

    # one process replica, started as a fresh interpreter
    spool = Path(__file__).resolve().parent / "build" / "chip_smoke_spool"
    shutil.rmtree(spool, ignore_errors=True)
    rep = ProcessReplica(str(spool), block_size=16, stale_after_s=300.0)
    prouter = ReplicaRouter([rep])
    root = str(Path(__file__).resolve().parent)
    proc = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.serving.router",
         "--spool", str(spool), "--gpt-medium"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        four = fresh(reqs[:4])
        t = time.perf_counter()
        phs = [prouter.submit(r.prompt, r.max_new, temperature=r.temperature,
                              seed=r.seed, rid=r.rid) for r in four]
        while not all(h.done for h in phs):
            check(proc.poll() is None and time.perf_counter() - t < 600,
                  f"the process replica died or stalled: "
                  f"{proc.poll()} {proc.stderr.read() if proc.poll() else ''}")
            prouter.pump()
            time.sleep(0.05)
        proc_s = time.perf_counter() - t
        status = rep.status()
        rep.stop()
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(rc == 0, f"the process replica exited {rc}: {err[-2000:]}")
    check(status.get("decode_compiles") == 1,
          f"the process replica's status: {status}")
    eng = ServingEngine(model, slots=8, block_size=16, window=W)
    local = Frontend(eng)
    lhs = [local.submit(r.prompt, r.max_new, temperature=r.temperature,
                        seed=r.seed, rid=r.rid) for r in four]
    local.run()
    margins, _ = oracle(torch, model, [h.request for h in lhs],
                        "in-process twin")
    exact = 0
    for h, lh in zip(phs, lhs):
        check(h.status == "done" and same_until_near_tie(
            h.tokens, lh.tokens, margins[h.rid]),
            f"process replica stream {h.rid} differs from the in-process "
            f"engine's before its first near-tie")
        exact += int(h.tokens == lh.tokens)
    del eng, local
    torch.cuda.empty_cache()
    print(f"serve router process replica: 4 streams in {proc_s:.3f} s "
          f"(child start, gpt_medium build and capture included); "
          f"{exact}/4 equal the in-process engine's exactly; status "
          f"{json_module.dumps(status)}; exit 0 on stop ({card})",
          flush=True)
    return dict(stats=st, prefix_hits=hits, requeued=len(requeued),
                near_tie_positions=skipped, wall_s=wall,
                replica_busy_s=busy, serial_exact=same,
                process_replica=dict(seconds=proc_s, exact=exact,
                                     status=status))


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

    # 7. the serving path, counted: the engine reaches no kernel (its
    # prefill is the plain one, its decode step a captured CUDA Graph)
    reset_counts(fa, mp)
    serve = serve_path(torch, model)
    serve_launches = counts(fa, mp)
    print(f"serve path launches {serve_launches}", flush=True)
    torch.cuda.empty_cache()

    # 7b. the serving stack around the engine, each phase counted alone:
    # none reaches a kernel (the reference's reaches no Pallas)
    stack = {}
    for name, phase in (("spec", serve_spec), ("frontend", serve_frontend),
                        ("router", serve_router)):
        reset_counts(fa, mp)
        t = time.perf_counter()
        stack[name] = phase(torch, model, card)
        print(f"serve {name}: {time.perf_counter() - t:.1f} s ({card}); "
              f"launches {counts(fa, mp)}", flush=True)
    torch.cuda.empty_cache()

    # 8. the GPT training path, counted around one step
    train_launches, train = train_path(torch, fa, mp, model, rng)

    # 8b. the reference's default decoder, unrolled, against the scanned
    unrolled_launches, unrolled = gpt_unrolled_path(torch, fa, mp, model,
                                                    ids, prompts)
    del model
    torch.cuda.empty_cache()

    # 8c. BERT-base training: the fused kernels non-causally at hd 64
    bert_launches, bert = bert_path(torch, fa, mp)

    # 9. the CNN training path: ResNet-50, counted around one step
    resnet_launches, resnet = resnet_path(torch, fa, mp)

    # 10. report: the fused fp32 shape, with the bf16 figures beside
    fwd, bwd, pool, pool16 = rows[0], bwd_rows[0], *pool_rows[8:10]
    fwd16, bwd16 = rows[2], bwd_rows[2]
    common = dict(route="cuda", shape=fwd["shape"], card=card)
    fwd_by = {r["case"]: r for r in rows}
    bwd_by = {r["case"]: r for r in bwd_rows}

    def at_bert(name, key, grads):
        """A flash kernel's figures at BERT-base's shape, fp32 and bf16,
        beside its launches per BERT step."""
        out = dict(shape=fwd_by["bert_base_fused_fp32"]["shape"],
                   causal=False, launches_per_step=bert_launches[name])
        for dt in ("fp32", "bf16"):
            if key is None:
                r = fwd_by[f"bert_base_fused_{dt}"]
                fig = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                           bound_ms=r["bound_ms"], bound_by=r["bound_by"])
            else:
                r = bwd_by[f"bert_base_fused_{dt}"]
                fig = dict(max_abs_err=max(r["max_abs_err"][g]
                                           for g in grads),
                           ms=r[f"ms_{key}"], bound_ms=r["bound_ms"][key],
                           bound_by=r["bound_by"][key])
            out[dt] = dict(fig, plain_ms=r["plain_ms"],
                           library_ms=r["library_ms"])
        return out

    def sass_of(kernel):
        return {fn: ops for fn, ops in sass.items()
                if fn.startswith(kernel + "<")}

    kernels = [
        dict(name="flash_fwd", source="singa_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="singa_tpu/ops/flash_attention.py:829",
             also_replaces="singa_tpu/ops/flash_attention.py:263",
             launches=train_launches["flash_fwd"],
             launches_by_path={
                 "score": fwd_launches,
                 "train_step": train_launches["flash_fwd"],
                 "unrolled_train_step":
                     unrolled_launches["train_step"]["flash_fwd"],
                 "bert_step": bert_launches["flash_fwd"]},
             bert_base=at_bert("flash_fwd", None, ()),
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
            launches_by_path={
                "train_step": train_launches[name],
                "unrolled_train_step": unrolled_launches["train_step"][name],
                "bert_step": bert_launches[name]},
            bert_base=at_bert(name, key, grads),
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
    print("serve " + json.dumps(serve), flush=True)
    print("serve_stack " + json.dumps(stack), flush=True)
    print("train " + json.dumps(train), flush=True)
    print("gpt_unrolled " + json.dumps(dict(unrolled,
                                            launches=unrolled_launches)),
          flush=True)
    print("bert_train " + json.dumps(bert), flush=True)
    print("resnet50_train " + json.dumps(resnet), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
