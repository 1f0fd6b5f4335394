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
    if causal:
        i = np.arange(tq)
        pairs = int(np.clip(i + (tk - tq) + 1, 0, tk).sum())
    else:
        pairs = tq * tk
    flops = 4.0 * b * h * pairs * d
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
        o = out.view(b, tq, h, d).permute(0, 2, 1, 3)
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
    library_ms = None
    if tq == tk or not causal:  # SDPA's causal mask is top-left aligned
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale))
    kind = "bf16" if (mxu or dtype == torch.bfloat16) else "fp32"
    bound_ms, bound_by = attention_bound(b, h, tq, tk, d, causal,
                                         q.element_size(), kind)
    row = dict(case=name, layout=layout, shape=[b, h, tq, tk, d],
               causal=causal, dtype=dt, mxu_bf16=mxu, max_abs_err=err_o,
               lse_max_abs_err=err_lse, tolerance=tol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, empty_rows=empty, empty_rows_zero=zero_rows,
               ok=err_o <= tol and err_lse <= tol and zero_rows)
    print("case " + json.dumps(row), flush=True)
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

    # 2. build
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t:.1f} s",
          flush=True)

    # 3. kernel against its plain version
    rows = [run_case(torch, fa, c) for c in CASES]
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    x = torch.zeros((1, 1, 64, 32), device="cuda", requires_grad=True)
    try:
        fa.flash_attention(x, x, x)
    except NotImplementedError as e:
        print(f"refused with grad: {e}", flush=True)
    else:
        check(False, "the forward-only kernel ran on a tensor needing grad")

    # 4. the main path, counted
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, SEED))
    model.eval()
    rng = np.random.default_rng(SEED)
    vocab = model.vocab_size
    ids = torch.from_numpy(rng.integers(0, vocab, (4, 1024))).cuda()
    prompts = rng.integers(0, vocab, (4, 224))
    torch.cuda.synchronize()

    fa.FLASH_FWD_LAUNCHES = 0
    with torch.inference_mode():
        t = time.perf_counter()
        logits = model(ids)
        torch.cuda.synchronize()
        fwd_first_s = time.perf_counter() - t
    fwd_launches = fa.FLASH_FWD_LAUNCHES
    t = time.perf_counter()
    toks = model.generate(prompts, n_new=48, window=256)
    gen_first_s = time.perf_counter() - t
    launches = {"flash_fwd": fa.FLASH_FWD_LAUNCHES}
    print(f"main path: forward {fwd_first_s:.3f} s ({fwd_launches} kernel "
          f"launches), generate {gen_first_s:.3f} s; launches {launches}",
          flush=True)
    check(fwd_launches == 12,
          f"model(ids) launched the kernel {fwd_launches} times, not 12")
    check(launches["flash_fwd"] >= 1, "the main path never ran the kernel")

    # 5. results
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

    # 6. report
    main_row = rows[0]
    kernels = [dict(
        name="flash_fwd", route="cuda",
        source="singa_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="singa_tpu/ops/flash_attention.py:829",
        also_replaces="singa_tpu/ops/flash_attention.py:263",
        launches=launches["flash_fwd"],
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        shape=main_row["shape"], card=card)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
