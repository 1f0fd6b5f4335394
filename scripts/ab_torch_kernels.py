#!/usr/bin/env python3
"""A/B of the port's dQ and max-pool backward kernels against variants of
their own sources, on one card.

Each variant is the committed source with a few text substitutions (a
tile size, a register cap, a division in place of a shift). All are
built with the flags of `singa_tpu_torch/ops/_build.py` into
`build/torch_kernels/ab/`, loaded in place of the committed library, held
against the plain PyTorch version once, and timed with CUDA events in
turns (each variant, then each again in reverse order), at gpt_medium's
attention shapes and chip_smoke.py's max-pool shapes. Prints the card,
each variant's registers and spills, then one `ab` JSON line per
(kernel, case, variant) with both times. Run from the repository root:

    python3 scripts/ab_torch_kernels.py
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import POOL_CASES, cuda_ms, ptxas_summary  # noqa: E402

# (library, variant, substitutions); the first variant of each library
# is the committed source
VARIANTS = [
    ("flash_bwd", "dq_8warps_bk32", []),
    ("flash_bwd", "dq_4warps_bk32",
     [("WARPS = WIDE ? 8 : 4", "WARPS = 4")]),
    ("flash_bwd", "dq_4warps_bk16",
     [("WARPS = WIDE ? 8 : 4", "WARPS = 4"),
      ("BK = WIDE ? 32 : 64", "BK = WIDE ? 16 : 64")]),
    ("max_pool_bwd", "pool", []),
    ("max_pool_bwd", "pool_no_register_cap",
     [("__launch_bounds__(NT, 2)", "__launch_bounds__(NT)")]),
    ("max_pool_bwd", "pool_cv8",
     [("p.sh > 1 ? 4 : 3", "3")]),
    ("max_pool_bwd", "pool_divisions",
     [("const int v = i & (p.cv - 1), pos = i >> p.lcv;",
       "const int v = i % p.cv, pos = i / p.cv;"),
      ("const int v = j & (p.cv - 1), wi = j >> p.lcv;",
       "const int v = j % p.cv, wi = j / p.cv;")]),
]
DQ_CASES = [
    # name, layout, B, H, Tq, Tk, hd, causal, dtype
    ("fused_fp32", "fused", 4, 8, 1024, 1024, 128, True, "float32"),
    ("fused_bf16", "fused", 4, 8, 1024, 1024, 128, True, "bfloat16"),
    ("split_causal_fp32", "split", 2, 8, 384, 1000, 128, True, "float32"),
    ("split_noncausal_fp32", "split", 2, 8, 384, 1000, 128, False,
     "float32"),
]
POOL_NAMES = ("resnet50_stem_fp32", "resnet50_stem_bf16", "plateau_k3s1p1",
              "alexnet_first_pool", "k7_s1_chunked")


def build(_build):
    """Compile every variant, all nvcc processes at once; return
    {variant: (library name, loaded CDLL)}."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._find_nvcc()
    procs = {}
    for lib, name, subs in VARIANTS:
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for old, new in subs:
            if src.count(old) < 1:
                raise RuntimeError(f"{name}: '{old}' not in {lib}.cu")
            src = src.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out_dir / f"lib{name}.so"), str(path)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in ptxas_summary(log):
            print(f"ptxas {name} {line}", flush=True)
        libs[name] = (lib, ctypes.CDLL(str(out_dir / f"lib{name}.so")))
    return libs


def dq_inputs(torch, fa, case):
    _, layout, b, h, tq, tk, d, causal, dt = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if layout == "fused":
        q, k, v = fa._split_qkv(randn(b, tq, 3 * h * d), h)
        o = fa._heads(torch.empty((b, tq, h * d), dtype=dtype,
                                  device="cuda"), h)
        do = fa._heads(randn(b, tq, h * d), h)
        dq = fa._split_qkv(torch.empty((b, tq, 3 * h * d), dtype=dtype,
                                       device="cuda"), h)[0]
    else:
        q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
        o, dq = torch.empty_like(q), torch.empty_like(q)
        do = randn(b, h, tq, d)
    scale = d ** -0.5
    lse = fa._flash_fwd(q, k, v, o, causal, scale, False)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dq, causal, scale, False)
    want = fa._flash_bwd_plain(q, k, v, do, lse, delta, causal, scale,
                               False)[0]
    return (lambda: fa._flash_bwd_dq(*args)), dq, want


def pool_inputs(torch, mp, case):
    _, shape, win, strd, pad, dt, opts = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda").clamp_min(0)
    if "levels" in opts:
        x = (x * opts["levels"]).round() / opts["levels"]
    x = x.to(getattr(torch, dt))
    y = mp._fwd(x, win, strd, pad)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(x.dtype)
    out = {}

    def run():
        out["dx"] = mp._max_pool_bwd(x, y, dy, win, strd, pad)

    return run, out, mp._max_pool_bwd_plain(x, y, dy, win, strd, pad)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.ops import flash_attention as fa
    from singa_tpu_torch.ops import max_pool as mp

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    libs = build(_build)
    cases = [("flash_bwd", c[0], dq_inputs(torch, fa, c)) for c in DQ_CASES]
    cases += [("max_pool_bwd", c[0], pool_inputs(torch, mp, c))
              for c in POOL_CASES if c[0] in POOL_NAMES]
    order = [name for _, name, _ in VARIANTS]
    times = {}
    for name in order + order[::-1]:
        lib, cdll = libs[name]
        _build._loaded[lib] = cdll
        for case_lib, case, (run, out, want) in cases:
            if case_lib != lib:
                continue
            key = (lib, case, name)
            if key not in times:  # first visit: hold it against plain
                run()
                got = out if lib == "flash_bwd" else out["dx"]
                err = ((got.float() - want.float()).abs().max().item()
                       / max(1.0, want.float().abs().max().item()))
                times[key] = {"rel_err": err, "ms": []}
            times[key]["ms"].append(cuda_ms(torch, run, iters=30))
    for (lib, case, name), row in times.items():
        print("ab " + json.dumps(dict(kernel=lib, case=case, variant=name,
                                      **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
