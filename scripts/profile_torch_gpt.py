#!/usr/bin/env python3
"""Where the time goes in the port's gpt_medium inference on one card.

Builds gpt_medium at full width with the seeded weights of chip_smoke.py,
warms up, then traces with torch.profiler, once each:

- `model(ids)` on 4 x 1024 tokens (the scoring path, 12 flash launches);
- `generate` of 48 new tokens for 4 prompts of 224 (window 256).

For each it prints the host wall time, the device time summed over all
kernels, the device's idle share of the wall time, and the device time
grouped by kernel family (the flash kernel, matrix products, the rest)
with the ten largest kernels by name. Run from the repository root:

    python3 scripts/profile_torch_gpt.py [--seed 0]
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_fwd"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def profile(torch, fn, label):
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    by_family = defaultdict(float)
    for e in kernels:
        us = e.device_time_total if hasattr(e, "device_time_total") \
            else e.cuda_time_total
        by_name[e.name][0] += us / 1e3
        by_name[e.name][1] += 1
        by_family[family(e.name)] += us / 1e3
    busy_ms = sum(by_family.values())
    if busy_ms <= 0:
        raise RuntimeError(f"{label}: the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    row = dict(
        phase=label, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        n_kernels=len(kernels),
        by_family_ms=dict(sorted(by_family.items())),
        top_kernels=[dict(name=k[:90], ms=v[0], count=v[1])
                     for k, v in top])
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_gpt: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import seeded_params
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, args.seed))
    model.eval()
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(
        rng.integers(0, model.vocab_size, (4, 1024))).cuda()
    prompts = rng.integers(0, model.vocab_size, (4, 224))

    def forward():
        with torch.inference_mode():
            model(ids)

    def generate():
        model.generate(prompts, n_new=48, window=256)

    forward()
    generate()  # warm-up: kernel build, cuBLAS handles, allocator
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    profile(torch, forward, "forward_4x1024")
    profile(torch, generate, "generate_4x48")
    return 0


if __name__ == "__main__":
    sys.exit(main())
