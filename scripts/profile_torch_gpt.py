#!/usr/bin/env python3
"""Where the time goes in the port's gpt_medium on one card.

Builds gpt_medium at full width with the seeded weights of chip_smoke.py,
warms up, then traces with torch.profiler, once each:

- `model(ids)` on 4 x 1024 tokens (the scoring path, 12 flash launches);
- `generate` of 48 new tokens for 4 prompts of 224 (window 256);
- one training step, `model(x, y)` on a 4 x 1024 batch with AdamW
  (fp32, remat none: 12 flash_fwd, 12 dQ and 12 dK/dV launches).

For each it prints the host wall time, the device time summed over all
kernels, the device's idle share of the wall time, and the device time
grouped by kernel family (the flash forward, the flash backward, matrix
products, the optimizer's update, the rest) with the ten largest kernels
by name. The optimizer's kernels are those launched inside its
`apply_updates`, which the script wraps in a profiler range. Run from the
repository root:

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


OPT_RANGE = "optimizer.apply_updates"


def family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_fwd"
    if "flash_bwd" in n:
        return "flash_bwd"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def optimizer_ms(torch, events):
    """Device ms of the kernels launched by CPU ops inside OPT_RANGE."""
    ranges = [e.time_range for e in events if e.name == OPT_RANGE]
    total = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        if any(r.start <= e.time_range.start and e.time_range.end <= r.end
               for r in ranges):
            for k in e.kernels:
                if family(k.name) != "other":
                    raise RuntimeError(f"optimizer launched {k.name}")
                total += k.duration / 1e3
    return total


def profile(torch, fn, label):
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the optimizer's profiler range shows on the device timeline too:
    # it is no kernel
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != OPT_RANGE]
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
    opt_ms = optimizer_ms(torch, prof.events())
    if opt_ms:
        by_family["optimizer"] = opt_ms
        by_family["other"] -= opt_ms
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

    # the training step, after the scoring and generate traces
    from torch.profiler import record_function

    from singa_tpu_torch import opt

    seq = torch.from_numpy(
        rng.integers(0, model.vocab_size, (4, 1025))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    model.set_optimizer(opt.AdamW(lr=3e-4))
    model.compile([x], is_train=True, use_graph=True)
    update = model.optimizer.apply_updates

    def traced_update(pairs):
        pairs = list(pairs)  # the backward runs here, outside the range
        with record_function(OPT_RANGE):
            update(pairs)

    model.optimizer.apply_updates = traced_update

    def train_step():
        model(x, y)

    train_step()
    train_step()  # warm-up: optimizer slots, allocator
    profile(torch, train_step, "train_step_4x1024")
    return 0


if __name__ == "__main__":
    sys.exit(main())
