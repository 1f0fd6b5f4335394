#!/usr/bin/env python3
"""Where the time goes in the port's serving engine on one card.

Builds gpt_medium at full width with the seeded weights of chip_smoke.py
and a `ServingEngine` in chip_smoke.py's serve configuration (slots 8,
block 16, window 1024, prefill batch 2, fp32 pool), admits 8 of the
smoke's seeded requests so every slot is live, then traces with
torch.profiler:

- 10 decode steps through `engine.step()` (the captured CUDA Graph,
  host upload and token read-back included);
- one uncaptured launch of the same step function;
- one cold admission (full-window prefill of a batch of 2) and, on an
  engine with the prefix cache, one warm admission of a request on a
  512-token shared prefix (suffix-only prefill in 16-row chunks).

For each it prints the host wall time, the device time summed over all
kernels, the device's idle share, and the device time by kernel family
with the ten largest kernels: matrix products, the paged gathers
(`index_select`), the scatter writes (`index_put`), softmax, and the
rest (elementwise, reductions, copies). Run from the repository root:

    python3 scripts/profile_torch_serve.py [--seed 0]
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def family(name: str) -> str:
    """A serving kernel's family."""
    n = name.lower()
    if any(s in n for s in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "index_select" in n or "indexselect" in n:
        return "paged_gather"
    if "index_put" in n or "indexput" in n or "index_elementwise" in n:
        return "scatter_write"
    if "softmax" in n:
        return "softmax"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import SERVE_WINDOW, seeded_params, serve_requests
    from profile_torch_gpt import profile
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.serving import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt_medium(device="cuda")
    load_singa_tpu_params(model, seeded_params(model, args.seed))
    model.eval()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    rng = np.random.default_rng(args.seed)
    reqs = serve_requests(rng, model.vocab_size, 10, 64, 768, 128, 128,
                          SERVE_WINDOW)
    eng = ServingEngine(model, slots=8, block_size=16,
                        window=SERVE_WINDOW, prefill_batch=2)
    eng.admit_many(reqs[:8])
    for _ in range(3):
        eng.step()  # warm-up

    def steps():
        for _ in range(10):
            eng.step()

    def uncaptured():
        with torch.inference_mode():
            eng._upload()
            eng._step_fn()

    profile(torch, steps, "serve_10_decode_steps_captured", family)
    uncaptured()
    profile(torch, uncaptured, "serve_decode_step_uncaptured", family)
    for slot in range(2):
        eng.evict(slot)
    profile(torch, lambda: eng.admit_many(reqs[8:10]),
            "serve_cold_admission_batch_2", family)
    del eng
    torch.cuda.empty_cache()

    warm = ServingEngine(model, slots=8, block_size=16,
                         window=SERVE_WINDOW, prefill_batch=2,
                         prefix_cache=True)
    shared = rng.integers(0, model.vocab_size, 512)
    prompts = [np.concatenate([shared, rng.integers(
        0, model.vocab_size, 40)]).astype(np.int32) for _ in range(3)]
    warm.admit(Request(0, prompts[0], 8))
    warm.admit(Request(1, prompts[1], 8))  # warm-up of the suffix path
    profile(torch, lambda: warm.admit(Request(2, prompts[2], 8)),
            "serve_warm_admission_suffix_40", family)
    return 0


if __name__ == "__main__":
    sys.exit(main())
