#!/usr/bin/env python3
"""Does a `torch.profiler` trace keep every kernel of a traced block on the
card, as the process ages? A diagnostic of `utils.profiler.xla_trace`'s
pre-roll.

Builds gpt_medium at full width with chip_smoke.py's seeded weights and
traces one eval forward on 4 x 1024 tokens (12 launches of the fused flash
forward kernel among ~350 kernels), first in a fresh process, then every
`--every` seconds `--ages` times, five ways each:

- `schedule`: `torch.profiler.profile` as `xla_trace` drives it (the
  schedule `wait=0, warmup=1, active=1` and one `prof.step()` before the
  block), no pre-roll;
- `sleep`: the same with the host asleep 0.1 s before the block;
- `spin`: the same with one 50 ms spin kernel (`torch.cuda._sleep`) first;
- `noschedule`: a plain `torch.profiler.profile` with no schedule (no
  warmup, no `prof.step()`), no pre-roll;
- `preroll`: `xla_trace` as shipped, `PREROLL` empty kernels first.

For each it prints the process's age, the block's kernel events kept
(the pre-roll's and the spin's left out) against the fresh trace's, and
the flash forward events. Run from the repository root on the card:

    python3 scripts/trace_loss_torch.py --ages 4 --every 140
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LOGDIR = "build/trace_loss"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ages", type=int, default=4)
    ap.add_argument("--every", type=float, default=140.0)
    args = ap.parse_args()
    import torch

    import chip_smoke
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import gpt_medium
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.utils import profiler

    if not torch.cuda.is_available():
        print("trace_loss_torch: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    m = gpt_medium(device="cuda")
    load_singa_tpu_params(m, chip_smoke.seeded_params(m, chip_smoke.SEED))
    m.eval()
    ids = torch.randint(0, m.vocab_size, (4, 1024), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    t0 = time.time()
    whole = []

    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    @contextlib.contextmanager
    def session(way):
        """A trace of the block the `way` names; yields [its file]."""
        path = []
        if way == "preroll":
            with profiler.xla_trace(LOGDIR) as tr:
                yield path
            path.append(tr.path)
            return
        kw = ({} if way == "noschedule" else
              dict(schedule=schedule(wait=0, warmup=1, active=1)))
        with profile(activities=acts, **kw) as prof:
            torch.cuda.synchronize()
            if kw:
                prof.step()
            yield path
            torch.cuda.synchronize()
        path.append(os.path.join(LOGDIR, f"{way}-{time.time_ns()}.json"))
        prof.export_chrome_trace(path[0])

    def trace(label, way="schedule"):
        with torch.inference_mode():
            m(ids)
            torch.cuda.synchronize()
            with session("schedule" if way in ("sleep", "spin") else way
                         ) as path:
                if way == "sleep":
                    time.sleep(0.1)
                elif way == "spin":
                    torch.cuda._sleep(100_000_000)
                m(ids)
        with open(path[0]) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path[0])
        names = [e["name"] for e in events if e.get("cat") == "kernel"
                 and profiler.PREROLL_KERNEL not in e["name"]]
        flash = sum("flash_fwd_kernel" in n for n in names)
        if not whole:
            whole.append(len(names))
        print(f"{label}: age {time.time() - t0:.0f} s, block kernels kept "
              f"{len(names)} of {whole[0]}, flash forward events {flash} "
              f"of 12", flush=True)

    os.makedirs(LOGDIR, exist_ok=True)
    trace("fresh schedule")
    for k in range(args.ages):
        time.sleep(args.every)
        for way in ("schedule", "sleep", "spin", "noschedule", "preroll"):
            trace(f"aged {k} {way}", way)
    shutil.rmtree(LOGDIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
