#!/usr/bin/env python3
"""Where the time goes in the port's gpt_medium, ResNet-50 and Char-RNN
on one card.

Builds gpt_medium at full width with the seeded weights of chip_smoke.py,
warms up, then traces with torch.profiler, once each:

- `model(ids)` on 4 x 1024 tokens (the scoring path, 12 flash launches);
- `generate` of 48 new tokens for 4 prompts of 224 (window 256);
- one training step, `model(x, y)` on a 4 x 1024 batch with AdamW
  (fp32, remat none: 12 flash_fwd, 12 dQ and 12 dK/dV launches),
  uncaptured (`graph(False)`), then one replay of the step captured as
  a CUDA Graph (`graph(True)`, after its uncaptured first call and its
  capture).

Before the training step, as the yardstick beside the flash kernels,
PyTorch's `scaled_dot_product_attention` forward and backward on
gpt_medium's per-head q, k, v (4, 8, 1024, 128), causal, fp32 and
bf16: its kernel names show which of PyTorch's attention kernels it
picks (a row says so where the profiler misses these few kernels).

Then ResNet-50 at full width with chip_smoke.py's seeded states, NHWC,
SGD(lr 0.05, momentum 0.9), the max-pool kernel switched on: one fp32
training step on a seeded (128, 3, 224, 224) batch (1 K2a launch),
uncaptured, then one captured replay. Then Char-RNN at bench.py's rnn
shape (64 x 256 ids, hidden 512, embed 64, vocab 64, Adam): one step
uncaptured and one captured replay.

For each it prints the host wall time, the device time summed over all
kernels, the device's idle share of the wall time, and the device time
grouped by kernel family with the ten largest kernels by name: for GPT
the flash forward, the flash backward's dQ and dK/dV kernels, matrix
products, the optimizer's update and the rest; for ResNet-50 the convolutions (with the one fc
product), the max-pool backward kernel, the optimizer's update, and
batch norm with the other elementwise kernels; for Char-RNN matrix
products and the rest. The optimizer's kernels are those launched
inside its `apply_updates`, which the script wraps in a profiler range
(uncaptured steps only: a replay runs no Python). Run from the
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


_PRODUCTS = ("gemm", "gemv", "cutlass", "xmma", "cublas")
_CONVS = _PRODUCTS + ("conv", "cudnn", "implicit", "winograd", "fft",
                      "dgrad", "wgrad", "fprop")


def family(name: str) -> str:
    """A GPT kernel's family."""
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_fwd"
    if "flash_bwd_dq" in n:
        return "flash_bwd_dq"
    if "flash_bwd_dkv" in n:
        return "flash_bwd_dkv"
    if any(s in n for s in _PRODUCTS):
        return "matmul"
    return "other"


def cnn_family(name: str) -> str:
    """A ResNet kernel's family."""
    n = name.lower()
    if "max_pool_bwd" in n:
        return "max_pool_bwd"
    if any(s in n for s in _CONVS):
        return "conv_and_fc"
    return "other"


def optimizer_ms(torch, events, fam=family):
    """Device ms of the kernels launched by CPU ops inside OPT_RANGE."""
    ranges = [e.time_range for e in events if e.name == OPT_RANGE]
    total = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        if any(r.start <= e.time_range.start and e.time_range.end <= r.end
               for r in ranges):
            for k in e.kernels:
                if fam(k.name) != "other":
                    raise RuntimeError(f"optimizer launched {k.name}")
                total += k.duration / 1e3
    return total


def profile(torch, fn, label, fam=family, required=True):
    """Trace fn() once and print its row. A yardstick trace
    (`required=False`) whose kernels the profiler does not see prints a
    row saying so (chip_smoke.py times the same call with CUDA events);
    a phase of the port's own raises."""
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
        by_family[fam(e.name)] += us / 1e3
    busy_ms = sum(by_family.values())
    if busy_ms <= 0:
        if required:
            raise RuntimeError(f"{label}: the profiler saw no device time")
        row = dict(phase=label, wall_ms=wall_ms, device_busy_ms=None,
                   note="the profiler saw no device time")
        print(json.dumps(row), flush=True)
        return row
    opt_ms = optimizer_ms(torch, prof.events(), fam)
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
    sdpa_trace(torch, args.seed)

    # the training step, after the scoring and generate traces
    from singa_tpu_torch import opt

    seq = torch.from_numpy(
        rng.integers(0, model.vocab_size, (4, 1025))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    model.set_optimizer(opt.AdamW(lr=3e-4))
    model.compile([x], is_train=True, use_graph=False)
    trace_optimizer(model.optimizer)

    def train_step():
        model(x, y)

    train_step_traces(torch, model, train_step, "train_step_4x1024")
    del model
    torch.cuda.empty_cache()
    resnet_trace(torch, args.seed)
    char_rnn_trace(torch, args.seed)
    return 0


def trace_optimizer(optimizer):
    """Wrap the optimizer's update in the OPT_RANGE profiler range."""
    from torch.profiler import record_function

    update = optimizer.apply_updates

    def traced_update(pairs):
        pairs = list(pairs)  # the backward runs here, outside the range
        with record_function(OPT_RANGE):
            update(pairs)

    optimizer.apply_updates = traced_update


def train_step_traces(torch, model, step, label, fam=family):
    """Trace one uncaptured step of a model compiled with use_graph=False
    (after two untimed ones), then one replay of the step captured as a
    CUDA Graph (after its uncaptured first call and its capture)."""
    step()
    step()  # warm-up: optimizer slots, allocator, cuDNN's choices
    rows = [profile(torch, step, label, fam)]
    model.graph(True)
    step()
    step()
    replays = model._train_step.replays
    rows.append(profile(torch, step, label + "_captured", fam))
    if model._train_step.replays != replays + 1:
        raise RuntimeError(f"{label}: the traced step did not replay")
    model.graph(False)
    return rows


def sdpa_trace(torch, seed):
    """SDPA forward and backward at gpt_medium's attention shape, fp32 and
    bf16, causal: the library call chip_smoke.py times beside the flash
    kernels."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (torch.randn((4, 8, 1024, 128), generator=gen,
                                  device="cuda").to(dtype)
                      for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))

        def step():
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.autograd.grad(o, (q, k, v), g)

        step()  # warm-up
        profile(torch, step, f"sdpa_fwd_bwd_{str(dtype)[6:]}",
                required=False)


def resnet_trace(torch, seed):
    """One traced fp32 ResNet-50 training step at batch 128, uncaptured
    and captured."""
    from chip_smoke import cnn_states
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_states
    from singa_tpu_torch.models.resnet import resnet50
    from singa_tpu_torch.ops import max_pool

    m = resnet50(num_classes=1000, device="cuda")
    load_singa_tpu_states(m, cnn_states(
        {n: t.shape for n, t in [*m.named_parameters(),
                                 *m.named_buffers()]}, seed))
    m.set_image_layout("NHWC")
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((128, 3, 224, 224), generator=gen, device="cuda")
    y = torch.arange(128, device="cuda") % 1000
    max_pool.set_pool_kernel_enabled(True)
    m.compile([x], is_train=True, use_graph=False, precision="fp32")
    trace_optimizer(m.optimizer)
    launched = []

    def train_step():
        before = max_pool.MAX_POOL_BWD_LAUNCHES
        m(x, y)
        launched.append(max_pool.MAX_POOL_BWD_LAUNCHES - before)

    train_step_traces(torch, m, train_step, "resnet50_train_step_128",
                      cnn_family)
    # uncaptured: 1 launch a step; the capture records 1; a replay none
    if launched != [1, 1, 1, 1, 1, 0]:
        raise RuntimeError(f"ResNet-50's max-pool launches per call: "
                           f"{launched}")


def char_rnn_trace(torch, seed):
    """One Char-RNN Adam step at bench.py's rnn shape, uncaptured and
    captured: the recurrent loop's kernels."""
    from chip_smoke import (RNN_BATCH, RNN_EMBED, RNN_HIDDEN, RNN_SEQ,
                            RNN_VOCAB, char_rnn_weights)
    from singa_tpu_torch import opt
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import CharRNN

    m = CharRNN(RNN_VOCAB, hidden_size=RNN_HIDDEN, embed_dim=RNN_EMBED,
                device="cuda")
    load_singa_tpu_params(m, char_rnn_weights(m, seed))
    rng = np.random.default_rng(seed)
    seq = torch.from_numpy(
        rng.integers(0, RNN_VOCAB, (RNN_BATCH, RNN_SEQ + 1))).cuda()
    x, y = seq[:, :-1].contiguous(), seq[:, 1:].contiguous()
    m.set_optimizer(opt.Adam(lr=1e-3))
    m.compile([x], is_train=True, use_graph=False)
    trace_optimizer(m.optimizer)
    train_step_traces(torch, m, lambda: m(x, y),
                      f"char_rnn_train_step_{RNN_BATCH}x{RNN_SEQ}")


if __name__ == "__main__":
    sys.exit(main())
