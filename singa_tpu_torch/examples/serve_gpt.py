"""Streaming GPT serving (counterpart of examples/serve_gpt.py).

Builds a GPT with seeded random weights (a small char-level one, or
`gpt_medium` with --gpt-medium) and serves --requests prompts through
the continuous-batching `ServingEngine`: requests are admitted as slots
free, every step advances all live streams, and each token streams
through its `Request.on_token` callback. Runs on the card unless
`--device cpu`:

    python -m singa_tpu_torch.examples.serve_gpt --requests 6 --slots 2
    python -m singa_tpu_torch.examples.serve_gpt --device cpu \\
        --requests 5 --slots 2 --max-new 8 --kv-dtype int8 --prefix-cache

--kv-dtype picks the pool format, --prefix-cache shares a common
"system prompt" (--shared-prompt tokens, default two blocks) across
requests. Every stream equals a solo `generate(use_cache=True)` of the
same prompt, seed and temperature. The reference's frontend, scheduler,
router, speculative and tensor-parallel flags raise, naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from singa_tpu_torch import device as device_module
from singa_tpu_torch.model import load_singa_tpu_params
from singa_tpu_torch.models.gpt import GPT, gpt_medium
from singa_tpu_torch.observability import metrics
from singa_tpu_torch.serving import (
    OutOfBlocksError, Request, ServingEngine)

_BUILTIN = (
    "the engine admits a request, pages its cache, and streams the "
    "tokens back one captured step at a time. "
    "long prompts and short prompts share the pool, block by block. "
) * 30

#: flags of the reference's server that come with later ports
_UNPORTED = (
    ("--tp", "tp", "items 10 (tp decode) and 14 (parallel/tp.py)"),
    ("--overlap-prefill", "overlap_prefill", "item 11 (the Frontend)"),
    ("--sched", "sched", "item 11 (the chunked scheduler)"),
    ("--chunk-budget", "chunk_budget", "item 11 (the chunked scheduler)"),
    ("--priority", "priority", "item 11 (the chunked scheduler)"),
    ("--tenant", "tenant", "item 11 (the chunked scheduler)"),
    ("--draft", "draft", "item 11 (speculative decoding)"),
    ("--spec-k", "spec_k", "item 11 (speculative decoding)"),
    ("--replicas", "replicas", "item 11 (the replica router)"),
    ("--router-affinity", "router_affinity", "item 11 (the router)"),
    ("--drain-budget", "drain_budget", "item 11 (the Frontend's drain)"),
    ("--exit-on-preempt", "exit_on_preempt", "item 11 (the Frontend)"),
    ("--metrics-port", "metrics_port", "item 18 (the exporters)"),
)


def seeded_weights(model, seed):
    """Random weights for every parameter, from numpy with `seed`, at
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


def run(args):
    for flag, attr, item in _UNPORTED:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1 {item})")
    dev = device_module.resolve(args.device)
    if args.gpt_medium:
        m = gpt_medium(device=dev)
        ids = np.random.default_rng(args.seed).integers(
            0, m.vocab_size, 4096)
        chars = None
    else:
        chars = sorted(set(_BUILTIN))
        c2i = {c: i for i, c in enumerate(chars)}
        ids = np.array([c2i[c] for c in _BUILTIN], np.int64)
        m = GPT(vocab_size=len(chars), d_model=args.d_model,
                num_layers=args.layers, num_heads=args.heads,
                max_len=args.window, dropout=0.0, scan_blocks=True,
                device=dev)
    load_singa_tpu_params(m, seeded_weights(m, args.seed))
    m.eval()
    eng = ServingEngine(m, slots=args.slots, block_size=args.block_size,
                        window=args.window, num_blocks=args.num_blocks,
                        prefill_batch=args.prefill_batch,
                        kv_dtype=args.kv_dtype,
                        prefix_cache=args.prefix_cache)
    print(f"engine on {dev}: {args.slots} slots, "
          f"{eng.allocator.capacity} blocks x {args.block_size} tokens "
          f"({eng.allocator.bytes_per_block} bytes/block, "
          f"kv_dtype={args.kv_dtype}, pool {eng.pool_bytes} bytes)")

    rng = np.random.default_rng(args.seed + 1)
    n_shared = (args.shared_prompt if args.shared_prompt is not None
                else (2 * args.block_size if args.prefix_cache else 0))
    sys_prompt = ids[:n_shared]
    max_t0 = args.window - args.max_new - len(sys_prompt)
    if max_t0 < 5:
        raise SystemExit(
            f"--window {args.window} leaves {max_t0} tokens for the "
            f"per-request prompt after max_new and the shared prefix; "
            f"raise --window or lower --max-new")

    def show(tok):
        return repr(chars[tok]) if chars is not None else str(tok)

    queue = []
    for r in range(args.requests):
        t0 = int(rng.integers(4, max_t0))
        start = int(rng.integers(0, len(ids) - t0))
        prompt = np.concatenate([sys_prompt, ids[start:start + t0]])

        def cb(tok, done, r=r):
            if args.echo:
                print(f"  [req {r}] {show(tok)}"
                      f"{'  <done>' if done else ''}")

        queue.append(Request(r, prompt.astype(np.int32), args.max_new,
                             temperature=args.temperature,
                             seed=args.seed + r, on_token=cb))
    reqs = list(queue)

    metrics.enable()
    t = time.perf_counter()
    while queue or eng.n_active:
        while queue and eng.free_slots:
            try:
                eng.admit(queue[0])
            except OutOfBlocksError:
                if not eng.n_active:
                    raise
                break
            queue.pop(0)
        eng.step()
    wall = time.perf_counter() - t
    hist = metrics.histogram("serve_token_ms")
    metrics.disable()

    n_tok = sum(len(r.tokens) for r in reqs)
    for r in reqs:
        text = ("".join(chars[i] for i in r.tokens) if chars is not None
                else " ".join(map(str, r.tokens[:16])))
        print(f"req {r.rid}: prompt {len(r.prompt)} tokens "
              f"({r.cached_tokens} cached) -> {text!r}")
    print(f"served {sum(r.done for r in reqs)}/{len(reqs)} requests, "
          f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s "
          f"on {dev}), {eng.steps} steps; per-token p50 "
          f"{hist.percentile(0.5):.3f} ms, p95 {hist.percentile(0.95):.3f}"
          f" ms")
    print(f"decode executables: {eng.decode_compiles} "
          f"({'CUDA Graph captures' if dev.type == 'cuda' else 'builds'})")
    if args.prefix_cache:
        print(f"prefix cache: {eng.prefix_stats}")
    return reqs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gpt-medium", action="store_true",
                   help="serve gpt_medium (vocab 32768, d 1024, 12 blocks)")
    p.add_argument("--d-model", type=int, default=96)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--window", type=int, default=64,
                   help="per-request cache length (prompt + max_new)")
    p.add_argument("--slots", type=int, default=2,
                   help="decode batch width")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV-cache block rows")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="pool blocks (default: every slot at full window)")
    p.add_argument("--prefill-batch", type=int, default=1)
    p.add_argument("--kv-dtype", choices=("fp32", "bf16", "int8"),
                   default="fp32", help="KV pool storage format")
    p.add_argument("--prefix-cache", action="store_true",
                   help="share full prompt blocks across requests")
    p.add_argument("--shared-prompt", type=int, default=None,
                   help="tokens of a prefix every prompt shares")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--echo", action="store_true",
                   help="print every streamed token")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    for flag, attr, item in _UNPORTED:
        kind = dict(action="store_true") if attr in (
            "overlap_prefill", "exit_on_preempt") else dict(default=None)
        p.add_argument(flag, dest=attr, help=f"not ported ({item})", **kind)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
