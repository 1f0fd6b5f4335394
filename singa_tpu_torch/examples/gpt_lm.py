"""GPT causal-LM trainer + sampler (counterpart of examples/gpt_lm.py).

Trains a small GPT on a character corpus with the reference's surface:
`compile(..., is_train=True, use_graph=True)`, then `model(x, y)` per
step with AdamW; the attention dispatcher switches to the flash kernels
(forward and backward) from --seq 256 on. Then it samples a continuation
with the cached `generate`. The decoder is the reference's default, the
unrolled `TransformerEncoder` with dropout; `--scan-blocks` picks the
scanned stack (dropout-free), as does a `--remat` policy. Runs on the
card unless `--device cpu`:

    python -m singa_tpu_torch.examples.gpt_lm --steps 200
    python -m singa_tpu_torch.examples.gpt_lm --device cpu \\
        --steps 3 --batch 2 --seq 32 --d-model 32 --heads 2
    python -m singa_tpu_torch.examples.gpt_lm --shard-states --steps 20

`--shard-states` wraps AdamW in `DistOpt(shard_states=True)` (ZeRO-1)
over the process group, a world-1 group (NCCL on the card, gloo on the
CPU) when none is live. `run` called inside a live group of more than
one process wraps DistOpt whatever the flag, and the global batch is
`--batch` times the world (the reference's `len(jax.devices())`); each
rank runs its share. `--checkpoint DIR --save-every N` saves a
resilience checkpoint every N steps (`utils.checkpoint`: the sharded
commit, canonical optimizer states, the newest two kept) and, when DIR
holds one, resumes from it first; each step's batch is seeded by (seed,
step), so a resumed run continues the batch stream, and its losses are
bitwise those of a run that was never stopped:

    python -m singa_tpu_torch.examples.gpt_lm --device cpu --steps 4 \
        --batch 2 --seq 32 --d-model 32 --heads 2 --checkpoint /tmp/ck \
        --save-every 2

`--virtual-devices N` runs the trainer as N gloo ranks, one CPU process
each (`utils.virtual`): DistOpt over the N ranks, the global batch
`--batch` times N:

    python -m singa_tpu_torch.examples.gpt_lm --virtual-devices 2 \
        --device cpu --steps 3 --batch 2 --seq 32 --d-model 32 --heads 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import distributed, opt, tensor
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.utils import virtual

_BUILTIN = (
    "in the beginning the framework traced the tape, and the tape was "
    "lowered onto the mesh, and every step was one launch. "
    "the gradients rode the ring, the shards met their gather, and the "
    "loss went down and down. "
) * 30


def load_corpus(path):
    if path is None:
        return _BUILTIN
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return f.read()


def run(args) -> dict:
    """Train and sample; returns the losses of the steps this run took,
    the step it started at (after a resume), the world and the model."""
    text = load_corpus(args.data)
    chars = sorted(set(text))
    c2i = {c: i for i, c in enumerate(chars)}
    ids = np.array([c2i[c] for c in text], np.int64)
    print(f"corpus: {len(ids)} chars, vocab {len(chars)}")

    if args.remat != "none" and not args.scan_blocks:
        print(f"--remat {args.remat} applies to the scanned decoder "
              "only; forcing --scan-blocks")
        args.scan_blocks = True
    if args.scan_blocks and args.dropout:
        print("scan-blocks decoder is dropout-free; forcing --dropout 0")
        args.dropout = 0.0
    dev = device_module.resolve(args.device)
    tensor.set_seed(args.seed)  # dropout's draws
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    m = GPT(vocab_size=len(chars), d_model=args.d_model,
            num_layers=args.layers, num_heads=args.heads,
            max_len=args.seq, dropout=args.dropout,
            scan_blocks=args.scan_blocks, remat_policy=args.remat,
            device=dev, generator=gen)
    base = opt.AdamW(lr=args.lr)
    world = distributed.process_count()
    if args.shard_states or world > 1:
        if not distributed.is_initialized():
            distributed.init(device=dev)
        m.set_optimizer(opt.DistOpt(base, mesh=distributed.global_mesh(),
                                    shard_states=args.shard_states))
        print(f"DistOpt over {world} chips ("
              f"{torch.distributed.get_backend()})"
              + (" (ZeRO-1 sharded slots)" if args.shard_states else ""))
    else:
        m.set_optimizer(base)

    # stride-1 windows so sampling's sliding context is in-distribution
    n_win = len(ids) - args.seq - 1
    if n_win <= 0:
        raise SystemExit(
            f"corpus has {len(ids)} chars but --seq {args.seq} needs at "
            f"least {args.seq + 2}; shrink --seq or supply more text")
    batch = args.batch * world

    def make_batch(step):
        # per-step seeding: a resumed run continues the batch stream
        rng = np.random.default_rng((args.seed, step))
        starts = rng.integers(0, n_win, size=batch)
        xs = np.stack([ids[s:s + args.seq] for s in starts])
        ys = np.stack([ids[s + 1:s + args.seq + 1] for s in starts])
        return (torch.from_numpy(xs).to(m.device),
                torch.from_numpy(ys).to(m.device))

    bx, _ = make_batch(0)
    m.compile([bx], is_train=True, use_graph=True, precision=args.precision)

    # parameters, buffers and every optimizer state (ZeRO-1's shards in
    # canonical form), the generators and the step
    from singa_tpu_torch.utils import checkpoint as ckpt

    start_step = ckpt.maybe_resume(m, m.optimizer, args.checkpoint)
    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        bx, by = make_batch(step)
        _, loss = m(bx, by)
        losses.append(loss)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (batch * args.seq * (step - start_step + 1)
                     / max(dt, 1e-9))
            print(f"step {step}: loss {float(loss.item()):.4f} "
                  f"({tok_s:.0f} tok/s)")
        if args.checkpoint and args.save_every and \
                (step + 1) % args.save_every == 0:
            ckpt.save_checkpoint(m, m.optimizer, args.checkpoint, step)

    if args.sample_chars > 0:
        m.eval()
        out = m.generate(ids[:args.seq], n_new=args.sample_chars,
                         window=args.seq, temperature=args.temperature,
                         seed=args.seed)
        print("--- sample ---")
        print("".join(chars[i] for i in out[0]))
    return {"losses": [float(v) for v in losses], "start": start_step,
            "world": world, "model": m}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", default=None,
                   help="text corpus (default: builtin)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-chars", type=int, default=160)
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    p.add_argument("--shard-states", action="store_true",
                   help="ZeRO-1 optimizer-state sharding: DistOpt("
                        "shard_states=True) over the process group (a "
                        "world of one when none is live)")
    virtual.add_cli_arg(p)
    p.add_argument("--scan-blocks", action="store_true",
                   help="scan-over-layers decoder "
                        "(layer.ScanTransformerStack), dropout-free")
    p.add_argument("--remat", choices=["none", "per_block", "dots_saveable"],
                   default="none",
                   help="rematerialization policy of the scanned decoder "
                        "(implies --scan-blocks)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory: auto-resume if it holds "
                        "one, save every --save-every steps")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint cadence in steps (0 = never)")
    return p


def main(argv=None):
    live = distributed.is_initialized()
    args = parser().parse_args(argv)
    virtual.ensure_from_args(args, "singa_tpu_torch.examples.gpt_lm", argv)
    try:
        run(args)
    finally:
        if not live:
            distributed.shutdown()


if __name__ == "__main__":
    main()
