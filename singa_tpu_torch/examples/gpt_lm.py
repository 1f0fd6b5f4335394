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

--shard-states, --virtual-devices and --checkpoint raise, naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import opt
from singa_tpu_torch.models.gpt import GPT

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


def _refuse_unported(args):
    for flag, val, item in (
            ("--shard-states", args.shard_states, "12 (DistOpt, ZeRO-1)"),
            ("--virtual-devices", args.virtual_devices,
             "20 (utils/virtual.py)"),
            ("--checkpoint", args.checkpoint, "17 (checkpointing)")):
        if val:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1 item {item})")


def run(args):
    _refuse_unported(args)
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    m = GPT(vocab_size=len(chars), d_model=args.d_model,
            num_layers=args.layers, num_heads=args.heads,
            max_len=args.seq, dropout=args.dropout,
            scan_blocks=args.scan_blocks, remat_policy=args.remat,
            device=dev, generator=gen)
    m.set_optimizer(opt.AdamW(lr=args.lr))

    # stride-1 windows so sampling's sliding context is in-distribution
    n_win = len(ids) - args.seq - 1
    if n_win <= 0:
        raise SystemExit(
            f"corpus has {len(ids)} chars but --seq {args.seq} needs at "
            f"least {args.seq + 2}; shrink --seq or supply more text")

    def make_batch(step):
        rng = np.random.default_rng((args.seed, step))
        starts = rng.integers(0, n_win, size=args.batch)
        xs = np.stack([ids[s:s + args.seq] for s in starts])
        ys = np.stack([ids[s + 1:s + args.seq + 1] for s in starts])
        return (torch.from_numpy(xs).to(m.device),
                torch.from_numpy(ys).to(m.device))

    bx, _ = make_batch(0)
    m.compile([bx], is_train=True, use_graph=True, precision=args.precision)

    t0 = time.time()
    for step in range(args.steps):
        bx, by = make_batch(step)
        _, loss = m(bx, by)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = args.batch * args.seq * (step + 1) / max(dt, 1e-9)
            print(f"step {step}: loss {float(loss.item()):.4f} "
                  f"({tok_s:.0f} tok/s)")

    if args.sample_chars > 0:
        m.eval()
        out = m.generate(ids[:args.seq], n_new=args.sample_chars,
                         window=args.seq, temperature=args.temperature,
                         seed=args.seed)
        print("--- sample ---")
        print("".join(chars[i] for i in out[0]))


def main(argv=None):
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
                   help="ZeRO-1 optimizer-state sharding (not ported)")
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="virtual multi-device run (not ported)")
    p.add_argument("--scan-blocks", action="store_true",
                   help="scan-over-layers decoder "
                        "(layer.ScanTransformerStack), dropout-free")
    p.add_argument("--remat", choices=["none", "per_block", "dots_saveable"],
                   default="none",
                   help="rematerialization policy of the scanned decoder "
                        "(implies --scan-blocks)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint archive path (not ported)")
    run(p.parse_args(argv))


if __name__ == "__main__":
    main()
