"""Long-context training through sequence parallelism (counterpart of
examples/long_context.py).

Shards the SEQUENCE over a (data, sp) mesh of the process group, so
each rank holds T/sp tokens and attention runs as an exact ring over
the "sp" axis (`parallel/ring.py`) or, with `--seq-impl ulysses`, as
Ulysses' all-to-all (`parallel/ulysses.py`). The trainer is the same
`Model.compile` + `train_one_batch` surface as every other example: the
distributed step cuts the token arguments along the sequence from the
model's `seq_axis` and `seq_sharded_args`, the model switches to ring
attention inside the "sp" axis, and DistOpt averages the gradients
over the seq axis before its data-axis sync. `--dp N` adds a data axis.

    python -m singa_tpu_torch.examples.long_context --seq-len 512
    python -m singa_tpu_torch.examples.long_context --device cpu \\
        --steps 2 --seq-len 64 --layers 1 --d-model 64 --heads 2

At world 1 (no live group) `run` makes a group of one in-process: NCCL
on the card, gloo with `--device cpu`; the mesh is (data 1, sp 1), so
the ring is one diagonal block. Inside a live group of several
processes `run(args)` trains over that group (sp = world / dp), as
`gpt_lm.run` does. `--virtual-devices N` runs the trainer as N gloo
ranks, one CPU process each (`utils.virtual`), the reference's
virtual mesh:

    python -m singa_tpu_torch.examples.long_context --virtual-devices 2 \
        --device cpu --steps 2 --seq-len 128 --layers 1 --d-model 64 \
        --heads 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import distributed, opt, tensor
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.parallel import mesh as mesh_module
from singa_tpu_torch.utils import virtual


def run(args) -> dict:
    """Train; returns the losses of every step, the mesh shape and the
    model."""
    dev = device_module.resolve(args.device)
    if not distributed.is_initialized():
        distributed.init(device=dev)
    n_dev = distributed.process_count()
    dp = args.dp
    sp = n_dev // dp
    if dp * sp != n_dev:
        raise SystemExit(f"--dp {dp} must divide the {n_dev} processes")
    mesh = mesh_module.get_mesh((dp, sp), ("data", "sp"))
    if args.seq_len % sp:
        raise SystemExit(f"--seq-len must be divisible by {sp} seq shards")
    print(f"mesh (data={dp}, sp={sp}); global context {args.seq_len} "
          f"({args.seq_len // sp} tokens/chip), impl={args.seq_impl}")

    tensor.set_seed(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = GPT(vocab_size=args.vocab, d_model=args.d_model,
                num_layers=args.layers, num_heads=args.heads,
                max_len=args.seq_len, dropout=0.0, seq_axis="sp",
                remat=True, seq_impl=args.seq_impl, device=dev,
                generator=gen)
    model.set_optimizer(
        opt.DistOpt(opt.SGD(lr=args.lr), mesh=mesh, axis_name="data"))

    rng = np.random.default_rng(0)
    batch = args.batch * dp
    ids = rng.integers(0, args.vocab, size=(batch, args.seq_len))
    x = torch.from_numpy(ids).to(dev)
    y = torch.from_numpy(np.roll(ids, -1, axis=1)).to(dev)
    model.compile([x], is_train=True, use_graph=True)
    n_params = sum(p.numel() for p in model.get_params().values())
    print(f"model: {n_params / 1e6:.2f}M params, {args.layers} layers")

    losses = []
    for i in range(args.steps):
        t0 = time.time()
        _, loss = model.train_one_batch(x, y)
        lval = float(loss.item())
        dt = time.time() - t0
        losses.append(lval)
        print(f"step {i}: loss {lval:.4f} "
              f"{batch * args.seq_len / dt:.0f} tok/s ({dt * 1e3:.0f} ms)")
    return {"losses": losses, "mesh": dict(mesh.shape), "model": model}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch", type=int, default=2, help="per-data-shard")
    p.add_argument("--dp", type=int, default=1,
                   help="data-axis size; the seq axis gets the rest")
    p.add_argument("--vocab", type=int, default=1000)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seq-impl", choices=("ring", "ulysses"),
                   default="ring")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    virtual.add_cli_arg(p)
    return p


def main(argv=None):
    live = distributed.is_initialized()
    args = parser().parse_args(argv)
    virtual.ensure_from_args(args, "singa_tpu_torch.examples.long_context",
                             argv)
    try:
        run(args)
    finally:
        if not live:
            distributed.shutdown()


if __name__ == "__main__":
    main()
