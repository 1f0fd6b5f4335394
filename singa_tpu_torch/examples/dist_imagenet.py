"""DistOpt ResNet-50 on ImageNet-shaped data (counterpart of
examples/dist_imagenet.py, the reference's judged configuration 5).

Data parallel over a `torch.distributed` group, one process a device:
NCCL on the card, gloo with `--device cpu`. Every process runs this
trainer with its `--rank`; `--world` and `--coordinator` ("host:port",
or an init method such as "file:///tmp/rdv") make the group, and a
world of one (the default) needs no address. The step, captured as
one CUDA Graph on the card, is the forward, the backward, DistOpt's
sync (`--dist-option`: plain fused buckets of `--buffer-elems`, the
bf16 wire, sparse top-k or threshold with error feedback), the global
norm clip and SGD with momentum 0.9 and weight decay 1e-4 under a
linear warmup. BatchNorm syncs its moments over the group. Reports the
judged metrics, images/s/chip and the all-reduce GB/s a step implies,
and ends with the reference's loss-sanity check (exit 1 on
divergence). Runs on the card unless `--device cpu`:

    python -m singa_tpu_torch.examples.dist_imagenet --steps 6
    python -m singa_tpu_torch.examples.dist_imagenet --device cpu \\
        --steps 3 --batch-per-chip 2 --image-size 32 --classes 10

The data is `utils.data.synthetic_imagenet` (nothing is downloaded).
`--checkpoint DIR --save-every N` saves a resilience checkpoint every N
steps (every rank joins the sharded commit; DistOpt's per-rank states
in canonical form) and resumes from DIR when it holds one; a resumed
run takes `--steps` further steps; under `--loader sync` its batches
continue the stream at the resumed step, while the prefetch stream
starts again from its seed, as the reference's does.

`--loader prefetch` (the default, as in the reference) feeds the steps
from the native threaded prefetcher (`utils.data.prefetch_batches` over
native/dataloader_core.cc, zero-copy views); `--loader sync` slices the
arrays in order. Each rank of a group takes its share of the global
batch either way. `--virtual-devices N` runs the trainer as N gloo
ranks, one CPU process each (`utils.virtual`):

    python -m singa_tpu_torch.examples.dist_imagenet --virtual-devices 2 \
        --device cpu --steps 3 --batch-per-chip 2 --image-size 32 \
        --classes 10
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from singa_tpu_torch import distributed as dist_mod
from singa_tpu_torch import opt
from singa_tpu_torch.models import resnet50
from singa_tpu_torch.utils import data, virtual


def builtins_sum_bytes(model) -> int:
    """The fp32 gradient payload of a step: 4 bytes a parameter."""
    return sum(int(np.prod(p.shape)) * 4
               for p in model.get_params().values())


def run(args) -> dict:
    """Train; returns the losses, the steady images/s/chip, the host
    seconds each step waited on the loader, the loss-sanity verdict
    ("ok" None when the run was too short to judge) and the model. A
    live group (a virtual-device child's) is trained over as it is
    unless --world is given."""
    if args.coordinator and not args.world:
        raise SystemExit("--coordinator requires --world and --rank")
    if args.world or not dist_mod.is_initialized():
        dist_mod.init(args.coordinator, num_processes=args.world or 1,
                      process_id=args.rank, device=args.device)
    dev = dist_mod.device()
    mesh = dist_mod.global_mesh()
    world, n_proc = mesh.size, dist_mod.process_count()
    batch = args.batch_per_chip * world
    print(f"mesh: {world} chips / {n_proc} processes "
          f"({torch.distributed.get_backend()}), global batch {batch}, "
          f"device {dev}")

    lr = 0.1 * batch / 256.0 if args.lr is None else args.lr
    torch.manual_seed(0)
    model = resnet50(num_classes=args.classes, device=dev)
    model.set_image_layout(args.layout)
    sgd = opt.SGD(lr=opt.Warmup(lr, args.warmup), momentum=0.9,
                  weight_decay=1e-4,
                  clip_norm=args.clip_norm if args.clip_norm > 0 else None)
    dist_opt = opt.DistOpt(sgd, mesh=mesh, buffSize=args.buffer_elems,
                           use_sparse=args.dist_option.startswith("sparse"))
    model.set_optimizer(dist_opt)

    x, y = data.synthetic_imagenet(n=max(batch * 4, 64),
                                   classes=args.classes,
                                   size=args.image_size)
    model.compile([torch.from_numpy(x[:batch]).to(dev)], is_train=True,
                  use_graph=True, precision=args.precision)

    from singa_tpu_torch.utils import checkpoint as ckpt

    start_step = ckpt.maybe_resume(model, dist_opt, args.checkpoint)
    n_grad_bytes = builtins_sum_bytes(model)
    print(f"model gradient payload: {n_grad_bytes / 1e6:.1f} MB/step")

    def make_batch(bx, by):
        # `.to(dev)` (and shard_batch's) is a blocking copy: a prefetched
        # view is read whole before the next batch is asked for. On the
        # CPU it is the view itself, which the step reads before it
        # returns its loss.
        if n_proc == 1:
            return (torch.from_numpy(bx).to(dev),
                    torch.from_numpy(by.astype(np.int64)).to(dev))
        # each process's own slice: its share of the global batch
        per = len(bx) // n_proc
        lo = dist_mod.process_index() * per
        return dist_mod.shard_batch(mesh, (bx[lo:lo + per],
                                           by[lo:lo + per].astype(np.int64)))

    if args.loader == "prefetch":
        # copy=False: each step's loss is read (the step is done with
        # its batch) before the next view is asked for. As in the
        # reference, a resumed run's stream starts again from the seed.
        batch_iter = data.prefetch_batches(x, y, batch, args.steps,
                                           copy=False)
    else:
        def _sync_iter():
            for rel_step in range(args.steps):
                lo = ((start_step + rel_step) * batch) % (len(x) - batch)
                yield x[lo:lo + batch], y[lo:lo + batch]

        batch_iter = _sync_iter()

    times, losses, waits = [], [], []
    t_ask = time.perf_counter()
    for rel_step, (bx, by) in enumerate(batch_iter):
        waits.append(time.perf_counter() - t_ask)
        step = start_step + rel_step
        t0 = time.time()
        tbx, tby = make_batch(bx, by)
        _, loss = model(tbx, tby, args.dist_option, args.spars)
        losses.append(loss.item())
        dt = time.time() - t0
        times.append(dt)
        if args.checkpoint and args.save_every and \
                (step + 1) % args.save_every == 0:
            ckpt.save_checkpoint(model, dist_opt, args.checkpoint, step)
        if rel_step == 0:
            print(f"step {step} (first, uncaptured): {dt:.1f}s  "
                  f"loss {losses[0]:.4f}")
        else:
            # a ring all-reduce moves 2 (W - 1) / W of the payload a chip
            ring = 2 * (world - 1) / world * n_grad_bytes
            print(f"step {step}: loss {losses[-1]:.4f} "
                  f"{batch / dt / world:.1f} img/s/chip "
                  f"allreduce ~{ring / dt / 1e9:.2f} GB/s/chip "
                  f"({dt * 1e3:.0f} ms)")
        t_ask = time.perf_counter()
    out = {"losses": losses, "img_s_chip": None, "ok": None,
           "world": world, "start": start_step, "loader_wait_s": waits}
    if len(times) > 2:
        # the first two calls run uncaptured and capture the graph
        steady = sum(times[2:]) / len(times[2:])
        out["img_s_chip"] = batch / steady / world
        print(f"steady state: {out['img_s_chip']:.1f} images/sec/chip "
              f"on {world} chips")
    if args.dist_option == "sparse-thresh":
        print(f"threshold sparsifier: {dist_opt.sparse_dropped_last:.0f} "
              "above-threshold entries deferred by the static cap last "
              "step (recovered via error feedback; raise max_frac if "
              "large)")
    if len(losses) > 2:
        # the reference's gate: finite and not exploded past 3x the
        # cold-start loss; runs of 10 or more steps must also fall
        init_loss = math.log(args.classes)
        ok = math.isfinite(losses[-1]) and losses[-1] < 3.0 * init_loss
        if args.steps >= 10:
            ok = ok and losses[-1] < losses[0]
        out["ok"] = ok
        print(f"loss sanity: first {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f} (init ~{init_loss:.2f}) "
              f"{'ok' if ok else 'DIVERGED'}")
    out["model"] = model
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-per-chip", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=None,
                   help="peak lr; default: linear scaling 0.1 * batch/256")
    p.add_argument("--warmup", type=int, default=10,
                   help="linear lr warmup steps")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory: auto-resume if it holds "
                        "one, save every --save-every steps")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint cadence in steps (0 = never)")
    p.add_argument("--loader", choices=["prefetch", "sync"],
                   default="prefetch",
                   help="host input pipeline: the native threaded "
                        "prefetcher (default) or synchronous slicing")
    p.add_argument("--clip-norm", type=float, default=10.0,
                   help="global gradient-norm clip (<=0 disables)")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--layout", choices=["NCHW", "NHWC"], default="NHWC",
                   help="internal image layout (NHWC: channels-last "
                        "memory)")
    p.add_argument("--buffer-elems", type=int, default=2 ** 21,
                   help="fused-allreduce bucket size (elements)")
    p.add_argument("--dist-option", default="plain",
                   choices=["plain", "half", "sparse-topk",
                            "sparse-thresh"])
    p.add_argument("--spars", type=float, default=None)
    p.add_argument("--coordinator", default=None,
                   help="rank 0's 'host:port' (or an init method such as "
                        "file:///path); needed when --world > 1")
    p.add_argument("--world", type=int, default=0,
                   help="number of processes (0: one, no rendezvous)")
    p.add_argument("--rank", type=int, default=0,
                   help="this process's rank")
    virtual.add_cli_arg(p)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:<rank>)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    virtual.ensure_from_args(args, "singa_tpu_torch.examples.dist_imagenet",
                             argv)
    try:
        out = run(args)
    finally:
        dist_mod.shutdown()
    return 1 if out["ok"] is False else 0


if __name__ == "__main__":
    sys.exit(main())
