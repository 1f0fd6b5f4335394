"""AlexNet / VGG / ResNet / MobileNetV1 / Xception on CIFAR-10
(counterpart of examples/cnn_cifar10.py).

The reference trainer's surface: pick a model, set its internal image
layout, SGD (momentum 0.9, weight decay 5e-4) with a linear lr warmup,
`compile(..., is_train=True, use_graph=True)`, then `model(x, y,
dist_option, spars)` per batch; after each epoch the validation
accuracy. `--dist` wraps SGD in `DistOpt` over a process group of one
(NCCL on the card, gloo on the CPU), whose `--dist-option` and
`--spars` pick the sync; without it they take a local step, as in the
reference. With more than one
epoch it ends with the loss sanity check, exiting 1 when the last
epoch's mean loss is not below the first's. Runs on the card unless
`--device cpu`:

    python -m singa_tpu_torch.examples.cnn_cifar10 --model resnet --epochs 5
    python -m singa_tpu_torch.examples.cnn_cifar10 --device cpu \\
        --model resnet --epochs 2 --batch 32
    python -m singa_tpu_torch.examples.cnn_cifar10 --model xception --epochs 2

`--model mobilenet` is `mobilenet_v1_cifar` (depthwise-separable units,
no max-pool) and `--model xception` is `xception_cifar` (four max-pools
a step). Under `--layout NHWC` (the default) every max-pool runs through
`ops.max_pool.maxpool2d_nhwc`, whose CUDA backward is off by default, as
in the reference (`set_pool_kernel_enabled`). `--checkpoint DIR`
saves a resilience checkpoint after every epoch and resumes from DIR
when it holds one (its step field counts finished epochs).
`--loader prefetch` (the default, as in the reference) feeds each epoch
from the native threaded prefetcher (`utils.data.prefetch_batches`,
seeded by the epoch, zero-copy views); `--loader sync` takes
`utils.data.batches`' order. `--virtual-devices N` runs the trainer as
N gloo ranks, one CPU process each (`utils.virtual`); with `--dist`
DistOpt then spans the N ranks, each running its share of the batch.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import distributed as dist_mod
from singa_tpu_torch import opt
from singa_tpu_torch.models import (alexnet_cifar, mobilenet_v1_cifar,
                                    resnet20_cifar, vgg16_cifar,
                                    xception_cifar)
from singa_tpu_torch.utils import data, virtual

MODELS = {"alexnet": alexnet_cifar, "vgg": vgg16_cifar,
          "resnet": resnet20_cifar, "mobilenet": mobilenet_v1_cifar,
          "xception": xception_cifar}

# alexnet_cifar has no BatchNorm: SGD at the BN models' 0.05 diverges
DEFAULT_LR = {"alexnet": 0.005, "vgg": 0.05, "resnet": 0.05,
              "mobilenet": 0.05, "xception": 0.05}


def run(args) -> int:
    """Train; returns the exit code (1 when the loss did not fall)."""
    if args.lr is None:
        args.lr = DEFAULT_LR[args.model]
    dev = device_module.resolve(args.device)
    xt, yt, xv, yv = data.load_cifar10()
    print(f"train {xt.shape}, val {xv.shape}, device {dev}")

    model = MODELS[args.model](device=dev)
    model.set_image_layout(args.layout)
    optimizer = opt.SGD(lr=opt.Warmup(args.lr, args.warmup), momentum=0.9,
                        weight_decay=5e-4)
    if args.dist:
        if not dist_mod.is_initialized():
            dist_mod.init(device=dev)
        optimizer = opt.DistOpt(optimizer, mesh=dist_mod.global_mesh(),
                                use_sparse=args.dist_option.startswith(
                                    "sparse"))
        print(f"DistOpt over {optimizer.world_size} chips")
    model.set_optimizer(optimizer)

    def on_dev(a):
        # a blocking copy: a prefetched view is read whole before the
        # next batch is asked for (on the CPU the step reads the view
        # itself before it returns its loss)
        return torch.from_numpy(a).to(dev)

    model.compile([on_dev(xt[:args.batch])], is_train=True,
                  use_graph=not args.no_graph)

    # epoch-granular checkpoint and resume: the step field stores
    # finished EPOCHS for this trainer
    from singa_tpu_torch.utils import checkpoint as ckpt

    start_epoch = ckpt.maybe_resume(model, optimizer, args.checkpoint)
    epoch_losses = []
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        tot_loss = n = seen = 0
        if args.loader == "prefetch":
            # copy=False: each step's loss is read before the next view
            # is asked for
            epoch_iter = data.prefetch_batches(
                xt, yt, args.batch, len(xt) // args.batch, seed=epoch,
                copy=False)
        else:
            epoch_iter = data.batches(xt, yt, args.batch, seed=epoch)
        for bx, by in epoch_iter:
            _, loss = model(on_dev(bx), on_dev(by), args.dist_option,
                            args.spars)
            tot_loss += loss.item()
            n += 1
            seen += len(bx)
        dt = time.time() - t0
        model.eval()
        correct = total = 0
        for bx, by in data.batches(xv, yv, args.batch, shuffle=False):
            pred = model(on_dev(bx)).argmax(1).cpu().numpy()
            correct += int((pred == by).sum())
            total += len(by)
        model.train(True)
        epoch_losses.append(tot_loss / max(1, n))
        print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f} "
              f"val_acc {correct / max(1, total):.4f} "
              f"{seen / dt:.1f} img/s ({dt:.1f}s)")
        if args.checkpoint:
            ckpt.save_checkpoint(model, optimizer, args.checkpoint, epoch)
    if len(epoch_losses) > 1:
        ok = epoch_losses[-1] < epoch_losses[0]
        print(f"loss sanity: {epoch_losses[0]:.4f} -> {epoch_losses[-1]:.4f} "
              f"{'ok' if ok else 'DIVERGED'}")
        if not ok:
            return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=sorted(MODELS), default="resnet")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=None,
                   help="default: 0.05 for the BatchNorm models "
                        "(resnet, vgg, mobilenet, xception), 0.005 for "
                        "alexnet (no BN; diverges at 0.05)")
    p.add_argument("--warmup", type=int, default=50,
                   help="linear lr warmup steps")
    p.add_argument("--layout", choices=["NCHW", "NHWC"], default="NHWC",
                   help="internal image layout (NHWC: channels-last "
                        "memory)")
    p.add_argument("--no-graph", action="store_true",
                   help="eager mode (the step runs uncaptured either way)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    p.add_argument("--dist", action="store_true",
                   help="DistOpt data parallelism over a process group "
                        "of one")
    p.add_argument("--dist-option", default="plain",
                   choices=["plain", "half", "sparse-topk", "sparse-thresh"],
                   help="gradient sync mode of DistOpt")
    p.add_argument("--spars", type=float, default=None,
                   help="sparsity of the sparse dist options")
    p.add_argument("--loader", choices=["prefetch", "sync"],
                   default="prefetch",
                   help="host input pipeline: the native threaded "
                        "prefetcher (default) or synchronous slicing")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory: auto-resume if it holds "
                        "one, save after every epoch")
    virtual.add_cli_arg(p)
    args = p.parse_args(argv)
    live = dist_mod.is_initialized()
    virtual.ensure_from_args(args, "singa_tpu_torch.examples.cnn_cifar10",
                             argv)
    try:
        return run(args)
    finally:
        if not live:
            dist_mod.shutdown()


if __name__ == "__main__":
    sys.exit(main())
