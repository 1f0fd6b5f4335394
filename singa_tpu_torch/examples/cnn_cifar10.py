"""AlexNet / VGG / ResNet on CIFAR-10 (counterpart of
examples/cnn_cifar10.py).

The reference trainer's surface: pick a model, set its internal image
layout, SGD (momentum 0.9, weight decay 5e-4) with a linear lr warmup,
`compile(..., is_train=True, use_graph=True)`, then `model(x, y)` per
batch; after each epoch the validation accuracy. With more than one
epoch it ends with the loss sanity check, exiting 1 when the last
epoch's mean loss is not below the first's. Runs on the card unless
`--device cpu`:

    python -m singa_tpu_torch.examples.cnn_cifar10 --model resnet --epochs 5
    python -m singa_tpu_torch.examples.cnn_cifar10 --device cpu \\
        --model resnet --epochs 2 --batch 32

Under `--layout NHWC` (the default) every max-pool runs through
`ops.max_pool.maxpool2d_nhwc`, whose CUDA backward is off by default, as
in the reference (`set_pool_kernel_enabled`). `--dist`, `--dist-option`,
`--spars`, `--checkpoint`, `--virtual-devices` and `--loader prefetch`
raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import opt
from singa_tpu_torch.models import alexnet_cifar, resnet20_cifar, vgg16_cifar
from singa_tpu_torch.utils import data

MODELS = {"alexnet": alexnet_cifar, "vgg": vgg16_cifar,
          "resnet": resnet20_cifar}

# alexnet_cifar has no BatchNorm: SGD at the BN models' 0.05 diverges
DEFAULT_LR = {"alexnet": 0.005, "vgg": 0.05, "resnet": 0.05}


def _refuse_unported(args):
    for flag, val, item in (
            ("--dist", args.dist, "12 (DistOpt)"),
            ("--dist-option", args.dist_option != "plain", "12 (DistOpt)"),
            ("--spars", args.spars is not None, "12 (DistOpt)"),
            ("--checkpoint", args.checkpoint, "17 (checkpointing)"),
            ("--virtual-devices", args.virtual_devices,
             "20 (utils/virtual.py)"),
            ("--loader prefetch", args.loader == "prefetch",
             "20 (the native prefetch loader)")):
        if val:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1 item {item})")


def run(args) -> int:
    """Train; returns the exit code (1 when the loss did not fall)."""
    _refuse_unported(args)
    if args.lr is None:
        args.lr = DEFAULT_LR[args.model]
    dev = device_module.resolve(args.device)
    xt, yt, xv, yv = data.load_cifar10()
    print(f"train {xt.shape}, val {xv.shape}, device {dev}")

    model = MODELS[args.model](device=dev)
    model.set_image_layout(args.layout)
    model.set_optimizer(opt.SGD(lr=opt.Warmup(args.lr, args.warmup),
                                momentum=0.9, weight_decay=5e-4))

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    model.compile([on_dev(xt[:args.batch])], is_train=True,
                  use_graph=not args.no_graph)

    epoch_losses = []
    for epoch in range(args.epochs):
        t0 = time.time()
        tot_loss = n = seen = 0
        for bx, by in data.batches(xt, yt, args.batch, seed=epoch):
            _, loss = model(on_dev(bx), on_dev(by))
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
                   help="default: 0.05 for resnet/vgg (BatchNorm models), "
                        "0.005 for alexnet (no BN; diverges at 0.05)")
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
                   help="DistOpt data parallelism (not ported)")
    p.add_argument("--dist-option", default="plain",
                   choices=["plain", "half", "sparse-topk", "sparse-thresh"],
                   help="gradient sync mode of DistOpt (not ported)")
    p.add_argument("--spars", type=float, default=None,
                   help="sparsity of the sparse dist options (not ported)")
    p.add_argument("--loader", choices=["prefetch", "sync"], default="sync",
                   help="host input pipeline: synchronous slicing (the "
                        "default here) or the native threaded prefetcher "
                        "(not ported)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint archive path (not ported)")
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="virtual multi-device run (not ported)")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
