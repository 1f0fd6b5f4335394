"""MLP trainer on MNIST (counterpart of examples/mlp_mnist.py, the
reference's judged eager configuration: the reference SINGA's autograd
MLP example).

Eager training, op by op, as the judged configuration runs it:
`compile(..., use_graph=False)`, `SGD(momentum=0.9, weight_decay=1e-5)`.
Each split is uploaded once and every epoch shuffles and slices it on
the device (`utils.data.device_batches`); the loss and the count of
correct predictions add up on the device, with one host read per epoch.
Prints each epoch's mean training loss and validation accuracy. MNIST is
read from ``$SINGA_DATA_DIR/mnist`` (or ``~/data/mnist``) when its four
files are there, else the reference's synthetic set stands in. Runs on
the card unless `--device cpu`:

    python -m singa_tpu_torch.examples.mlp_mnist --epochs 3
    python -m singa_tpu_torch.examples.mlp_mnist --device cpu --epochs 1
"""

from __future__ import annotations

import argparse
import time

import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import opt, tensor
from singa_tpu_torch.models.mlp import MLP
from singa_tpu_torch.utils import data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    args = ap.parse_args(argv)

    dev = device_module.resolve(args.device)
    print(f"device: {dev}")
    xt, yt, xv, yv = data.load_mnist(flatten=True)
    print(f"train {xt.shape}, val {xv.shape}")

    torch.manual_seed(0)  # dropout's draws
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = MLP(perceptron_size=args.hidden, num_classes=10,
                in_features=xt.shape[1], device=dev, generator=gen)
    model.set_optimizer(opt.SGD(lr=args.lr, momentum=0.9,
                                weight_decay=1e-5))
    txt, tyt = tensor.from_numpy(xt, dev), tensor.from_numpy(yt, dev)
    txv, tyv = tensor.from_numpy(xv, dev), tensor.from_numpy(yv, dev)
    model.compile([txt[:args.batch]], is_train=True, use_graph=False)

    for epoch in range(args.epochs):
        t0 = time.time()
        loss_sum = torch.zeros((), device=dev)
        n_batches = 0
        for bx, by in data.device_batches(txt, tyt, args.batch, seed=epoch):
            _, loss = model(bx, by)
            loss_sum += loss.detach()
            n_batches += 1
        model.eval()
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        total = 0
        for bx, by in data.device_batches(txv, tyv, args.batch,
                                          shuffle=False):
            correct += (tensor.argmax(model(bx), axis=1) == by).sum()
            total += bx.shape[0]
        model.train(True)
        loss_total, n_correct = torch.stack(
            [loss_sum, correct.to(loss_sum.dtype)]).tolist()  # one read
        loss_mean = loss_total / max(1, n_batches)
        acc = n_correct / max(1, total)
        print(f"epoch {epoch}: loss {loss_mean:.4f} val_acc {acc:.4f} "
              f"({time.time() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
