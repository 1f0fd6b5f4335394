"""ONNX import of a model-zoo file (counterpart of examples/onnx_zoo.py,
the reference's judged sonnx configuration: ResNet-50 / BERT-base).

Loads an .onnx file with `sonnx.prepare(model, device)` and runs it
twice (the first run reads the graph's static inputs on the host). With
no `--model`, it shows the whole path on the port's own ResNet-50
(seeded random weights, no file needed): export it with `sonnx.to_onnx`,
import the bytes, and hold the imported logits to the source model's
eval forward within 1e-3 of max|logit|. Runs on the card unless
`--device cpu`:

    python -m singa_tpu_torch.examples.onnx_zoo
    python -m singa_tpu_torch.examples.onnx_zoo --model resnet50-v1-7.onnx

A real zoo file must be on the machine; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import sonnx
from singa_tpu_torch.models.resnet import resnet50


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default=None, help=".onnx file to import")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    args = ap.parse_args(argv)
    dev = device_module.resolve(args.device)
    rng = np.random.default_rng(0)

    if args.model:
        print(f"importing {args.model}")
        rep = sonnx.prepare(args.model, device=dev)
        m = rep.model
        shapes = [[d.dim_value or args.batch
                   for d in vi.type.tensor_type.shape.dim]
                  for vi in m._graph.input if vi.name in m._input_names]
        print(f"inputs: {list(zip(m._input_names, shapes))}")
        feeds = [rng.normal(size=s).astype(np.float32) for s in shapes]
        ref = None
    else:
        print("no --model given: exporting the port's ResNet-50 to ONNX, "
              "then importing it back (round trip)")
        src = resnet50(num_classes=1000, device=dev)
        x = torch.from_numpy(rng.normal(size=(args.batch, 3, 224, 224))
                             .astype(np.float32)).to(dev)
        src.compile([x], is_train=False, use_graph=False)
        t0 = time.time()
        blob = sonnx.proto.encode_model(sonnx.to_onnx(src, [x]))
        n_nodes = len(sonnx.proto.decode_model(blob).graph.node)
        print(f"exported {len(blob) / 1e6:.1f} MB of ONNX in "
              f"{time.time() - t0:.1f}s ({n_nodes} nodes)")
        rep = sonnx.prepare(blob, device=dev)
        feeds = [x]
        with torch.no_grad():
            ref = src(x).cpu().numpy()

    t0 = time.time()
    outs = rep.run(feeds)
    _sync(dev)
    print(f"first run (records statics): {time.time() - t0:.2f}s")
    t0 = time.time()
    outs = rep.run(feeds)
    _sync(dev)
    print(f"second run: {time.time() - t0:.3f}s; output shapes "
          f"{[o.shape for o in outs]}")
    if ref is not None:
        err = float(np.abs(outs[0] - ref).max())
        scale = float(np.abs(ref).max())
        print(f"round trip: max|d| {err:.3e}, max|logit| {scale:.3e}")
        if not err <= 1e-3 * scale:
            raise SystemExit("round-trip outputs differ from the source "
                             "model's")
        print("round-trip outputs match the source model")


if __name__ == "__main__":
    main()
