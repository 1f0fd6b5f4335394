"""Char-RNN trainer (counterpart of examples/char_rnn.py, the reference's
judged RNN/LSTM configuration).

Reads a text corpus (a built-in one by default), builds a character
vocabulary, trains an LSTM LM on fixed-length chunks (truncated BPTT)
with Adam, then samples text. The step runs in graph mode: on the card
each training step (embedding, the LSTM loop forward, backward through
time, the Adam update) is captured once as one CUDA Graph and replayed;
`--no-graph` runs it eagerly. Runs on the card unless `--device cpu`:

    python -m singa_tpu_torch.examples.char_rnn --steps 300
    python -m singa_tpu_torch.examples.char_rnn --device cpu --steps 6 \\
        --hidden 32 --embed 16 --layers 1 --seq-len 16 --batch 8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from singa_tpu_torch import device as device_module
from singa_tpu_torch import opt
from singa_tpu_torch.models.char_rnn import CharRNN

_BUILTIN = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump! "
) * 50


def load_corpus(path):
    if path is None:
        return _BUILTIN
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return f.read()


def sample(m, idx_to_char, char_to_idx, seed_text, n_chars,
           temperature=0.8):
    """Sample `n_chars` by re-running the forward over the last 32
    characters (left-padded with spaces), as the reference does."""
    m.eval()
    window = 32
    text = seed_text
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for _ in range(n_chars):
            ctx = text[-window:].rjust(window)
            x = torch.tensor([[char_to_idx.get(c, 0) for c in ctx]])
            p = m(x)[0, -1].double().cpu().numpy() / temperature
            p = np.exp(p - p.max())
            p = p / p.sum()
            text += idx_to_char[int(rng.choice(len(p), p=p))]
    m.train()
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default=None, help="text corpus path")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--embed", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--no-graph", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    args = ap.parse_args(argv)

    text = load_corpus(args.data)
    chars = sorted(set(text))
    char_to_idx = {c: i for i, c in enumerate(chars)}
    idx_to_char = {i: c for i, c in enumerate(chars)}
    data = np.array([char_to_idx[c] for c in text], dtype=np.int64)
    print(f"corpus: {len(text)} chars, vocab {len(chars)}")

    dev = device_module.resolve(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = CharRNN(vocab_size=len(chars), hidden_size=args.hidden,
                embed_dim=args.embed, num_layers=args.layers, device=dev,
                generator=gen)
    m.set_optimizer(opt.Adam(lr=args.lr))

    rng = np.random.default_rng(1)
    T, B = args.seq_len, args.batch

    def batch():
        starts = rng.integers(0, len(data) - T - 1, size=B)
        x = np.stack([data[s:s + T] for s in starts])
        y = np.stack([data[s + 1:s + T + 1] for s in starts])
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    x0, _ = batch()
    m.compile([x0], is_train=True, use_graph=not args.no_graph)

    for step in range(args.steps):
        x, y = batch()
        _, loss = m.train_one_batch(x, y)
        if step % 50 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss.item():.4f}")

    print("--- sample ---")
    print(sample(m, idx_to_char, char_to_idx, "the ", 200))


if __name__ == "__main__":
    main()
