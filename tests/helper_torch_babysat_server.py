"""The babysat server on the port: the counterpart of `__graft_entry__.py`'s
``babysat-server`` entry (`_babysat_server_main`), with the same contract.

    python -m tests.helper_torch_babysat_server DONE_PATH [--hang]
        [--device cpu]

A tiny GPT (vocab 31, d 32, one block, 2 heads, seeded weights) served
through the streaming `Frontend`, whose serve loop touches the
babysitter's heartbeat (``SINGA_HEARTBEAT_FILE``) every scheduler turn.
Three greedy streams of 6 tokens. With ``--hang``, on its first
incarnation only (the babysitter's ``SINGA_BABYSIT_RESTARTS`` is 0), a
token callback SIGSTOPs the process mid-stream: the heartbeat goes
stale, the babysitter SIGKILLs the frozen tree and respawns it. Serving
state lives in the process, so the heal is re-admission: the respawned
incarnation serves every stream again, holds each token-identical to
`generate`, and writes the done marker.
"""

import argparse
import os
import signal
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tests.helper_torch_babysat_server")
    p.add_argument("done_path")
    p.add_argument("--hang", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from singa_tpu_torch.models.gpt import gpt_small
    from singa_tpu_torch.resilience import counters
    from singa_tpu_torch.serving import Frontend, ServingEngine

    torch.manual_seed(0)
    m = gpt_small(vocab_size=31, d_model=32, num_layers=1, num_heads=2,
                  max_len=32, dropout=0.0, device=args.device)
    m.eval()
    eng = ServingEngine(m, slots=2, block_size=8, window=32)
    fe = Frontend(eng)
    first = counters.snapshot().get("restarts_external", 0) == 0
    seen = {"n": 0}

    def trip(tok, done):
        seen["n"] += 1
        if args.hang and first and seen["n"] == 2:
            os.kill(os.getpid(), signal.SIGSTOP)  # frozen mid-stream

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 31, size=int(rng.integers(4, 12)))
               for _ in range(3)]
    handles = [fe.submit(q, 6, on_token=trip if i == 0 else None)
               for i, q in enumerate(prompts)]
    fe.run()
    for h, q in zip(handles, prompts):
        assert h.status == "done" and len(h.tokens) == 6, h.status
        ref = m.generate(q[None], n_new=6, window=32)[0, len(q):]
        assert np.array_equal(np.asarray(h.tokens), ref), (
            f"stream {h.rid} diverged after the heal")
    restarts = counters.snapshot().get("restarts_external", 0)
    with open(args.done_path, "w") as f:
        f.write(f"served {len(handles)} restarts_external={restarts}\n")
    print(f"babysat server done: {len(handles)} streams served, identity "
          f"ok (restarts_external={restarts})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
