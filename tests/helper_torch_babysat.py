"""The babysat trainer on the port: the counterpart of
`__graft_entry__.py`'s ``babysat-trainer`` entry, with the same contract.

    python -m tests.helper_torch_babysat CKPT_DIR N_STEPS [--hang]
        [--device cpu]

A small Linear-ReLU-Linear net under SGD with momentum, its step
captured (graph mode; uncaptured on the CPU); a `Watchdog` around every
step, whose heartbeat file comes from ``SINGA_HEARTBEAT_FILE`` (the
babysitter's env); a `resilience.save` after every step; a resume from
the latest committed step. With ``--hang`` the process freezes itself
with SIGSTOP at step 1, on its first incarnation only (the babysitter's
``SINGA_BABYSIT_RESTARTS`` is 0 there: the respawn count crosses the
process boundary through the env).
"""

import argparse
import sys

import numpy as np
import torch


def build(device: str):
    from singa_tpu_torch import autograd, layer, model, opt

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(7)
            self.fc1 = layer.Linear(16, in_features=12, device=device,
                                    generator=gen)
            self.act = layer.ReLU()
            self.fc2 = layer.Linear(4, in_features=16, device=device,
                                    generator=gen)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    torch.manual_seed(7)
    m = Net()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 4).astype(np.int64))
    x, y = x.to(device), y.to(device)
    m.compile([x], is_train=True, use_graph=True)
    return m, x, y


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tests.helper_torch_babysat")
    p.add_argument("ckpt_dir")
    p.add_argument("n_steps", type=int)
    p.add_argument("--hang", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from singa_tpu_torch import resilience
    from singa_tpu_torch.resilience import counters, faults

    m, x, y = build(args.device)
    start = 0
    try:
        start = int(resilience.restore(args.ckpt_dir, m,
                                       m.optimizer)["step"])
    except resilience.CheckpointError:
        pass  # the first incarnation: nothing committed yet
    wd = resilience.Watchdog(timeout_s=3600.0)  # heartbeat from the env
    stop = (faults.hard_hang_at(1)
            if args.hang and counters.snapshot().get(
                "restarts_external", 0) == 0
            else None)
    for step in range(start, args.n_steps):
        with wd.guard(step):
            if stop is not None:
                stop(step, None)
            m.train_one_batch(x, y)
        resilience.save(args.ckpt_dir, m, m.optimizer, step=step + 1,
                        data_cursor=step + 1)
    print(f"babysat trainer done at step {args.n_steps} (started {start}, "
          f"restarts_external="
          f"{counters.snapshot().get('restarts_external', 0)})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
