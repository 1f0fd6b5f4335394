"""The reference's side of the `--virtual-devices` parity tests: one of
the reference's example scripts run under its own `--virtual-devices N`
(its re-exec onto an N-device virtual CPU mesh), from given initial
states.

    SINGA_TORCH_INIT_STATES=states.zip \\
        python tests/helper_torch_virtual.py examples/dist_imagenet.py \\
        --virtual-devices 2 --steps 3 ...

Right after the script's `Model.compile` (which makes the parameters),
the model loads the `Model.save_states` archive named by
`SINGA_TORCH_INIT_STATES` (the port writes the reference's layout), so
that the reference trains from the port's initial weights: the two
packages draw their initial weights from different generators. The
re-exec that `singa_tpu.utils.virtual.ensure` makes runs this helper
again, so the loading survives it. The script's stdout is the
reference's own.
"""

import os
import runpy
import sys

HERE = os.path.abspath(__file__)


def fail_rank(rank: int) -> None:
    """Two virtual-device ranks meet in a barrier; then rank `rank`
    raises, its message stamped with `time.monotonic()` (one clock for
    every process of the machine) just before, and its peer waits where
    it cannot see the failure: a gloo collective would notice the closed
    connection and fail at once, as a rank inside a wait on a card does
    not. Only the parent's kill after `virtual.GRACE_S` ends the peer."""
    import time

    import torch.distributed as dist

    from singa_tpu_torch.utils import virtual

    virtual.ensure(2, "tests.helper_torch_virtual",
                   ["--fail-rank", str(rank)])
    dist.barrier()
    if dist.get_rank() == rank:
        raise RuntimeError(
            f"rank {rank} fails on purpose at {time.monotonic():.6f}")
    time.sleep(3600)  # never returns on its own


def main() -> None:
    if sys.argv[1] == "--fail-rank":
        return fail_rank(int(sys.argv[2]))
    script, argv = sys.argv[1], sys.argv[2:]
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    real_execve = os.execve

    def execve(exe, args, env):
        # the re-exec of `script`: through this helper again
        real_execve(exe, [exe, HERE, *args[1:]], env)

    os.execve = execve
    from singa_tpu import model as model_module

    compile_ = model_module.Model.compile

    def compile(self, *args, **kwargs):
        out = compile_(self, *args, **kwargs)
        self.load_states(os.environ["SINGA_TORCH_INIT_STATES"])
        return out

    model_module.Model.compile = compile
    sys.argv = [script, *argv]
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
