"""Demo multi-device training on one host: `--virtual-devices N` runs the
trainer as N ranks, one CPU process each, over gloo (counterpart of
singa_tpu/utils/virtual.py).

The reference re-executes the script onto an N-device virtual CPU mesh
in one process; PyTorch has no such mesh, so here the parent starts N
children, each the trainer's module run again with its own arguments,
and each child joins a gloo group of N through a `file://` rendezvous in
a temporary directory (`distributed.init(..., device="cpu")`), so the
trainer finds a live group of N ranks. The children get
`CUDA_VISIBLE_DEVICES=""`: none of them touches the card (the
reference scrubs its accelerator environment the same way), and a
CUDA `--device` beside `--virtual-devices` raises. Rank 0 writes to the
parent's stdout; the other ranks' stdout is dropped (they print the
same lines), their stderr kept. The parent waits for every child; when
one fails it kills the rest and exits with the failed child's code
(128 + the signal for a child a signal ended), else 0.

    p = argparse.ArgumentParser()
    virtual.add_cli_arg(p)
    args = p.parse_args(argv)
    virtual.ensure_from_args(args, "pkg.trainer", argv)  # parent: exits

The trainer is re-run as `python -m <module> <argv>`: under pytest
`sys.argv` is pytest's, and under `python -m` `sys.argv[0]` is a file
path, so the caller names its module and passes its own argv.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["add_cli_arg", "ensure_from_args", "ensure", "child_rank"]

#: the child's marker: "rank world init_method"
_MARKER = "SINGA_TORCH_VIRTUAL_RANK"
_ROOT = Path(__file__).resolve().parents[2]
#: seconds the peers of a failed child get before they are killed
GRACE_S = 5.0


def add_cli_arg(parser) -> None:
    """Attach the standard `--virtual-devices N` option to an argparse
    parser (trainers call this, then `ensure_from_args`)."""
    parser.add_argument(
        "--virtual-devices", type=int, default=0,
        help="demo multi-device on one host: run the trainer as N ranks, "
             "one CPU process each, over gloo (0 = real devices)")


def child_rank() -> Optional[int]:
    """This process's rank when it is a virtual-device child, else
    None."""
    marker = os.environ.get(_MARKER)
    return int(marker.split()[0]) if marker else None


def ensure_from_args(args, module: str,
                     argv: Optional[Sequence[str]] = None) -> None:
    """`ensure(args.virtual_devices, ...)`; in a child, `args.device`
    becomes "cpu" when it was not given."""
    device = getattr(args, "device", None)
    ensure(getattr(args, "virtual_devices", 0), module, argv, device)
    if child_rank() is not None and device is None:
        args.device = "cpu"


def ensure(n, module: str, argv: Optional[Sequence[str]] = None,
           device=None) -> None:
    """In a child: join the group of N gloo ranks and return. In the
    parent with `n` 0 or None: return. Otherwise run `python -m module
    *argv` (argv defaults to `sys.argv[1:]`) as `n` ranks and exit with
    their outcome (SystemExit)."""
    marker = os.environ.get(_MARKER)
    if marker:
        import torch

        from singa_tpu_torch import distributed

        rank, world, init = marker.split(maxsplit=2)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(world)))
        distributed.init(init, num_processes=int(world),
                         process_id=int(rank), device="cpu")
        return
    if not n:
        return
    n = int(n)
    if n < 1:
        raise ValueError(f"--virtual-devices {n} must be >= 0")
    if device is not None and str(device).startswith("cuda"):
        raise ValueError(
            f"--virtual-devices runs its ranks as CPU processes over gloo; "
            f"it cannot run on --device {device}")
    argv = list(sys.argv[1:] if argv is None else argv)
    raise SystemExit(_spawn(n, module, argv))


def _spawn(n: int, module: str, argv: Sequence[str]) -> int:
    tmp = tempfile.mkdtemp(prefix="singa_virtual_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    procs = []
    try:
        for r in range(n):
            env[_MARKER] = f"{r} {n} file://{tmp}/rendezvous"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv], env=dict(env),
                stdout=None if r == 0 else subprocess.DEVNULL))
        return _wait(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def _wait(procs) -> int:
    """Wait for every child; the first to fail gives the exit code, and
    its peers (a collective with it may never return) are killed after
    `GRACE_S`."""
    failed, failed_at = None, None
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if failed is None:
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                failed, failed_at = _code(bad[0]), time.monotonic()
        elif time.monotonic() > failed_at + GRACE_S:
            break
        time.sleep(0.05)
    if failed is None:
        bad = [c for c in (p.poll() for p in procs) if c]
        failed = _code(bad[0]) if bad else 0
    return failed
