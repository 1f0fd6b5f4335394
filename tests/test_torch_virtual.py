"""`--virtual-devices` (singa_tpu_torch.utils.virtual, counterpart of
singa_tpu/utils/virtual.py) on the CPU.

- `python -m singa_tpu_torch.examples.dist_imagenet --virtual-devices 2
  --device cpu` runs the trainer as two gloo ranks, one process each, and
  its losses equal the reference's `examples/dist_imagenet.py
  --virtual-devices 2` with the same flags within rtol 1e-4 (the CNN
  tolerance of tests/test_torch_dist_train.py). The two packages draw
  their initial weights from different generators, so the reference
  starts from the port's initial states, loaded right after its
  `compile` (`tests/helper_torch_virtual.py`; the states are the port's
  after its compile on the same global batch of 4, BatchNorm moments
  included). Two steps are held: from the third on, ResNet-50 at a
  batch of 4 carries rounding past 1e-4 in either package (the
  reference's own world-1 and virtual-2 runs give 2.9227 and 2.9246 at
  step 2). Step 1 holds the gradient sync at the warmup rate: with each
  rank's own gradient in place of the average over both, its loss is
  2.7923, not 2.6051 (long_context's step 1: 6.9232, not 6.9411). A
  larger rate does not hold it better: one update at `--warmup 0`
  already puts the packages 3e-3 apart at world 1. long_context's
  `--virtual-devices 2` is held to the reference's in
  tests/test_torch_long_context.py.
- A rank that raises makes the parent exit non-zero: its peer, blocked
  where it cannot see the failure, is killed after `virtual.GRACE_S`.
  The test times the parent's own life from the rank's failure (the
  rank stamps it) to the parent's exit (a thread waiting on the parent
  stamps it), not from the fixture's start: the parity runs start
  beside it and take their own time.
- A CUDA `--device` beside `--virtual-devices` raises; 0 is a no-op.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from helper_torch_parity import SPAWN_DEADLINE_S
from singa_tpu_torch import distributed
from singa_tpu_torch.examples import dist_imagenet
from singa_tpu_torch.utils import virtual

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--steps", "2", "--batch-per-chip", "2", "--image-size", "32",
         "--classes", "10"]


def losses(text):
    return [float(line.split("loss ")[1].split()[0])
            for line in text.splitlines() if line.startswith("step ")]


def finish(proc, what):
    out, err = proc.communicate(timeout=SPAWN_DEADLINE_S)
    assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n{err}"
    return out


@pytest.fixture(scope="module")
def dist_imagenet_runs(tmp_path_factory, failing_run):
    """(the port's stdout, the reference's) of the 2-rank runs."""
    tmp = tmp_path_factory.mktemp("virtual")
    states = tmp / "init.zip"
    # the port's states after compile on the global batch of 4, at world 1
    out = dist_imagenet.run(dist_imagenet.parser().parse_args(
        ["--device", "cpu", *SMALL[2:], "--steps", "0",
         "--batch-per-chip", "4"]))
    out["model"].save_states(str(states))
    distributed.shutdown()
    env = dict(os.environ, SINGA_TORCH_INIT_STATES=str(states))
    ref = subprocess.Popen(
        [sys.executable, "tests/helper_torch_virtual.py",
         "examples/dist_imagenet.py", "--virtual-devices", "2", *SMALL],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    port = subprocess.Popen(
        [sys.executable, "-m", "singa_tpu_torch.examples.dist_imagenet",
         "--virtual-devices", "2", "--device", "cpu", *SMALL],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return finish(port, "the port"), finish(ref, "the reference")


#: what the failing parent may take past `virtual.GRACE_S`, from the
#: rank's failure to its own exit: the failed rank's interpreter ending,
#: the parent's 50 ms poll, the kill and wait of the peer and the
#: parent's exit, under a loaded machine
EXIT_MARGIN_S = 10.0


@pytest.fixture(scope="module")
def failing_run():
    """Two virtual-device ranks of which rank 1 raises
    (`tests/helper_torch_virtual.py --fail-rank 1`), started before the
    parity runs so that it runs beside them: {"rc", "err", "exited_at"},
    filled by a thread that waits on the parent and stamps its exit on
    `time.monotonic()` ("exited_at" None if it outlived the deadline)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.helper_torch_virtual", "--fail-rank",
         "1"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    got = {"rc": None, "err": "", "exited_at": None}

    def wait():
        try:
            _, got["err"] = proc.communicate(timeout=SPAWN_DEADLINE_S)
        except subprocess.TimeoutExpired:
            return
        got["exited_at"] = time.monotonic()
        got["rc"] = proc.returncode

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    yield got, waiter
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)  # the parent and its ranks
    waiter.join()


def test_dist_imagenet_over_two_virtual_devices_equals_the_reference(
        dist_imagenet_runs):
    port, ref = dist_imagenet_runs
    assert "mesh: 2 chips / 2 processes (gloo), global batch 4" in port
    assert "mesh: 2 chips / 1 hosts, global batch 4" in ref
    # rank 0 alone writes to stdout
    assert port.count("model gradient payload") == 1
    got, want = losses(port), losses(ref)
    assert len(got) == len(want) == 2, (port, ref)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_a_failing_rank_fails_the_parent(failing_run):
    got, waiter = failing_run
    waiter.join(SPAWN_DEADLINE_S + 10)
    err = got["err"]
    assert got["exited_at"] is not None, (
        f"the parent outlived {SPAWN_DEADLINE_S} s: its waiting peer was "
        f"not killed after the grace")
    assert got["rc"] == 1, err
    m = re.search(r"rank 1 fails on purpose at (\d+\.\d+)", err)
    assert m, err
    # the waiting peer was killed after the grace, not at its timeout
    lived = got["exited_at"] - float(m.group(1))
    assert virtual.GRACE_S <= lived < virtual.GRACE_S + EXIT_MARGIN_S, (
        f"the parent exited {lived:.2f} s after the rank failed, not "
        f"within [{virtual.GRACE_S}, {virtual.GRACE_S + EXIT_MARGIN_S}) s")


def test_refusals_and_no_ops(monkeypatch):
    p = dist_imagenet.parser()
    args = p.parse_args(["--virtual-devices", "2", "--device", "cuda"])
    with pytest.raises(ValueError, match="cannot run on --device cuda"):
        virtual.ensure_from_args(args, "x")
    with pytest.raises(ValueError, match=">= 0"):
        virtual.ensure(-1, "x")
    monkeypatch.delenv("SINGA_TORCH_VIRTUAL_RANK", raising=False)
    args = p.parse_args([])
    assert virtual.ensure_from_args(args, "x") is None
    assert args.device is None and virtual.child_rank() is None
    assert not distributed.is_initialized()
