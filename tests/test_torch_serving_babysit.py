"""Babysitting a real serve process on the port: the counterpart of
tests/test_serving_babysit.py.

The serving `Frontend` touches the babysitter's heartbeat every
scheduler turn, so a hard-hung server (SIGSTOPped mid-stream; on the
card, a wedged device) is healed from outside as a hung trainer is:
stale heartbeat, SIGKILL of the process tree, respawn. Serving state
lives in the process, so the heal is re-admission: the respawned
incarnation serves every stream again, token-identical to `generate`
(`tests/helper_torch_babysat_server.py` asserts it before it writes its
done marker). The counters are the babysitter's: the child sees
``babysit`` and ``restarts_external`` through the env, the parent's
result carries the restart and the stale kill.

The stale window is 20 s: the heartbeat is primed at spawn and next
touched at the first scheduler turn, after the torch import and the
engine's build (7.3 s for a trainer's under the suite's load).
"""

import os
import subprocess
import sys

import pytest

from singa_tpu_torch.resilience import counters
from singa_tpu_torch.resilience.babysitter import Babysitter
from singa_tpu_torch.resilience.watchdog import HEARTBEAT_ENV

from tests.helper_torch_fleet import REPO, child_env


@pytest.fixture(autouse=True)
def _counters_isolation():
    counters.reset()
    yield
    counters.reset()


def server_cmd(done_path, hang=False):
    cmd = [sys.executable, "-m", "tests.helper_torch_babysat_server",
           done_path, "--device", "cpu"]
    return cmd + ["--hang"] if hang else cmd


def test_frontend_touches_heartbeat_under_babysit_env(tmp_path):
    """The liveness contract alone: a server run under the babysitter's
    env moves the heartbeat's mtime, the signal every heal rests on."""
    done, hb = str(tmp_path / "done"), str(tmp_path / "hb")
    with open(hb, "w"):
        pass
    os.utime(hb, (0, 0))  # stale since the epoch: only the server freshens
    env = child_env()
    env[HEARTBEAT_ENV] = hb
    proc = subprocess.run(server_cmd(done), env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert os.path.exists(done)
    assert os.stat(hb).st_mtime > 1.0, (
        "the serve loop never touched the heartbeat: a hung server would "
        "be invisible to the babysitter")


def test_sigstop_mid_stream_heals_and_reserves_streams(tmp_path):
    """The first incarnation SIGSTOPs from a token callback mid-stream;
    the babysitter stale-kills and respawns it; the second serves all
    three streams again, token-identical to `generate`."""
    done = str(tmp_path / "done")
    res = Babysitter(server_cmd(done, hang=True),
                     heartbeat_path=str(tmp_path / "hb"),
                     stale_after_s=20.0, poll_s=0.25, max_restarts=2,
                     backoff_s=0.0, env=child_env()).run()
    assert res["healed"], res
    assert res["restarts"] == 1 and res["stale_kills"] == 1, res
    with open(done) as f:
        marker = f.read()
    assert "served 3" in marker and "restarts_external=1" in marker, marker
    assert counters.snapshot().get("restarts_external", 0) == 1
    assert counters.snapshot().get("stale_kills", 0) == 1
