"""One fleet of a reference agent and a port agent: the parity oracle of
a protocol module.

The rendezvous layout and its JSON records are the protocol, so the two
implementations must interoperate on one directory. A reference agent
(``python -m singa_tpu.resilience.babysit --fleet``, in its own process)
and a port agent (``python -m singa_tpu_torch.resilience.babysit
--fleet``) run trainers that import nothing; host1's trainer exits rc 3
on epoch 0. The job heals with one epoch bump and completes with DONE.
Each side leads once: the agent started first holds the lease before the
other starts. The ``EPOCH``, ``LEASE`` and ``hosts/*.json`` records
either side writes carry the same keys.
"""

import os
import subprocess
import sys
import time

import pytest

from tests.helper_torch_fleet import REPO, beat_cmd, child_env, read_json

FLAGS = ["--stale-after", "60", "--poll", "0.1", "--host-stale-after", "30",
         "--host-grace", "600", "--lease-ttl", "5", "--max-restarts", "3",
         "--backoff", "0"]
MODULES = {"reference": "singa_tpu.resilience.babysit",
           "port": "singa_tpu_torch.resilience.babysit"}


def _env():
    """`child_env` with JAX pinned to the CPU for the reference's agent."""
    env = {k: v for k, v in child_env().items()
           if not k.startswith(("JAX_", "XLA_", "PJRT_"))}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def run_mixed(rdv, first, second):
    """Start `first`'s agent as host0, wait for it to hold the lease, then
    `second`'s as host1; record every distinct EPOCH and LEASE record and
    each host's last record while they run. Returns the outputs and the
    records."""
    body = "sys.exit(3 if epoch == 0 and rank == 1 else 0)\n"
    procs, seen = [], {"EPOCH": {}, "LEASE": {}}

    def start(side, rank):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", MODULES[side], "--fleet", rdv,
             "--fleet-rank", str(rank), "--fleet-world", "2", *FLAGS, "--",
             *beat_cmd(body)],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def record():
        for name in seen:
            rec = read_json(os.path.join(rdv, name))
            if rec is not None:
                seen[name][rec["nonce"]] = rec

    try:
        start(first, 0)
        deadline = time.monotonic() + 60
        while read_json(os.path.join(rdv, "LEASE")) is None:
            assert time.monotonic() < deadline, "host0 never took the lease"
            assert procs[0].poll() is None, procs[0].communicate()[0]
            time.sleep(0.05)
        start(second, 1)
        deadline = time.monotonic() + 90
        while any(p.poll() is None for p in procs):
            record()
            assert time.monotonic() < deadline, "the mixed fleet overran"
            time.sleep(0.05)
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    hosts = {h: read_json(os.path.join(rdv, "hosts", f"{h}.json"))
             for h in ("host0", "host1")}
    return outs, seen, hosts


@pytest.mark.parametrize("first", ["reference", "port"])
def test_mixed_fleet_heals_and_shares_the_records(tmp_path, first):
    second = "port" if first == "reference" else "reference"
    rdv = str(tmp_path / "rdv")
    outs, seen, hosts = run_mixed(rdv, first, second)
    assert all("job completed" in o for o in outs), outs
    assert "acquired the restart lease (election #1)" in outs[0], outs[0]
    epoch = read_json(os.path.join(rdv, "EPOCH"))
    assert epoch["epoch"] == 1 and "rc=3" in epoch["reason"], epoch
    assert epoch["roster"] == ["host0", "host1"], epoch
    done = read_json(os.path.join(rdv, "DONE"))
    assert done is not None and done["epoch"] == 1, done
    # host0's side led: its LEASE and its bump; the launch EPOCH record
    # is host0's too (host1 started after it)
    (lease,) = seen["LEASE"].values()
    assert lease["holder"] == "host0", lease
    assert set(lease) == {"holder", "nonce", "ttl_s", "elections", "time"}
    launch, bump = sorted(seen["EPOCH"].values(), key=lambda r: r["epoch"])
    assert set(launch) == {"epoch", "roster", "elections", "nonce",
                           "reason", "time"}, launch
    assert set(bump) == {"epoch", "roster", "elections", "nonce",
                         "readmits", "reason", "time"}, bump
    assert set(hosts["host0"]) == set(hosts["host1"]) == {
        "host", "status", "epoch", "rc", "pid", "trainer_pid", "hb_age_s",
        "time"}, hosts
    assert hosts["host0"]["status"] == hosts["host1"]["status"] == "done"
