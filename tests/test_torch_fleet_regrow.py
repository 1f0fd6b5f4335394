"""The fleet re-grows a shrunken process group: the counterpart of
tests/test_resilience_regrow.py's oracle, through the agent's CLI.

Two agent processes run `tests/helper_torch_fleet.py`'s trainer at
quorum 2 (``--min-world 2``), its two ranks in one gloo group. Once the
group has committed a checkpoint, host1's agent and trainer tree are
SIGKILLed (`helper_torch_fleet.drive_regrow`): the fleet heals at world 1,
where the quorum gate keeps the survivor's trainer heartbeating without
training (it has not imported torch). A fresh agent for host1 returns,
publishes a join request, and the leader re-admits it at epoch N: the
world grows back to 2, the two trainers form a new group at a
re-brokered coordinator, resume from the latest committed checkpoint,
and the final checkpoint is sha256-identical, file by file, to the one
an unbroken world-2 group writes (every trained step ran at world 2; the
manifest and the shard files are compared, the commit protocol's
per-attempt files carry a random nonce). The port's oracle is held to
the port's own unbroken group.
"""

import json
import os
import socket
from concurrent.futures import ThreadPoolExecutor

from tests.helper_torch_fleet import (TRAINER_STALE_S, drive_regrow,
                                      payload_digest, run_unbroken)

N_STEPS = 8
#: the respawn backoff stays under the host-staleness window at every
#: epoch the run reaches (3.2 s at epoch 6): a re-admitted host
#: waits that window for roster[0]'s coordinator advertisement, which
#: roster[0]'s agent publishes only after its own backoff
AGENT_FLAGS = ["--stale-after", str(TRAINER_STALE_S), "--poll", "0.25",
               "--host-stale-after", "4", "--host-grace", "1",
               "--lease-ttl", "3", "--max-restarts", "10", "--backoff",
               "0.1"]


def test_regrow_process_group_sha_identical(tmp_path):
    rdv, ckpt = str(tmp_path / "rdv"), str(tmp_path / "healed")
    with ThreadPoolExecutor(1) as ex:
        ref = ex.submit(run_unbroken, str(tmp_path / "ref"), N_STEPS, 2,
                        str(tmp_path))
        out0, out1 = drive_regrow(rdv, ckpt, N_STEPS, AGENT_FLAGS,
                                  timeout_s=100)
        ref.result()
    with open(os.path.join(rdv, "EPOCH")) as f:
        rec = json.load(f)
    assert rec["roster"] == ["host0", "host1"], rec
    assert "re-admit host1" in rec["reason"], rec
    assert os.path.exists(os.path.join(rdv, "DONE"))
    assert "below quorum" in out0, out0
    assert "requesting re-admission" in out1, out1
    assert f"re-admitted at epoch {rec['epoch']}" in out1, out1
    done = [ln for ln in (out0 + out1).splitlines()
            if ln.startswith("fleet trainer done")]
    assert len(done) == 2 and all("world=2 mesh=(2, 1, 1)" in ln
                                  for ln in done), done
    # the grown epoch's coordinator, brokered afresh by roster[0]
    with open(os.path.join(rdv, "coord",
                           f"epoch-{rec['epoch']:06d}.json")) as f:
        coord = json.load(f)["address"]
    assert coord.startswith(f"{socket.gethostname()}:"), coord
    assert all(ln.endswith(f"coord={coord}") for ln in done), (done, coord)
    with open(os.path.join(rdv, "coord", "epoch-000000.json")) as f:
        assert json.load(f)["address"] != coord
    ref_name, ref_sha = payload_digest(str(tmp_path / "ref"))
    got_name, got_sha = payload_digest(ckpt)
    assert got_name == ref_name == f"step-{N_STEPS:08d}"
    assert got_sha == ref_sha, (
        "the re-grown fleet's final checkpoint differs from the unbroken "
        "group's: the resume through the shrink and the re-grow was not "
        "bitwise")
