"""The fleet survives its leader's loss and shrinks the process group: the
counterpart of tests/test_resilience_fleet.py's leader-loss oracle,
through the agent's CLI (``python -m singa_tpu_torch.resilience.babysit
--fleet ...``).

Two agent processes run `tests/helper_torch_fleet.py`'s trainer, whose
two ranks form one gloo group. Once the group has committed a
checkpoint, the leader's agent and its trainer tree are SIGKILLed
(`helper_torch_fleet.drive_leader_loss`). The follower sees the lease
stop changing and takes it over (election 2, "leader failover"), sees
the dead host's agent heartbeat go stale, and past the grace window
drops it from the roster. The survivor respawns at world 1: its trainer
forms a world-1 group, the supervisor's probe folds dp 2 -> 1
("mesh=(1, 1, 1)"), the elastic restore re-places the world-2
checkpoint, and the job commits step N, with ``fleet=1`` and
``elections=2`` in the trainer's counters. This is the
`Supervisor(mesh_fn=)` shrink across the fleet's epochs, which the
supervisor refuses inside one process.
"""

import json
import os

from tests.helper_torch_fleet import TRAINER_STALE_S, drive_leader_loss

N_STEPS = 6
AGENT_FLAGS = ["--stale-after", str(TRAINER_STALE_S), "--poll", "0.25",
               "--host-stale-after", "3", "--host-grace", "2",
               "--lease-ttl", "2", "--max-restarts", "5", "--backoff",
               "0.5"]


def test_leader_loss_failover_roster_shrink_elastic_resume(tmp_path):
    rdv, ckpt = str(tmp_path / "rdv"), str(tmp_path / "ckpt")
    survivor, out = drive_leader_loss(rdv, ckpt, N_STEPS, AGENT_FLAGS,
                                      timeout_s=100)
    with open(os.path.join(rdv, "EPOCH")) as f:
        epoch = json.load(f)
    assert epoch["roster"] == [f"host{survivor}"], epoch
    assert int(epoch["elections"]) >= 2, epoch
    assert "leader failover" in out, out
    assert os.path.exists(os.path.join(rdv, "DONE"))
    done = [ln for ln in out.splitlines()
            if ln.startswith("fleet trainer done")]
    assert len(done) == 1, out
    assert "world=1 mesh=(1, 1, 1)" in done[0], done
    assert f"steps={N_STEPS}" in done[0], done
    assert "fleet=1" in done[0] and "elections=2" in done[0], done
    from singa_tpu_torch import resilience

    manifest, _ = resilience.read_manifest(ckpt)
    assert int(manifest["step"]) == N_STEPS, manifest["step"]
