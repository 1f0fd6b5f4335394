"""The fleet heals a lost host in a real process group: the counterpart of
tests/test_resilience_fleet.py's host-loss oracle.

Two agents (threads of this process) run `tests/helper_torch_fleet.py`'s
trainer, whose two ranks join one gloo group at the coordinator the
agents broker. Rank 0 SIGSTOPs itself at step 1 on epoch 0
(`faults.stale_host_at`): frozen, its peer blocked in the step's
all-reduce. Its agent reports the stale trainer heartbeat, the leader
bumps the epoch, every agent SIGKILLs its tree and respawns, the two new
ranks form a new world-2 group and resume from the latest committed
checkpoint. The final checkpoint is sha256-identical, file by file, to
the one an unbroken world-2 group of the same trainer writes (the
manifest and the shard files; the commit protocol's per-attempt files
carry a random nonce).

The trainer's staleness window is 15 s: between two of its heartbeats
lie the torch import and the group's formation, which waits for the
slower rank's import, up to 7.3 s under the suite's load.
"""

from concurrent.futures import ThreadPoolExecutor

from singa_tpu_torch.resilience import counters
from singa_tpu_torch.resilience.fleet import FleetAgent

from tests.helper_torch_fleet import (TRAINER_STALE_S, child_env,
                                      payload_digest, run_agents,
                                      run_unbroken, trainer_cmd)

N_STEPS = 4


def test_host_loss_epoch_respawn_sha_identical(tmp_path):
    counters.reset()
    healed = str(tmp_path / "healed")
    agents = [
        FleetAgent(trainer_cmd(healed, N_STEPS, "--stale-at", "1",
                               "--stale-rank", "0"),
                   str(tmp_path / "rdv"), rank=i, world=2,
                   trainer_stale_after_s=TRAINER_STALE_S,
                   host_stale_after_s=30.0,
                   host_grace_s=600.0,  # the host heals: never drop it
                   lease_ttl_s=3.0, poll_s=0.1, max_epochs=3,
                   backoff_s=0.0, env=child_env())
        for i in range(2)]
    with ThreadPoolExecutor(1) as ex:
        ref = ex.submit(run_unbroken, str(tmp_path / "ref"), N_STEPS, 2,
                        str(tmp_path))
        results = run_agents(agents, timeout=120)
        outs = ref.result()
    assert all("mesh=(2, 1, 1)" in o for o in outs), outs
    assert all(r["healed"] for r in results), results
    assert max(r["epochs"] for r in results) == 1, results
    assert sum(r["stale_kills"] for r in results) >= 1, results
    assert counters.snapshot().get("fleet_epochs") == 1
    ref_name, ref_sha = payload_digest(str(tmp_path / "ref"))
    got_name, got_sha = payload_digest(healed)
    assert got_name == ref_name == f"step-{N_STEPS:08d}"
    assert "MANIFEST.json" in got_sha and len(got_sha) > 1, got_sha
    assert got_sha == ref_sha, (
        "the healed fleet's final checkpoint differs from the unbroken "
        "group's: the resume after the epoch respawn was not bitwise")
