"""The fleet trainer on the port: the counterpart of `__graft_entry__.py`'s
``fleet-trainer`` entry (`_fleet_trainer_main`), with the same contract.

    python -m tests.helper_torch_fleet CKPT_DIR N_STEPS
        [--stale-at K --stale-rank R] [--min-world N] [--step-sleep S]
        [--quorum-wait S] [--device cpu]

It reads its topology from a fleet agent's env (``SINGA_FLEET_WORLD``,
``SINGA_FLEET_RANK``, the brokered ``SINGA_COORDINATOR``) and trains the
reference's tiny Net (Linear 16, ReLU, Linear 4; SGD 0.1 with momentum
0.9; x (8, 12) from ``default_rng(3)``) under `DistOpt` and
``Supervisor(mesh_fn=default_mesh_fn(2))``, a save after every step.
One difference from the reference is deliberate: its ranks are
independent replicas on virtual devices, each checkpointing beside the
others; here the ranks join one real process group of
``SINGA_FLEET_WORLD`` ranks at the brokered coordinator (gloo for
``--device cpu``, NCCL on the card) and write one collective checkpoint
through the two-phase commit. A respawn at a smaller world forms a
smaller group: the supervisor's probe folds dp onto it and the elastic
restore re-places the checkpoint.

``--stale-at K --stale-rank R`` SIGSTOPs rank R at step K on epoch 0
only (`faults.stale_host_at`; the env-seeded ``fleet_epochs`` counter
keeps it one-shot across respawns). ``--min-world N`` is the quorum
gate: below it the incarnation heartbeats without training, waiting for
the leader's re-admission bump; it decides before ``import torch``, so
it beats at once. It exits 1 when reparented (its agent died) and 75
after ``--quorum-wait`` seconds. ``--step-sleep S`` stretches each step
inside the watchdog's window, to hold a kill window open.
"""

import argparse
import os
import sys
import time

#: the fleet's topology env, as `singa_tpu_torch.resilience.fleet` names
#: it (the quorum gate reads it before anything heavy is imported)
WORLD_ENV = "SINGA_FLEET_WORLD"
RANK_ENV = "SINGA_FLEET_RANK"
COORD_ENV = "SINGA_COORDINATOR"
HEARTBEAT_ENV = "SINGA_HEARTBEAT_FILE"

#: the commit protocol's per-attempt files of a collective save: their
#: contents carry the attempt's random nonce, the checkpoint's payload
#: is the manifest and the shard files
PROTOCOL_PREFIXES = ("SAVE-NONCE", "SHARDS-p", "COMMIT-p", "ACK-p")


def _beat() -> None:
    hb = os.environ.get(HEARTBEAT_ENV)
    if hb:
        with open(hb, "ab"):
            pass
        os.utime(hb, None)


def quorum_gate(world: int, rank: int, min_world: int,
                quorum_wait: float) -> None:
    """Below quorum: stay live (the agent judges the heartbeat) but train
    nothing; the next epoch bump SIGKILLs this incarnation."""
    agent_pid = os.getppid()
    print(f"fleet trainer below quorum rank={rank} world={world} "
          f"min_world={min_world} — heartbeating, not training "
          f"(up to {quorum_wait:.0f}s)", flush=True)
    t0 = time.monotonic()
    while True:
        if os.getppid() != agent_pid:
            # reparented: nothing will ever SIGKILL this tree, so exit
            # instead of keeping an orphan's heartbeat alive
            print("fleet trainer below quorum: agent died — exiting",
                  flush=True)
            sys.exit(1)
        if time.monotonic() - t0 > quorum_wait:
            # the quorum never re-formed: exit non-zero, so the leader
            # turns this into bumps and, the conditions unchanged, FAILED
            print(f"fleet trainer below quorum for {quorum_wait:.0f}s "
                  f"— giving up rc=75", flush=True)
            sys.exit(75)
        _beat()
        time.sleep(0.2)


def payload_digest(directory: str):
    """(step dir name, {file: sha256}) of the latest committed step: the
    manifest and every shard file (a collective save's protocol files
    are left out: their contents carry the attempt's nonce)."""
    import hashlib

    from singa_tpu_torch import resilience

    step_dir = resilience.latest_step_dir(directory)
    out = {}
    for name in sorted(os.listdir(step_dir)):
        if name.startswith(PROTOCOL_PREFIXES):
            continue
        with open(os.path.join(step_dir, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return os.path.basename(step_dir), out


def train(ckpt_dir: str, n_steps: int, *, world: int, rank: int,
          stale_at, stale_rank: int, step_sleep, device) -> None:
    import numpy as np
    import torch

    from singa_tpu_torch import autograd, distributed, layer, model, opt
    from singa_tpu_torch.resilience import (Supervisor, counters,
                                            default_mesh_fn, faults)

    _beat()  # the imports are done: a progress beat
    # the manifest carries the generators' states, so two runs' final
    # checkpoints are comparable only from seeded generators
    torch.manual_seed(7)
    distributed.init(coordinator_address=os.environ.get(COORD_ENV),
                     num_processes=world, process_id=rank, device=device)
    _beat()  # the group formed
    dev = distributed.device()

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(7)
            self.fc1 = layer.Linear(16, in_features=12, device=dev,
                                    generator=gen)
            self.act = layer.ReLU()
            self.fc2 = layer.Linear(4, in_features=16, device=dev,
                                    generator=gen)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 4).astype(np.int64))
    x, y = x.to(dev), y.to(dev)

    def build(mesh):
        m = Net()
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9),
                                    mesh=mesh, axis_name="data"))
        m.compile([x], is_train=True, use_graph=True)
        return m

    hook = None
    if stale_at is not None and \
            counters.snapshot().get("fleet_epochs", 0) == 0:
        hook = faults.stale_host_at(int(stale_at), rank=int(stale_rank))
    if step_sleep:
        inner = hook

        def hook(step, batch, _inner=inner):  # noqa: F811 (chained)
            time.sleep(float(step_sleep))
            return _inner(step, batch) if _inner is not None else None
    sup = Supervisor(build, ckpt_dir, mesh_fn=default_mesh_fn(2),
                     step_timeout_s=3600.0, fault_hook=hook,
                     restart_backoff_s=0.0, sleep=lambda s: None)
    res = sup.run([(x, y)] * int(n_steps))
    distributed.shutdown()
    c = counters.supervisor_snapshot()
    print(f"fleet trainer done rank={rank} world={world} "
          f"mesh={res['mesh_extents']} steps={res['steps']} "
          f"fleet={c['fleet']} fleet_epochs={c['fleet_epochs']} "
          f"elections={c['elections']} "
          f"coord={os.environ.get(COORD_ENV, '-')}", flush=True)


# -- what the fleet tests share: agents, trainers, the choreographies --------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the agents' trainer staleness window in the real-process tests:
#: between two of the trainer's heartbeats lie the torch import and the
#: group's formation, which waits for the slower rank's import (up to
#: 7.3 s under the suite's load)
TRAINER_STALE_S = 15.0


def child_env():
    """The environment of the agents and their trainers: no fleet or
    babysitter variables inherited from the caller, the repository on
    the path."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SINGA_FLEET", "SINGA_BABYSIT",
                                "SINGA_COORDINATOR", "SINGA_HEARTBEAT"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def beat_cmd(body):
    """A tiny trainer that imports nothing: it heartbeats through the
    babysitter's contract, then runs `body` (which sees hb, epoch, rank,
    world)."""
    return [sys.executable, "-c", (
        "import os, sys, time\n"
        "hb = os.environ['SINGA_HEARTBEAT_FILE']\n"
        "epoch = int(os.environ.get('SINGA_FLEET_EPOCH', '0'))\n"
        "rank = int(os.environ.get('SINGA_FLEET_RANK', '0'))\n"
        "world = int(os.environ.get('SINGA_FLEET_WORLD', '0'))\n"
        "for _ in range(6):\n"
        "    open(hb, 'a').close(); os.utime(hb, None)\n"
        "    time.sleep(0.05)\n"
        + body)]


def run_agents(agents, timeout=120):
    """Run `agents` (FleetAgent) on threads of this process; their
    results."""
    import threading

    results = [None] * len(agents)

    def run(i):
        results[i] = agents[i].run()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(agents))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert all(not t.is_alive() for t in threads), \
        f"agent thread(s) still running after {timeout}s: {results}"
    return results


def trainer_cmd(ckpt_dir, n_steps, *extra):
    """This module's trainer on the CPU, as an agent spawns it."""
    return [sys.executable, "-m", "tests.helper_torch_fleet", ckpt_dir,
            str(n_steps), *extra, "--device", "cpu"]


def agent_cmd(rdv, rank, world, trainer, *flags):
    """``python -m singa_tpu_torch.resilience.babysit --fleet`` for host
    `rank` of `world` over `trainer`."""
    return [sys.executable, "-m", "singa_tpu_torch.resilience.babysit",
            "--fleet", rdv, "--fleet-rank", str(rank), "--fleet-world",
            str(world), *flags, "--", *trainer]


def read_json(path):
    """A rendezvous record, or None while it is absent or half-seen."""
    import json

    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def wait_until(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"{what} within {timeout_s:.0f} s")


def _kill_host(rdv, host):
    """SIGKILL host's agent and its trainer's process group (the trainer
    leads a session of its own): a lost machine."""
    import signal

    rec = read_json(os.path.join(rdv, "hosts", f"{host}.json"))
    assert rec is not None, f"{host}'s agent never published"
    os.kill(int(rec["pid"]), signal.SIGKILL)
    if rec.get("trainer_pid"):
        try:
            os.killpg(int(rec["trainer_pid"]), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _popen(cmd, env=None):
    import subprocess

    return subprocess.Popen(cmd, env=child_env() if env is None else env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _reap(procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def run_unbroken(ckpt, n_steps, world, heartbeat_dir, timeout_s=120):
    """The unbroken twin: `world` trainers of this module in one group at
    a fresh coordinator port, with the fleet's topology env and no agent.
    Returns their outputs."""
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        coord = f"{socket.gethostname()}:{s.getsockname()[1]}"
    procs = []
    try:
        for r in range(world):
            env = dict(child_env(), **{
                WORLD_ENV: str(world), RANK_ENV: str(r), COORD_ENV: coord,
                HEARTBEAT_ENV: os.path.join(heartbeat_dir, f"hb{r}")})
            procs.append(_popen(trainer_cmd(ckpt, n_steps), env))
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
        return outs
    finally:
        _reap(procs)


def drive_leader_loss(rdv, ckpt, n_steps, agent_flags, timeout_s):
    """The leader-loss choreography (the counterpart of
    `drive_fleet_leader_loss`): two agent processes through the CLI over
    this module's trainer; once the world-2 group has committed a
    checkpoint, SIGKILL the leader's agent and its trainer tree, then
    drain the survivor. Returns (survivor index, its output)."""
    trainer = trainer_cmd(ckpt, n_steps, "--step-sleep", "0.5")
    procs = [_popen(agent_cmd(rdv, i, 2, trainer, *agent_flags))
             for i in range(2)]
    try:
        wait_until(lambda: os.path.exists(os.path.join(ckpt, "LATEST")), 90,
                   "the world-2 group committed no checkpoint")
        leader = read_json(os.path.join(rdv, "LEASE"))["holder"]
        _kill_host(rdv, leader)
        survivor = 1 - int(leader.removeprefix("host"))
        out, _ = procs[survivor].communicate(timeout=timeout_s)
        assert procs[1 - survivor].wait(timeout=30) != 0  # SIGKILLed
        assert procs[survivor].returncode == 0, out
        return survivor, out
    finally:
        _reap(procs)


def drive_regrow(rdv, ckpt, n_steps, agent_flags, timeout_s):
    """The re-grow choreography (the counterpart of
    `drive_fleet_regrow`): two agent processes through the CLI over this
    module's trainer at quorum 2; once the group has committed a
    checkpoint, SIGKILL host1's agent and trainer tree; wait until the
    leader has evicted it and host0 runs at world 1 (its trainer held by
    the quorum gate); then start a fresh agent for host1, which the
    leader re-admits at the grown world. Returns (host0's output, the
    returned host1's output)."""
    trainer = trainer_cmd(ckpt, n_steps, "--min-world", "2",
                          "--step-sleep", "0.5")
    procs = [_popen(agent_cmd(rdv, i, 2, trainer, *agent_flags))
             for i in range(2)]
    try:
        wait_until(lambda: os.path.exists(os.path.join(ckpt, "LATEST")), 90,
                   "the world-2 group committed no checkpoint")
        _kill_host(rdv, "host1")
        assert procs[1].wait(timeout=30) != 0  # SIGKILLed

        def healed_at_world_1():
            rec = read_json(os.path.join(rdv, "EPOCH"))
            h0 = read_json(os.path.join(rdv, "hosts", "host0.json"))
            return (rec is not None and rec["roster"] == ["host0"]
                    and h0 is not None and h0["epoch"] == rec["epoch"]
                    and h0["status"] == "running")

        wait_until(healed_at_world_1, 60, "the fleet never ran at world 1")
        procs.append(_popen(agent_cmd(rdv, 1, 2, trainer, *agent_flags)))
        out1, _ = procs[2].communicate(timeout=timeout_s)
        out0, _ = procs[0].communicate(timeout=30)
        assert procs[2].returncode == 0, out1
        assert procs[0].returncode == 0, out0
        return out0, out1
    finally:
        _reap(procs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tests.helper_torch_fleet")
    p.add_argument("ckpt_dir")
    p.add_argument("n_steps", type=int)
    p.add_argument("--stale-at", type=int, default=None)
    p.add_argument("--stale-rank", type=int, default=0)
    p.add_argument("--min-world", type=int, default=None)
    p.add_argument("--step-sleep", type=float, default=None)
    p.add_argument("--quorum-wait", type=float, default=600.0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    world = max(1, int(os.environ.get(WORLD_ENV, "1")))
    rank = int(os.environ.get(RANK_ENV, "0"))
    if args.min_world is not None and world < args.min_world:
        quorum_gate(world, rank, args.min_world, args.quorum_wait)
    train(args.ckpt_dir, args.n_steps, world=world, rank=rank,
          stale_at=args.stale_at, stale_rank=args.stale_rank,
          step_sleep=args.step_sleep, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
