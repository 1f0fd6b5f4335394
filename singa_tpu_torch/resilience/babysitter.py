"""Out-of-process babysitter: the healer for hangs no in-process
mechanism can unwind (counterpart of singa_tpu/resilience/babysitter.py).

The watchdog turns a stalled step into a `StepHangError` only when the
main thread reaches a bytecode boundary. A hard hang freezes the
interpreter itself: a wait inside one CUDA or NCCL call (a graph replay,
a `.item()` or a synchronize behind a stuck kernel, a collective whose
peer is gone), a process frozen by SIGSTOP. `interrupt_main` never
lands, and `on_hang` can only alert. Healing that class takes a second
process, this one:

- `Babysitter(cmd, ...)` spawns the trainer command in a session of its
  own (its own process group), exports the heartbeat contract
  (``SINGA_HEARTBEAT_FILE``: the trainer's `Watchdog` touches the file
  at construction and on every arm and disarm, so per step) and watches
  the child's exit status and the heartbeat's mtime. The heartbeat is
  primed at every spawn, so the staleness clock starts at launch.
- A heartbeat older than `stale_after_s` means the trainer is wedged
  past self-help: the whole process group is SIGKILLed (`killpg`;
  SIGKILL is uncatchable and acts on a stopped process too) and reaped
  (`wait()`), and the trainer is respawned.
- A nonzero exit respawns too; exit 0 means the run completed.
- Respawns are paced by the shared bounded exponential backoff
  (`retry.exp_backoff_s`) and bounded by `max_restarts`, with a history
  of what the budget went on.

The trainer resumes from its latest committed checkpoint on respawn
(`resilience.restore`), so a healed run's final state is bitwise the
uninterrupted run's (tests/test_torch_babysitter.py holds the final
checkpoints sha256-identical). The babysitter holds no model state and
never initialises CUDA (`torch.cuda.is_initialized()` stays False): a
watcher that holds a context on the card it polices would be the wrong
way round, and it must stay alive exactly when the trainer is beyond
saving.

Every (re)spawn carries ``SINGA_BABYSIT=1`` and
``SINGA_BABYSIT_RESTARTS=<n>``; the trainer's `counters` absorb them at
import, so `Model.fault_counters` shows the external heals (`babysit`,
`restarts_external`) next to the in-process ones. Spans:
``babysitter.spawn``, ``babysitter.stale_kill``; event
``babysitter.respawn``; counters ``stale_kills``,
``restarts_external``.

CLI (`singa_tpu_torch/resilience/babysit.py`)::

    python -m singa_tpu_torch.resilience.babysit \
        --stale-after 300 --max-restarts 3 -- \
        python train.py --checkpoint /ckpt ...

Jurisdictions: the sentinel, one bad gradient step (skipped on the
device); the watchdog, a stall that still yields to the interpreter;
the supervisor, crashes, hangs and spikes a rebuild in the process can
heal; the babysitter, everything that kills or freezes the interpreter,
a sticky CUDA error among them. None of them unwinds a wait inside one
CUDA call: the babysitter kills the process instead. A job of many
processes runs one agent per host instead (``--fleet``,
`resilience.fleet.FleetAgent`): the lease-elected leader turns a lost
host or a dead trainer into a job-level epoch bump.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import counters, retry
from singa_tpu_torch.resilience.watchdog import HEARTBEAT_ENV

__all__ = ["Babysitter", "main"]


class Babysitter:
    """Spawn-and-watch loop (module docstring)::

        result = Babysitter([sys.executable, "train.py", ...],
                            stale_after_s=300.0).run()

    `result` is {"exit_code", "restarts", "stale_kills", "healed",
    "history"}: `healed` is True when the trainer finally exited 0,
    `restarts` counts respawns (each also bumps the process-wide
    ``restarts_external`` counter and rides the child's env),
    `stale_kills` the subset forced by a dead heartbeat. `exit_code`
    is the last child exit in `Popen.returncode` convention (0 on
    success, a positive code from the trainer, ``-signal.SIGKILL``
    after a stale kill that exhausted the budget). `history` records
    one entry per absorbed incarnation ({incarnation, rc, stale_kill,
    backoff_s, action}), so a budget exhaustion reports WHAT it burned
    the budget on."""

    def __init__(self, cmd: List[str], *,
                 heartbeat_path: Optional[str] = None,
                 stale_after_s: float = 300.0,
                 poll_s: float = 0.5,
                 max_restarts: int = retry.RETRY_ATTEMPTS,
                 backoff_s: float = retry.RETRY_BACKOFF_S,
                 backoff_factor: float = 2.0,
                 backoff_cap_s: float = 120.0,
                 env: Optional[Dict[str, str]] = None,
                 metrics_port: Optional[int] = None,
                 sleep=time.sleep,
                 log=print):
        if not cmd:
            raise ValueError("Babysitter needs a non-empty trainer cmd")
        self.cmd = list(cmd)
        #: when the caller names no heartbeat, the babysitter owns a
        #: fresh tempdir for it and removes it when run() returns
        self._own_heartbeat_dir = None
        if heartbeat_path is None:
            self._own_heartbeat_dir = tempfile.mkdtemp(
                prefix="singa_babysit_")
            heartbeat_path = os.path.join(self._own_heartbeat_dir,
                                          "heartbeat")
        self.heartbeat_path = heartbeat_path
        if stale_after_s <= 0:
            raise ValueError(
                f"stale_after_s={stale_after_s!r} must be positive")
        self.stale_after_s = float(stale_after_s)
        self.poll_s = float(poll_s)
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap_s = float(backoff_cap_s)
        self.env = env
        #: opt-in metrics endpoint: when set, run() mounts
        #: export.MetricsServer, whose /healthz judges this trainer's
        #: heartbeat (the babysitter outlives every incarnation). None
        #: serves nothing.
        self.metrics_port = metrics_port
        #: injectable seam for the RESPAWN BACKOFF only (tests must not
        #: really back off); the _watch poll keeps the real time.sleep
        #: — replacing it with a no-op would busy-spin the monitor
        self._sleep = sleep
        self._log = log
        self.restarts = 0
        self.stale_kills = 0
        #: one record per absorbed incarnation: what a budget
        #: exhaustion burned the budget on
        self.history: List[Dict[str, object]] = []

    # -- one incarnation -----------------------------------------------------
    def _touch_heartbeat(self) -> None:
        """The babysitter primes the heartbeat at every spawn, so the
        staleness clock starts at launch: a trainer that wedges BEFORE
        its first Watchdog beat (a hung import, a deadlocked backend
        init) is still caught after stale_after_s."""
        with open(self.heartbeat_path, "ab"):
            pass
        os.utime(self.heartbeat_path, None)

    def _child_env(self) -> Dict[str, str]:
        """The (re)spawn environment (the seam a fleet agent overrides
        with its own variables)."""
        env = dict(os.environ if self.env is None else self.env)
        env[HEARTBEAT_ENV] = self.heartbeat_path
        env[counters.BABYSIT_ENV] = "1"
        env[counters.RESTARTS_ENV] = str(self.restarts)
        # SINGA_TRACE_FILE rides the env copy, so a traced child writes
        # its own JSONL file beside this one; the current span id makes
        # the child's root spans nest under this (re)spawn
        sid = trace.current_span_id()
        if sid:
            env[trace.PARENT_ENV] = sid
        return env

    def _spawn(self) -> subprocess.Popen:
        with trace.span("babysitter.spawn",
                        incarnation=self.restarts):
            env = self._child_env()
            self._touch_heartbeat()
            # start_new_session: the child leads its own process
            # group, so a stale kill reaps the WHOLE tree (data-loader
            # workers, compile helpers), not just the immediate child
            return subprocess.Popen(self.cmd, env=env,
                                    start_new_session=True)

    def _heartbeat_age_s(self) -> float:
        try:
            return time.time() - os.stat(self.heartbeat_path).st_mtime
        except OSError:
            return float("inf")

    def _kill_tree(self, proc: subprocess.Popen) -> None:
        """SIGKILL the child's process group: uncatchable, unwinds
        nothing, works on SIGSTOPped processes — the only signal with
        jurisdiction over a hard hang."""
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                proc.kill()
            except ProcessLookupError:
                pass
        proc.wait()

    def _watch(self, proc: subprocess.Popen) -> int:
        """Block until the child exits or its heartbeat goes stale;
        returns the exit code (stale -> kill tree -> -SIGKILL)."""
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            age = self._heartbeat_age_s()
            if age > self.stale_after_s:
                self._log(
                    f"# babysitter: heartbeat "
                    f"{os.path.basename(self.heartbeat_path)} is "
                    f"{age:.1f}s stale (deadline "
                    f"{self.stale_after_s:.1f}s) — hard hang; "
                    f"SIGKILLing the process tree (pid {proc.pid})")
                self.stale_kills += 1
                counters.bump("stale_kills")
                with trace.span("babysitter.stale_kill",
                                heartbeat_age_s=round(age, 1),
                                deadline_s=self.stale_after_s,
                                pid=proc.pid):
                    self._kill_tree(proc)
                return -signal.SIGKILL
            time.sleep(self.poll_s)

    # -- the outer loop ------------------------------------------------------
    def run(self) -> Dict[str, object]:
        srv = None
        try:
            # the endpoint mounts inside the try so a bind failure
            # (port taken) still runs the finally that removes the
            # babysitter-owned heartbeat tempdir
            if self.metrics_port is not None:
                from singa_tpu_torch.observability import export

                srv = export.MetricsServer(
                    healthz=export.heartbeat_healthz(
                        self.heartbeat_path, self.stale_after_s),
                    port=self.metrics_port)
                self._log(f"# babysitter: metrics endpoint on "
                          f"127.0.0.1:{srv.start()} (/metrics, /healthz "
                          f"judges the trainer heartbeat)")
            return self._run()
        finally:
            if srv is not None:
                srv.stop()
            if self._own_heartbeat_dir is not None:
                import shutil

                shutil.rmtree(self._own_heartbeat_dir,
                              ignore_errors=True)

    def _run(self) -> Dict[str, object]:
        while True:
            proc = self._spawn()
            stale_before = self.stale_kills
            rc = self._watch(proc)
            if rc == 0:
                return {"exit_code": 0, "restarts": self.restarts,
                        "stale_kills": self.stale_kills,
                        "healed": True,
                        "history": list(self.history)}
            if self.restarts >= self.max_restarts:
                self.history.append(
                    {"incarnation": self.restarts, "rc": rc,
                     "stale_kill": self.stale_kills > stale_before,
                     "action": "budget exhausted"})
                self._log(
                    f"# babysitter: trainer failed (rc={rc}) with the "
                    f"restart budget exhausted "
                    f"({self.restarts}/{self.max_restarts}) — giving "
                    f"up; the latest committed checkpoint is the "
                    f"resume point (history: {self.history})")
                return {"exit_code": rc, "restarts": self.restarts,
                        "stale_kills": self.stale_kills,
                        "healed": False,
                        "history": list(self.history)}
            delay = retry.exp_backoff_s(
                self.restarts, self.backoff_s, self.backoff_factor,
                self.backoff_cap_s)
            self.history.append(
                {"incarnation": self.restarts, "rc": rc,
                 "stale_kill": self.stale_kills > stale_before,
                 "backoff_s": delay, "action": "respawn"})
            trace.event("babysitter.respawn", rc=rc,
                        stale_kill=self.stale_kills > stale_before,
                        backoff_s=delay, incarnation=self.restarts)
            self.restarts += 1
            counters.bump("restarts_external")
            self._log(
                f"# babysitter: trainer rc={rc} — respawn "
                f"{self.restarts}/{self.max_restarts} in {delay:.1f}s "
                f"(the trainer resumes from its latest committed "
                f"checkpoint)")
            self._sleep(delay)


def main(argv: Optional[List[str]] = None) -> int:
    """`python -m singa_tpu_torch.resilience.babysit [opts] -- <trainer
    cmd>`; returns the exit code for sys.exit (0 only when the trainer
    completed). With ``--fleet <rendezvous_dir> --fleet-rank I
    --fleet-world N`` the process runs one host's agent of a fleet
    instead (`resilience.fleet.FleetAgent`): host heartbeats into the
    shared rendezvous, a lease-elected leader, epoch-bump job
    restarts."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.resilience.babysit",
        description="Spawn a trainer subprocess, watch its heartbeat "
                    "file, SIGKILL+respawn it on hard hangs or "
                    "crashes (singa_tpu_torch/resilience/babysitter.py); "
                    "with --fleet, run as one host's agent of a "
                    "babysitter fleet (singa_tpu_torch/resilience/"
                    "fleet.py).")
    parser.add_argument("--stale-after", type=float, default=300.0,
                        metavar="S",
                        help="heartbeat staleness deadline in seconds "
                             "(cover the worst build and capture, "
                             "default 300)")
    parser.add_argument("--poll", type=float, default=0.5, metavar="S",
                        help="heartbeat poll interval (default 0.5)")
    parser.add_argument("--max-restarts", type=int,
                        default=retry.RETRY_ATTEMPTS, metavar="N",
                        help="respawn budget before giving up; in "
                             "fleet mode, the job-level EPOCH budget "
                             f"(default {retry.RETRY_ATTEMPTS})")
    parser.add_argument("--backoff", type=float,
                        default=retry.RETRY_BACKOFF_S, metavar="S",
                        help="respawn backoff base (exponential, "
                             "shared retry policy)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        metavar="PORT",
                        help="mount the observability endpoint on "
                             "127.0.0.1:PORT (0 = any free port): "
                             "/metrics serves the process registry, "
                             "/healthz judges the trainer heartbeat "
                             "by the fleet freshness rule (plain "
                             "babysit mode)")
    parser.add_argument("--heartbeat", default=None, metavar="PATH",
                        help="heartbeat file (default: a fresh "
                             "tempdir; exported to the trainer as "
                             f"${HEARTBEAT_ENV})")
    fleet = parser.add_argument_group(
        "fleet mode (one agent per host; see resilience/fleet.py)")
    fleet.add_argument("--fleet", default=None, metavar="DIR",
                       help="shared rendezvous directory — presence "
                            "selects fleet mode")
    fleet.add_argument("--fleet-rank", type=int, default=0,
                       metavar="I", help="this host's launch rank")
    fleet.add_argument("--fleet-world", type=int, default=1,
                       metavar="N", help="launch host count")
    fleet.add_argument("--roster", default=None, metavar="IDS",
                       help="comma-separated host ids of the launch "
                            "roster, identical on every agent "
                            "(default host0..host<N-1> from "
                            "--fleet-world)")
    fleet.add_argument("--host-id", default=None, metavar="ID",
                       help="this host's id — must name a --roster "
                            "entry (default: the roster entry at "
                            "--fleet-rank)")
    fleet.add_argument("--host-stale-after", type=float, default=15.0,
                       metavar="S",
                       help="window after which a host whose AGENT "
                            "heartbeat stopped changing counts as "
                            "lost (default 15)")
    fleet.add_argument("--host-grace", type=float, default=30.0,
                       metavar="S",
                       help="window after which a continuously-"
                            "problematic host is dropped from the "
                            "roster (default 30)")
    fleet.add_argument("--lease-ttl", type=float, default=10.0,
                       metavar="S",
                       help="leader lease ttl; failover latency on "
                            "leader loss (default 10)")
    fleet.add_argument("--no-rejoin", action="store_true",
                       help="a returned host (agent launched outside "
                            "the current roster) exits instead of "
                            "requesting re-admission (default: "
                            "request it)")
    fleet.add_argument("--max-readmits", type=int, default=3,
                       metavar="N",
                       help="per-host re-admission budget: past it "
                            "the leader denies the join request, so "
                            "a reboot-looping machine cannot "
                            "evict/rejoin forever (default 3)")
    fleet.add_argument("--coord-host", default=None,
                       metavar="HOST",
                       help="address this host advertises when it is "
                            "rank 0 of an epoch — the brokered "
                            "coordinator exchange exports "
                            "SINGA_COORDINATOR=<host:port> to every "
                            "trainer (default: this machine's "
                            "hostname; never loopback, which remote "
                            "trainers would resolve to themselves)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- <trainer command>")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no trainer command (pass it after `--`)")
    if args.fleet is not None:
        from singa_tpu_torch.resilience.fleet import FleetAgent

        result = FleetAgent(
            cmd, args.fleet, rank=args.fleet_rank,
            world=args.fleet_world, host_id=args.host_id,
            roster=(args.roster.split(",") if args.roster else None),
            heartbeat_path=args.heartbeat,
            trainer_stale_after_s=args.stale_after,
            host_stale_after_s=args.host_stale_after,
            host_grace_s=args.host_grace,
            lease_ttl_s=args.lease_ttl, poll_s=args.poll,
            max_epochs=args.max_restarts,
            rejoin=not args.no_rejoin,
            max_readmits=args.max_readmits,
            coord_host=args.coord_host,
            backoff_s=args.backoff).run()
        if result["healed"]:
            print(f"# fleet agent: job completed (epochs="
                  f"{result['epochs']}, elections won="
                  f"{result['elections']}, led={result['led']})",
                  flush=True)
            return 0
        return 1
    result = Babysitter(cmd, heartbeat_path=args.heartbeat,
                        stale_after_s=args.stale_after,
                        poll_s=args.poll,
                        max_restarts=args.max_restarts,
                        backoff_s=args.backoff,
                        metrics_port=args.metrics_port).run()
    if result["healed"]:
        print(f"# babysitter: trainer completed "
              f"(restarts={result['restarts']}, "
              f"stale_kills={result['stale_kills']})", flush=True)
        return 0
    rc = int(result["exit_code"])  # type: ignore[arg-type]
    return rc if 0 < rc < 128 else 1
