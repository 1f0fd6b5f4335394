"""The out-of-process babysitter on the port: the counterpart of
tests/test_resilience_babysitter.py.

Hard hangs the in-process watchdog can never unwind (a SIGSTOPped
trainer; on the card, a wait inside one CUDA or NCCL call) and crashed
incarnations are healed from outside: a stale heartbeat gets the
process tree SIGKILLed, the trainer is respawned and resumes from its
latest committed checkpoint.

The unit cases drive the spawn, watch and respawn loop with tiny
``python -c`` children that import nothing: a respawn on a nonzero
exit with the restart count in the child's env, the bounded budget with
its history, the heartbeat primed at spawn, the grace window measured
from spawn, the stale kill of the process tree, the env counters, the
``--metrics-port`` endpoint, and the CLI (its ``--fleet`` option group
reaches `FleetAgent`: a rank outside the roster is refused with the
reference's error, ``--no-rejoin`` arrives as ``rejoin=False``).

The oracle end to end: `tests/helper_torch_babysat.py`'s trainer
SIGSTOPs itself at step 1 on its first incarnation; the babysitter
kills and respawns it; the healed run's final checkpoint is
sha256-identical, file by file, to an unbroken run's. The stale window
is 25 s: the child's import and build took 7.3 s with ten children
started at once on this suite's 8-core host, and the window must cover
that 3 times over (the heartbeat is primed at spawn and next touched at
the child's `Watchdog`).
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from singa_tpu_torch import resilience
from singa_tpu_torch.resilience import babysitter, counters
from singa_tpu_torch.resilience.babysitter import Babysitter
from singa_tpu_torch.resilience.watchdog import HEARTBEAT_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALE_AFTER_S = 25.0


@pytest.fixture(autouse=True)
def _counters_isolation():
    counters.reset()
    yield
    counters.reset()


def _flag_cmd(code: str):
    return [sys.executable, "-c", code]


# -- unit: the spawn, watch and respawn loop ---------------------------------


def test_respawns_on_nonzero_exit_and_env_carries_restart_count(tmp_path):
    marker = str(tmp_path / "marker")
    sitter = Babysitter(
        _flag_cmd(
            "import os, sys\n"
            f"open({marker!r}, 'a').write("
            "os.environ['SINGA_BABYSIT_RESTARTS'] + ' ' +"
            " os.environ['SINGA_BABYSIT'] + '\\n')\n"
            "sys.exit(3 if os.environ['SINGA_BABYSIT_RESTARTS'] == '0'"
            " else 0)\n"),
        heartbeat_path=str(tmp_path / "hb"),
        stale_after_s=60.0, poll_s=0.05,
        max_restarts=3, sleep=lambda s: None)
    res = sitter.run()
    assert {k: res[k] for k in ("exit_code", "restarts", "stale_kills",
                                "healed")} == {
        "exit_code": 0, "restarts": 1, "stale_kills": 0, "healed": True}
    assert open(marker).read().splitlines() == ["0 1", "1 1"]
    assert counters.snapshot().get("restarts_external", 0) == 1
    assert [h["rc"] for h in res["history"]] == [3]


def test_restart_budget_is_bounded_with_history_attached(tmp_path):
    delays = []
    sitter = Babysitter(
        _flag_cmd("import sys; sys.exit(5)"),
        heartbeat_path=str(tmp_path / "hb"),
        stale_after_s=60.0, poll_s=0.05, max_restarts=2,
        backoff_s=0.5, sleep=delays.append)
    res = sitter.run()
    assert res["healed"] is False and res["exit_code"] == 5
    assert res["restarts"] == 2
    assert delays == [0.5, 1.0]  # retry.exp_backoff_s, the shared policy
    hist = res["history"]
    assert [h["rc"] for h in hist] == [5, 5, 5]
    assert [h["action"] for h in hist] == \
        ["respawn", "respawn", "budget exhausted"]
    assert [h.get("backoff_s") for h in hist[:2]] == [0.5, 1.0]
    assert not any(h["stale_kill"] for h in hist)


def test_spawn_primes_heartbeat_full_grace_period(tmp_path):
    """A heartbeat file left ancient by an earlier incarnation must not
    get the fresh trainer killed before its first beat."""
    hb = str(tmp_path / "hb")
    open(hb, "a").close()
    os.utime(hb, (0, 0))
    sitter = Babysitter(
        _flag_cmd("import time; time.sleep(0.8)"),  # never beats
        heartbeat_path=hb, stale_after_s=5.0, poll_s=0.05,
        max_restarts=1, sleep=lambda s: None)
    res = sitter.run()
    assert res["healed"] and res["stale_kills"] == 0, res
    assert res["restarts"] == 0


def test_grace_window_is_measured_from_spawn_and_kills_the_tree(tmp_path):
    """A child that never beats is killed, but only after the whole stale
    window from its spawn; the kill takes its process group (a
    grandchild too) and reaps the child, and the respawn completes."""
    t0 = time.monotonic()
    kill_elapsed = []
    grandchild = str(tmp_path / "grandchild")

    class Timed(Babysitter):
        def _kill_tree(self, proc):
            kill_elapsed.append(time.monotonic() - t0)
            super()._kill_tree(proc)
            assert proc.returncode is not None  # reaped

    sitter = Timed(
        _flag_cmd(
            "import os, subprocess, sys, time\n"
            "if os.environ['SINGA_BABYSIT_RESTARTS'] == '0':\n"
            "    p = subprocess.Popen([sys.executable, '-c',"
            " 'import time; time.sleep(600)'])\n"
            f"    open({grandchild!r}, 'w').write(str(p.pid))\n"
            "    time.sleep(600)\n"),
        heartbeat_path=str(tmp_path / "hb"),
        stale_after_s=2.0, poll_s=0.1, max_restarts=2,
        sleep=lambda s: None)
    res = sitter.run()
    assert time.monotonic() - t0 < 60.0  # killed, not waited out
    assert res["healed"] and res["stale_kills"] == 1, res
    assert res["restarts"] == 1
    assert kill_elapsed and kill_elapsed[0] >= 2.0, kill_elapsed
    assert res["history"][0]["stale_kill"] is True
    pid = int(open(grandchild).read())
    for _ in range(100):  # the grandchild's parent reaps it, or init
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        if open(f"/proc/{pid}/stat").read().split()[2] == "Z":
            break
        time.sleep(0.05)
    else:
        pytest.fail(f"the grandchild {pid} outlived the stale kill")


def test_babysit_env_counters_surface(monkeypatch):
    monkeypatch.setenv(counters.BABYSIT_ENV, "1")
    monkeypatch.setenv(counters.RESTARTS_ENV, "2")
    counters.reset()
    counters.absorb_babysitter_env()
    snap = counters.supervisor_snapshot()
    assert snap["babysit"] == 1 and snap["restarts_external"] == 2
    counters.absorb_babysitter_env()  # idempotent
    assert counters.supervisor_snapshot()["restarts_external"] == 2


def test_metrics_port_serves_the_registry_and_the_heartbeat(tmp_path):
    """`metrics_port=0` mounts the endpoint on a free port for the run:
    /metrics answers the process registry, /healthz judges the trainer's
    heartbeat; the endpoint stops with the run."""
    got = {}
    lines = []

    def fetch(port):
        base = f"http://127.0.0.1:{port}"
        got["healthz"] = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read())
        got["metrics"] = urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode()

    def log(msg):
        lines.append(msg)
        m = re.search(r"127\.0\.0\.1:(\d+)", msg)
        if m:
            got["port"] = int(m.group(1))
            got["thread"] = threading.Thread(target=fetch,
                                             args=(got["port"],))
            got["thread"].start()

    counters.bump("restarts")
    res = Babysitter(
        _flag_cmd("import time; time.sleep(1.5)"),
        heartbeat_path=str(tmp_path / "hb"), stale_after_s=30.0,
        poll_s=0.05, metrics_port=0, sleep=lambda s: None, log=log).run()
    got["thread"].join(10)
    assert res["healed"], res
    assert got["healthz"]["status"] == "ok", got
    assert "restarts" in got["metrics"], got["metrics"][:400]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{got['port']}/healthz",
                               timeout=2)


def test_cli_runs_a_trainer_and_refuses_the_fleet(tmp_path, capsys,
                                                  monkeypatch):
    code = babysitter.main(["--stale-after", "30", "--poll", "0.05",
                            "--heartbeat", str(tmp_path / "hb"), "--",
                            sys.executable, "-c", "pass"])
    assert code == 0
    assert "trainer completed (restarts=0, stale_kills=0)" in \
        capsys.readouterr().out
    assert babysitter.main(["--max-restarts", "0", "--heartbeat",
                            str(tmp_path / "hb"), "--", sys.executable,
                            "-c", "import sys; sys.exit(7)"]) == 7
    # the fleet option group reaches FleetAgent: a rank outside the
    # roster is the reference's ValueError, --no-rejoin is rejoin=False
    from singa_tpu_torch.resilience import fleet

    with pytest.raises(ValueError, match="outside the launch roster"):
        babysitter.main(["--fleet", str(tmp_path / "rdv"), "--fleet-rank",
                         "2", "--fleet-world", "2", "--", sys.executable,
                         "-c", "pass"])
    agents = []

    class Recorded(fleet.FleetAgent):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            agents.append(self)

    monkeypatch.setattr(fleet, "FleetAgent", Recorded)
    assert babysitter.main(["--fleet", str(tmp_path / "rdv"), "--no-rejoin",
                            "--poll", "0.05", "--heartbeat",
                            str(tmp_path / "hb"), "--", sys.executable,
                            "-c", "pass"]) == 0
    assert [a.rejoin for a in agents] == [False]
    assert agents[0].launch_roster == ["host0"]
    assert "job completed (epochs=0, elections won=1, led=True)" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        babysitter.main(["--stale-after", "5"])  # no trainer command
    # the watcher never takes a context on the card it polices
    assert not torch.cuda.is_initialized()


def test_babysit_module_entry_heals_a_crash(tmp_path):
    """`python -m singa_tpu_torch.resilience.babysit` as a process: the
    child fails once, the respawn completes, exit 0."""
    marker = str(tmp_path / "m")
    proc = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.resilience.babysit",
         "--stale-after", "60", "--poll", "0.05", "--backoff", "0",
         "--max-restarts", "2", "--", sys.executable, "-c",
         "import os, sys\n"
         f"open({marker!r}, 'a').write('x')\n"
         "sys.exit(0 if os.environ['SINGA_BABYSIT_RESTARTS'] != '0'"
         " else 4)\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "trainer completed (restarts=1, stale_kills=0)" in proc.stdout
    assert open(marker).read() == "xx"


# -- the oracle: SIGSTOP, kill, respawn, sha-identical -----------------------


def _trainer_cmd(ckpt_dir, n_steps, hang=False):
    cmd = [sys.executable, "-m", "tests.helper_torch_babysat", ckpt_dir,
           str(n_steps), "--device", "cpu"]
    return cmd + ["--hang"] if hang else cmd


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for key in (counters.BABYSIT_ENV, counters.RESTARTS_ENV):
        env.pop(key, None)
    return env


def _run_trainer_direct(ckpt_dir, n_steps, heartbeat):
    env = _child_env()
    env[HEARTBEAT_ENV] = heartbeat
    proc = subprocess.run(_trainer_cmd(ckpt_dir, n_steps), env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    return proc.stdout


def _sha_checkpoint(directory):
    """sha256 over the latest committed step dir: the manifest and every
    shard file, in name order."""
    step_dir = resilience.latest_step_dir(directory)
    h = hashlib.sha256()
    for name in sorted(os.listdir(step_dir)):
        h.update(name.encode())
        with open(os.path.join(step_dir, name), "rb") as f:
            h.update(f.read())
    return os.path.basename(step_dir), h.hexdigest()


def test_sigstop_kill_resume_sha_identical(tmp_path):
    """The trainer SIGSTOPs itself at step 1 (first incarnation only):
    frozen, no bytecode runs, its watchdog inert. The stale deadline
    fires, the process tree is SIGKILLed, the respawn resumes from the
    committed step-1 checkpoint and finishes; its final checkpoint is
    sha256-identical to the unbroken run's."""
    n = 4
    ref_dir = str(tmp_path / "ref")
    healed_dir = str(tmp_path / "healed")
    sitter = Babysitter(
        _trainer_cmd(healed_dir, n, hang=True),
        heartbeat_path=str(tmp_path / "hb"),
        stale_after_s=STALE_AFTER_S, poll_s=0.25,
        max_restarts=2, backoff_s=0.0, env=_child_env())
    with ThreadPoolExecutor(2) as ex:
        ref = ex.submit(_run_trainer_direct, ref_dir, n,
                        str(tmp_path / "hb_ref"))
        res = ex.submit(sitter.run).result()
        assert "started 0, restarts_external=0" in ref.result()
    assert res["healed"], res
    assert res["restarts"] == 1 and res["stale_kills"] == 1, res
    assert res["history"][0]["rc"] == -9 and res["history"][0]["stale_kill"]
    ref_name, ref_sha = _sha_checkpoint(ref_dir)
    got_name, got_sha = _sha_checkpoint(healed_dir)
    assert got_name == ref_name == f"step-{n:08d}"
    assert got_sha == ref_sha, (
        "the healed run's final checkpoint differs from the unbroken "
        "run's: the resume after the hard kill was not bitwise")
