"""The babysitter fleet on the port, its protocol: the counterpart of
tests/test_resilience_fleet.py's units and thread-agent runs and of
tests/test_resilience_regrow.py's.

- the units: the observed-change staleness tracker (a record watched
  from first sight gets the full window) and the lease's state machine
  (acquire, renew, steal after silence, release) on a fake monotonic
  clock, over both storage drivers (posix: write, settle, confirm; the
  ``mem://`` object store: one compare-and-swap);
- the protocol runs: two agents (threads) over tiny ``python -c``
  trainers that import nothing, over both rendezvous drivers: election
  and completion with one agent's wall clock a week ahead
  (`faults.lease_clock_skew`), a crash healed by an epoch bump, and the
  epoch budget writing FAILED with its history;
- the refusals: a rank outside the roster, a rendezvous holding a
  terminal marker;
- the re-grow, over both drivers: a returned host re-admitted at the
  grown world with one brokered coordinator per epoch, an evicted live
  agent exiting, the re-admission budget denying a flapping host (and an
  operator's reset, which never shows a waiting joiner a denial), a
  rejoin giving up on a dead fleet.

The real process groups are in test_torch_fleet_host_loss.py,
test_torch_fleet_leader_loss.py and test_torch_fleet_regrow.py.
"""

import threading
import time
import uuid

import pytest

from singa_tpu_torch import storage
from singa_tpu_torch.resilience import counters, faults
from singa_tpu_torch.resilience.fleet import (DONE_FILE, EPOCH_FILE,
                                              FAILED_FILE, FileLease,
                                              FleetAgent, _ChangeTracker,
                                              _read_json)

from tests.helper_torch_fleet import (beat_cmd, child_env, run_agents,
                                      wait_until)


@pytest.fixture(autouse=True)
def _counters_isolation():
    counters.reset()
    yield
    counters.reset()


def _rdv(kind, tmp_path, name):
    if kind == "posix":
        return str(tmp_path / name)
    return storage.join(f"mem://fleet-{uuid.uuid4().hex[:12]}", name)


@pytest.fixture(params=["posix", "mem"])
def rdv_dir(request, tmp_path):
    """The rendezvous on both storage drivers: the protocol is
    driver-generic."""
    path = _rdv(request.param, tmp_path, "rdv")
    yield path
    if request.param == "mem":
        storage.get_driver(path).delete_prefix(path.rsplit("/", 1)[0])


# -- units ---------------------------------------------------------------------


def test_change_tracker_grace_from_first_sight():
    """First sight (absence included) starts the clock at zero, so an
    agent that starts before the first heartbeat gets the full window;
    any change of the fingerprint resets it."""
    t = {"now": 100.0}
    tr = _ChangeTracker(monotonic=lambda: t["now"])
    assert tr.age_s("f", None) == 0.0
    t["now"] += 5.0
    assert tr.age_s("f", None) == 5.0
    assert tr.age_s("f", (1, 10)) == 0.0  # appeared: the clock resets
    t["now"] += 7.0
    assert tr.age_s("f", (1, 10)) == 7.0
    assert tr.age_s("f", (2, 10)) == 0.0  # touched: resets again
    tr.forget("f")
    t["now"] += 9.0
    assert tr.age_s("f", (2, 10)) == 0.0  # forgotten: a fresh grace


@pytest.mark.parametrize("kind", ["posix", "mem"])
def test_lease_acquire_renew_failover(kind, tmp_path):
    """One nonce survives; a renewing holder is never stolen from; a
    holder silent past the ttl is, and the shared election ordinal
    rises across the takeover; the deposed holder stands down."""
    path = _rdv(kind, tmp_path, "LEASE")
    t = {"now": 0.0}

    def mono():
        return t["now"]

    a = FileLease(path, "A", ttl_s=10.0, settle_s=0.0, monotonic=mono,
                  sleep=lambda s: None)
    b = FileLease(path, "B", ttl_s=10.0, settle_s=0.0, monotonic=mono,
                  sleep=lambda s: None)
    assert a.tend() and a.held and a.elections == 1
    assert not b.tend()  # a live lease observed
    t["now"] += 6.0
    assert a.tend()  # the renewal (>= ttl/3) moves the fingerprint
    t["now"] += 6.0
    assert not b.tend()  # only 6 s since B saw the renewal
    t["now"] += 11.0  # A silent past the ttl
    assert b.tend() and b.held and b.elections == 2
    assert not a.tend() and not a.held
    rec = b.read()
    assert rec["holder"] == "B" and rec["elections"] == 2


@pytest.mark.parametrize("kind", ["posix", "mem"])
def test_lease_release_frees_immediately(kind, tmp_path):
    path = _rdv(kind, tmp_path, "LEASE")
    a = FileLease(path, "A", ttl_s=30.0, settle_s=0.0, sleep=lambda s: None)
    b = FileLease(path, "B", ttl_s=30.0, settle_s=0.0, sleep=lambda s: None)
    assert a.tend()
    assert not b.tend()
    a.release()
    assert b.tend() and b.read()["holder"] == "B"


# -- protocol runs: thread agents, trainers that import nothing ---------------


def _agents(rdv, body, max_epochs, **kw):
    return [FleetAgent(beat_cmd(body), rdv, rank=i, world=2,
                       trainer_stale_after_s=60.0, host_stale_after_s=30.0,
                       host_grace_s=600.0, lease_ttl_s=5.0, poll_s=0.05,
                       max_epochs=max_epochs, backoff_s=0.0,
                       env=child_env(),
                       time_fn=kw.get("time_fns", [time.time] * 2)[i])
            for i in range(2)]


def test_election_completion_and_clock_skew_immunity(rdv_dir):
    """Two agents, healthy trainers: one election fleet-wide, the leader
    writes DONE, both agents heal, with one agent's wall clock a week
    ahead: staleness is observed change on each observer's monotonic
    clock, so the skewed agent neither steals the lease nor misjudges
    liveness."""
    agents = _agents(rdv_dir, "sys.exit(0)\n", 2, time_fns=[
        time.time, faults.lease_clock_skew(7 * 86400.0)])
    results = run_agents(agents)
    assert all(r["healed"] for r in results), results
    assert all(r["epochs"] == 0 for r in results), results
    assert sum(r["elections"] for r in results) == 1, results
    done = _read_json(storage.join(rdv_dir, DONE_FILE))
    assert done["roster"] == ["host0", "host1"], done


def test_trainer_crash_heals_via_epoch_bump(rdv_dir):
    """A trainer exiting rc 3 on epoch 0 is not respawned locally: its
    agent reports it, the leader bumps the epoch, every host respawns,
    and the epoch-1 incarnations complete."""
    body = "sys.exit(3 if epoch == 0 and rank == 1 else 0)\n"
    results = run_agents(_agents(rdv_dir, body, 3))
    assert all(r["healed"] for r in results), results
    assert all(r["epochs"] == 1 for r in results), results
    rec = _read_json(storage.join(rdv_dir, EPOCH_FILE))
    assert rec["epoch"] == 1 and "rc=3" in rec["reason"], rec
    assert all(any(h.get("action") == "respawn" for h in r["history"])
               for r in results), results
    assert counters.snapshot().get("fleet_epochs") == 1


def test_epoch_budget_exhaustion_writes_failed_with_history(rdv_dir):
    """A trainer that always dies burns the epoch budget: the leader
    writes FAILED with the bump history (what each epoch failed on), and
    every agent reports healed False instead of flapping."""
    results = run_agents(_agents(rdv_dir, "sys.exit(3)\n", 2))
    assert all(not r["healed"] for r in results), results
    failed = _read_json(storage.join(rdv_dir, FAILED_FILE))
    assert failed is not None and "epoch budget exhausted" in \
        failed["reason"], failed
    bumps = [h for h in failed["history"] if h.get("action") == "bump"]
    assert len(bumps) == 2 and all("rc=3" in p for h in bumps
                                   for p in h["problems"]), failed


# -- refusals ------------------------------------------------------------------


def test_rank_outside_roster_refused():
    with pytest.raises(ValueError, match="outside the launch roster"):
        FleetAgent(["true"], "/tmp/x", rank=2, world=2)
    with pytest.raises(ValueError, match="outside the launch roster"):
        FleetAgent(["true"], "/tmp/x", rank=-1, world=2)
    with pytest.raises(ValueError, match="not in the launch roster"):
        FleetAgent(["true"], "/tmp/x", rank=0, world=2, host_id="hostX")


@pytest.mark.parametrize("marker", [DONE_FILE, FAILED_FILE])
def test_stale_terminal_marker_refused(rdv_dir, marker):
    """A rendezvous is per job: a terminal marker from an earlier run
    refuses the launch, instead of an instant DONE with nothing
    trained."""
    storage.get_driver(rdv_dir).put_atomic(
        storage.join(rdv_dir, marker), b"{}")
    agent = FleetAgent(beat_cmd("sys.exit(0)\n"), rdv_dir, rank=0,
                       world=1, poll_s=0.05, env=child_env())
    with pytest.raises(RuntimeError, match=f"terminal {marker} marker"):
        agent.run()


# -- re-grow: thread agents, trainers that import nothing ---------------------

#: exits 0 at world 2; below that it keeps beating (the job is not done
#: until the fleet re-grows: the quorum wait's shape)
QUORUM_BODY = ("if world == 2:\n"
               "    sys.exit(0)\n"
               "for _ in range(400):\n"
               "    open(hb, 'a').close(); os.utime(hb, None)\n"
               "    time.sleep(0.05)\n"
               "sys.exit(1)\n")


def coord_beat_cmd(body, coord_log):
    """`beat_cmd` that first appends its epoch, rank and brokered
    SINGA_COORDINATOR to `coord_log`."""
    return beat_cmd(
        "coord = os.environ.get('SINGA_COORDINATOR', '')\n"
        f"open({coord_log!r}, 'a').write(f'{{epoch}} {{rank}} {{coord}}\\n')\n"
        + body)


def regrow_kwargs(**over):
    kw = dict(world=2, trainer_stale_after_s=60.0, host_stale_after_s=2.0,
              host_grace_s=2.0, lease_ttl_s=3.0, poll_s=0.1, max_epochs=8,
              backoff_s=0.5, backoff_factor=1.0, env=child_env())
    kw.update(over)
    return kw


def start(agent, results, i):
    t = threading.Thread(target=lambda: results.__setitem__(i, agent.run()),
                         daemon=True)
    t.start()
    return t


def test_returned_host_readmitted_at_grown_world(rdv_dir, tmp_path):
    """host1's agent is absent at launch: the leader evicts it past the
    grace (the fleet heals at world 1); a fresh agent for host1 arrives,
    publishes a join request and is re-admitted at the grown world. Both
    trainers complete at world 2, the roster is back in rank order, the
    readmit counter moved, and within every epoch the trainers saw one
    brokered coordinator address, the machine's hostname, a fresh one
    for the grown epoch."""
    import socket

    coord_log = str(tmp_path / "coords")
    cmd = coord_beat_cmd(QUORUM_BODY, coord_log)
    results = [None, None]
    t0 = start(FleetAgent(cmd, rdv_dir, rank=0, **regrow_kwargs()),
               results, 0)
    wait_until(lambda: (_read_json(storage.join(rdv_dir, EPOCH_FILE))
                      or {}).get("roster") == ["host0"], 60,
             "the fleet never healed at world 1")
    t1 = start(FleetAgent(cmd, rdv_dir, rank=1, **regrow_kwargs()),
               results, 1)
    t0.join(90)
    t1.join(90)
    assert not t0.is_alive() and not t1.is_alive(), results
    assert all(r is not None and r["healed"] for r in results), results
    assert results[1]["readmitted"] is True, results[1]
    rec = _read_json(storage.join(rdv_dir, EPOCH_FILE))
    assert rec["roster"] == ["host0", "host1"], rec
    assert "re-admit host1" in rec["reason"], rec
    assert storage.get_driver(rdv_dir).exists(
        storage.join(rdv_dir, DONE_FILE))
    assert counters.snapshot().get("fleet_readmit") == 1
    per_epoch = {}
    for line in open(coord_log).read().splitlines():
        epoch, rank, coord = line.split(" ", 2)
        assert coord.startswith(f"{socket.gethostname()}:"), line
        per_epoch.setdefault(int(epoch), set()).add(coord)
    assert all(len(addrs) == 1 for addrs in per_epoch.values()), per_epoch
    assert len(per_epoch) >= 2, per_epoch
    addrs = [next(iter(a)) for _, a in sorted(per_epoch.items())]
    assert addrs[-1] not in addrs[:-1], per_epoch


def _puppet(rdv, epoch, roster, nonce, **extra):
    """Write an EPOCH record as a leader would (the test is the leader)."""
    import json

    storage.get_driver(rdv).put_atomic(
        storage.join(rdv, EPOCH_FILE), json.dumps(dict(
            epoch=epoch, roster=roster, elections=1, nonce=nonce,
            reason="puppet", **extra)).encode())


def test_evicted_live_agent_exits_not_rejoins(rdv_dir):
    """The flap guard: an agent that held a seat and then sees its own
    eviction exits with evicted True; it never enters the join protocol.
    A puppet leader (the test) keeps a foreign lease renewed, then
    writes the shrink bump."""
    import json

    drv = storage.get_driver(rdv_dir)
    drv.makedirs(storage.join(rdv_dir, "hosts"))
    lease_path = storage.join(rdv_dir, "LEASE")

    def renew_lease():
        drv.put_atomic(lease_path, json.dumps({
            "holder": "host0", "nonce": "puppet", "ttl_s": 3.0,
            "elections": 1, "time": time.time()}).encode())

    renew_lease()
    _puppet(rdv_dir, 0, ["host0", "host1"], "e0")
    agent = FleetAgent(
        beat_cmd("for _ in range(400):\n"
                 "    open(hb, 'a').close(); os.utime(hb, None)\n"
                 "    time.sleep(0.05)\n"
                 "sys.exit(1)\n"),
        rdv_dir, rank=1, **regrow_kwargs())
    results = [None]
    t = start(agent, results, 0)

    def seated():
        renew_lease()
        hrec = _read_json(storage.join(rdv_dir, "hosts", "host1.json"))
        return hrec is not None and hrec.get("status") == "running"

    wait_until(seated, 30, "host1 never took its seat")
    _puppet(rdv_dir, 1, ["host0"], "e1")
    deadline = time.monotonic() + 30
    while t.is_alive():
        renew_lease()  # the lost seat must not be takeable either
        t.join(0.2)
        assert time.monotonic() < deadline, "the agent never exited"
    assert results[0]["evicted"] is True, results[0]
    assert results[0]["readmitted"] is False, results[0]
    assert not drv.exists(storage.join(rdv_dir, "joins", "host1.json"))


def test_readmit_budget_denies_flapping_host(rdv_dir):
    """A host past its re-admission budget (the EPOCH record's
    `readmits`, which survive a failover) is denied, not re-admitted;
    an operator's joins/<id>.reset zeroes the budget and a relaunched
    agent for the repaired host is re-admitted."""
    drv = storage.get_driver(rdv_dir)
    drv.makedirs(storage.join(rdv_dir, "hosts"))
    _puppet(rdv_dir, 5, ["host0"], "e5", readmits={"host1": 3})
    kw = regrow_kwargs(max_readmits=3)
    leader_cmd = beat_cmd("for _ in range(120):\n"
                          "    open(hb, 'a').close()\n"
                          "    os.utime(hb, None)\n"
                          "    time.sleep(0.05)\n"
                          "sys.exit(0)\n")
    results = [None, None, None]
    t0 = start(FleetAgent(leader_cmd, rdv_dir, rank=0, **kw), results, 0)
    t1 = start(FleetAgent(beat_cmd("sys.exit(0)\n"), rdv_dir, rank=1,
                          **kw), results, 1)
    t1.join(60)
    assert not t1.is_alive(), results
    assert results[1]["healed"] is False, results[1]
    assert results[1]["readmitted"] is False, results[1]
    assert any(h.get("action") == "rejoin denied"
               for h in results[1]["history"]), results[1]
    assert drv.exists(storage.join(rdv_dir, "joins", "host1.denied"))
    assert "host1" not in _read_json(
        storage.join(rdv_dir, EPOCH_FILE))["roster"]

    drv.put_atomic(storage.join(rdv_dir, "joins", "host1.reset"), b"{}")
    t2 = start(FleetAgent(beat_cmd("sys.exit(0)\n"), rdv_dir, rank=1,
                          **kw), results, 2)
    t2.join(60)
    t0.join(60)
    assert not t2.is_alive() and not t0.is_alive(), results
    assert results[2]["readmitted"] is True, results[2]
    rec = _read_json(storage.join(rdv_dir, EPOCH_FILE))
    assert rec["roster"] == ["host0", "host1"], rec
    assert int(rec["readmits"].get("host1", 0)) == 1, rec  # the reset took


def test_rejoin_gives_up_when_fleet_is_dead(rdv_dir):
    """A returned host waiting on a fleet with no live leader (nobody
    renews the lease) gives up after the bounded dead-fleet window
    instead of republishing its request forever."""
    drv = storage.get_driver(rdv_dir)
    drv.makedirs(storage.join(rdv_dir, "hosts"))
    _puppet(rdv_dir, 3, ["host0"], "e3")
    # dead_after = max(grace 1, 3 * ttl 1, 2 * host stale 1) = 3 s
    agent = FleetAgent(beat_cmd("sys.exit(0)\n"), rdv_dir, rank=1,
                       **regrow_kwargs(host_stale_after_s=1.0,
                                       host_grace_s=1.0, lease_ttl_s=1.0))
    results = [None]
    t = start(agent, results, 0)
    t.join(30)
    assert not t.is_alive(), results
    assert results[0]["healed"] is False, results[0]
    assert any(h.get("action") == "fleet dead"
               for h in results[0]["history"]), results[0]


def test_an_operator_reset_never_shows_a_waiting_joiner_a_denial(
        rdv_dir, monkeypatch):
    """The leader clears a reset host's `.denied` before its `.reset`: a
    waiting joiner exits on ".denied and no .reset", so no moment between
    the two deletes may show it that (the reference deletes `.reset`
    first, and a joiner polling in between exits while the leader grants
    its request; the grown roster then waits on a host that left)."""
    drv = storage.get_driver(rdv_dir)
    _puppet(rdv_dir, 5, ["host0"], "e5", readmits={"host1": 3})
    leader = FleetAgent(beat_cmd("sys.exit(0)\n"), rdv_dir, rank=0,
                        **regrow_kwargs(max_readmits=3))
    leader._init_rendezvous()
    joins = storage.join(rdv_dir, "joins")
    denied = storage.join(joins, "host1.denied")
    reset = storage.join(joins, "host1.reset")
    for path, body in ((storage.join(joins, "host1.json"),
                        b'{"host": "host1"}'), (denied, b"{}"),
                       (reset, b"{}")):
        drv.put_atomic(path, body)
    seen = []
    delete = drv.delete

    def observed_delete(path):
        delete(path)
        seen.append(drv.exists(denied) and not drv.exists(reset))

    monkeypatch.setattr(drv, "delete", observed_delete)
    rec = _read_json(storage.join(rdv_dir, EPOCH_FILE))
    grant, counts = leader._join_requests(rec["roster"], rec)
    assert grant == ["host1"] and "host1" not in counts, (grant, counts)
    assert len(seen) == 2 and not any(seen), seen
    assert not drv.exists(denied) and not drv.exists(reset)
