"""The babysitter fleet: one agent per host and a lease election over
shared storage, host-level fault tolerance for a job of many processes
(counterpart of singa_tpu/resilience/fleet.py, the port's own copy).

One babysitter heals a hard hang on one host: a stale heartbeat gets
the process tree SIGKILLed and respawned. A job of many processes
breaks that model twice. No babysitter sees another host's freeze, so
each host needs its own agent. And no agent may heal alone: a torch
process group cannot take one rank back (every rank must re-join the
rendezvous), so a restart is a job-level decision that exactly one
agent makes. The fleet supplies both on the trust model of the
two-phase checkpoint commit: shared storage and nothing else.

- **The agent** (`FleetAgent`; ``python -m
  singa_tpu_torch.resilience.babysit --fleet DIR --fleet-rank I
  --fleet-world N -- <cmd>``) spawns the local trainer as the
  babysitter does (a session of its own, the heartbeat primed at
  spawn) and publishes a host heartbeat into the rendezvous every
  poll: ``hosts/<host_id>.json`` with the trainer's status (running,
  stale, exited with rc, done), its heartbeat age, the epoch it runs
  and the agent's and trainer's pids.
- **The lease** (`FileLease`): one nonce-stamped ``LEASE`` record with
  a ttl, renewed by its holder, the leader, the one agent that decides
  job-level restarts. On a posix path a claim is write, settle, read
  back: exactly one nonce survives a race. On a driver with a true
  compare-and-swap (``atomic_cas``, the ``mem://`` object store) it is
  one conditional put. A dead leader's renewals stop, the lease goes
  observably stale and a surviving agent takes it (leader failover),
  raising the shared election count.

  Staleness, of the lease and of every heartbeat, is observed change:
  a record is stale when its change token has not moved for the window
  on the observer's monotonic clock. Wall-clock stamps from another
  host are never compared, so a host with a skewed clock can neither
  steal a live lease nor have its liveness misjudged
  (`faults.lease_clock_skew` injects the skew).
- **Epoch bumps.** The leader turns "a host stale, a trainer dead" into
  a job restart by bumping the shared ``EPOCH`` record (epoch, roster,
  elections, nonce, reason). Every agent that sees a newer record
  SIGKILLs its tree and respawns the trainer at the new epoch, paced by
  `retry.exp_backoff_s`. The epoch count is the fleet's restart budget
  (``max_epochs``): a fleet that cannot converge writes ``FAILED`` with
  the bump history. A re-bump waits until every host without a problem
  has re-published at the current epoch, so one slow respawn does not
  burn the budget.
- **Roster shrink.** A host whose problem lasts past ``host_grace_s``
  leaves the roster in the next epoch record. The survivors respawn
  with ``SINGA_FLEET_WORLD`` = the smaller roster and
  ``SINGA_FLEET_RANK`` = their index in it; their trainers form a
  smaller process group, a `Supervisor(mesh_fn=)` folds dp onto it and
  the elastic restore re-places the latest committed checkpoint. When
  every roster host reports done, the leader writes ``DONE`` and every
  agent exits 0.
- **Re-grow.** An agent that starts and finds its host outside the
  roster (a returned host: its machine came back) publishes a join
  request (``joins/<host_id>.json``, republished every poll, so the
  leader judges it by observed change) instead of exiting. The leader
  folds every fresh request into its next bump: the roster grows
  (returned hosts append in sorted order, so survivors keep their
  ranks), the trainers respawn at the grown world and the elastic
  restore re-shards up. Bumps that change the roster are outside the
  epoch budget. Each grant bumps ``fleet_readmit``; a host past
  ``max_readmits`` is denied (``joins/<id>.denied``; an operator's
  ``joins/<id>.reset`` clears its count). An agent evicted while its
  trainer ran still exits: the leader judged a live host unhealthy.
- **Coordinator brokering.** A process group needs rank 0's address
  before any rank can join. roster[0]'s agent picks a free port each
  epoch and publishes ``coord/epoch-<n>.json`` through the no-clobber
  publish (one advertisement an epoch); every agent waits for it,
  bounded, and exports ``SINGA_COORDINATOR`` to its trainer beside
  WORLD and RANK, which the trainer hands to `distributed.init`. The
  advertised host is this machine's hostname unless ``coord_host``
  names another: never loopback, which a remote trainer would resolve
  to itself.

Rendezvous I/O goes through `singa_tpu_torch.storage.get_driver`: a
plain path is the shared filesystem (write-temp, fsync and rename; a
hard link for no-clobber), a ``mem://`` path the object-store fake.
The layout, and the JSON keys, are the reference's::

    rdv/
      EPOCH              {"epoch", "roster", "elections", "nonce", "reason"}
      LEASE              {"holder", "nonce", "ttl_s", "elections", "time"}
      DONE               written by the leader when every roster host is done
      FAILED             {"reason", "history"}: the epoch budget exhausted
      hosts/<id>.json    each host agent's heartbeat (published every poll)
      joins/<id>.json    re-admission requests from returned hosts
      coord/epoch-N.json the coordinator address roster[0] brokered

Every (re)spawn carries ``SINGA_FLEET=1``, ``SINGA_FLEET_EPOCH=<n>``
and ``SINGA_FLEET_ELECTIONS=<k>`` (the trainer's `counters` absorb
them at import: ``fleet``, ``fleet_epochs`` and ``elections`` in
`Model.fault_counters`), and ``SINGA_FLEET_WORLD``,
``SINGA_FLEET_RANK``, ``SINGA_FLEET_HOST`` for the trainer's topology.
Like the babysitter, an agent never initialises CUDA.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from typing import Any, Dict, List, Optional

from singa_tpu_torch import storage
from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import counters, retry
from singa_tpu_torch.resilience.babysitter import Babysitter
from singa_tpu_torch.resilience.watchdog import HEARTBEAT_ENV

__all__ = ["FleetAgent", "FileLease", "EPOCH_FILE", "LEASE_FILE",
           "DONE_FILE", "FAILED_FILE", "HOSTS_DIR", "JOINS_DIR",
           "COORD_DIR", "WORLD_ENV", "RANK_ENV", "HOST_ENV",
           "COORD_ENV", "default_roster"]

EPOCH_FILE = "EPOCH"
LEASE_FILE = "LEASE"
DONE_FILE = "DONE"
FAILED_FILE = "FAILED"
HOSTS_DIR = "hosts"
JOINS_DIR = "joins"
COORD_DIR = "coord"

#: the trainer's topology env (the counter-absorbed SINGA_FLEET,
#: SINGA_FLEET_EPOCH and SINGA_FLEET_ELECTIONS live in counters.py)
WORLD_ENV = "SINGA_FLEET_WORLD"
RANK_ENV = "SINGA_FLEET_RANK"
HOST_ENV = "SINGA_FLEET_HOST"
#: the brokered rank-0 coordinator address ("host:port"), exported to
#: every trainer of an epoch (module docstring)
COORD_ENV = "SINGA_COORDINATOR"


def default_roster(world: int) -> List[str]:
    """The default host ids for a world of `world` agents: every agent
    must derive the same initial roster, so it is a function of the
    launch world alone."""
    return [f"host{i}" for i in range(int(world))]


# -- atomic JSON records, through the storage driver -------------------------


def _write_json(path: str, record: Dict) -> None:
    storage.get_driver(path).put_atomic(
        path, json.dumps(record, indent=1).encode())


def _write_json_exclusive(path: str, record: Dict) -> bool:
    """Publish `record` at `path` only if nothing is there (posix: a
    temp file and a hard link, which refuses an existing target; object
    store: an If-None-Match put). Returns whether this caller's record
    won; a loser re-reads the winner's. There is no window in which two
    writers both publish: the EPOCH nonce is what every agent keys
    change on, so two nonces must be impossible, not unlikely."""
    return storage.get_driver(path).put_if_absent(
        path, json.dumps(record, indent=1).encode())


def _read_json(path: str) -> Optional[Dict]:
    """None on a missing object, and on a torn or foreign one (writes
    are atomic, but a read must never crash the agent's loop)."""
    data = storage.get_driver(path).read(path)
    if data is None:
        return None
    try:
        return json.loads(data.decode())
    except ValueError:
        return None


def _fingerprint(path: str):
    """The storage driver's change token for `path` (posix: (mtime_ns,
    size); object store: the generation), None when absent: what
    observed staleness is judged by."""
    return storage.get_driver(path).version(path)


class _ChangeTracker:
    """Staleness by observed change: `age_s(key, fingerprint)` is how
    long this process's monotonic clock has watched `key` hold the same
    fingerprint (0 the moment it changes, first sight and absence
    included). No wall-clock stamp from another host is compared, so
    clock skew can fake neither liveness nor death, and a trainer that
    has not beaten yet gets the full window from first observation."""

    def __init__(self, monotonic=time.monotonic):
        self._mono = monotonic
        self._seen: Dict[Any, tuple] = {}

    def age_s(self, key, fingerprint) -> float:
        now = self._mono()
        got = self._seen.get(key)
        if got is None or got[0] != fingerprint:
            self._seen[key] = (fingerprint, now)
            return 0.0
        return now - got[1]

    def forget(self, key) -> None:
        self._seen.pop(key, None)


# -- the lease ----------------------------------------------------------------


class FileLease:
    """A nonce-stamped lease record with expiry and renewal (module
    docstring): `tend()` once a poll acquires a free or expired lease,
    renews a held one (every ttl/3) and returns whether this process
    holds it. On a driver with a true compare-and-swap (``atomic_cas``)
    an acquisition is one conditional put against the version this
    tick judged free or expired: a rival's put moves the generation, so
    at most one claim lands. On posix, write, settle and confirm cover
    the same race."""

    def __init__(self, path: str, host_id: str, *, ttl_s: float = 10.0,
                 settle_s: float = 0.1, monotonic=time.monotonic,
                 time_fn=time.time, sleep=time.sleep):
        self.path = str(path)
        self.host_id = str(host_id)
        if ttl_s <= 0:
            raise ValueError(f"lease ttl_s={ttl_s!r} must be positive")
        self.ttl_s = float(ttl_s)
        self.settle_s = float(settle_s)
        #: this candidacy's identity; a re-acquire after losing the
        #: lease mints a fresh nonce, so a stale own write is never
        #: taken for a live hold
        self.nonce = uuid.uuid4().hex
        self.held = False
        #: the shared election ordinal as of our last acquisition
        self.elections = 0
        self._tracker = _ChangeTracker(monotonic)
        self._mono = monotonic
        self._time = time_fn
        self._sleep = sleep
        self._renewed_mono = float("-inf")

    def read(self) -> Optional[Dict]:
        return _read_json(self.path)

    def observed_expired(self, rec: Optional[Dict], fp=None) -> bool:
        """True when the lease record has not changed for its declared
        ttl of our monotonic observation (absent: expired at once). A
        holder's renewals move the fingerprint, so a live leader is
        never expired to any observer, whatever either wall clock says.
        `fp` judges a version token the caller already holds (the CAS
        path judges and swaps against the same observation)."""
        if fp is None:
            fp = _fingerprint(self.path)
        if fp is None:
            return True
        ttl = float((rec or {}).get("ttl_s", self.ttl_s) or self.ttl_s)
        return self._tracker.age_s("lease", fp) > ttl

    def tend(self) -> bool:
        """Acquire, renew or observe: the one entry point a poll."""
        drv = storage.get_driver(self.path)
        # the version token is read first and is the one observation
        # this tick both judges and (on a CAS driver) swaps against: a
        # token read after the judgment could be newer than the state
        # judged expired, and the put would clobber a rival's claim or a
        # holder's renewal. Read first, every such race fails the CAS.
        token = drv.version(self.path)
        rec = self.read()
        if self.held:
            if rec is None or rec.get("nonce") != self.nonce:
                # stolen (we went observably stale, e.g. a SIGSTOPped
                # agent resumed): stand down, fresh candidacy
                self.held = False
                self.nonce = uuid.uuid4().hex
            else:
                if self._mono() - self._renewed_mono >= self.ttl_s / 3.0:
                    elections = int(rec.get("elections", self.elections))
                    if drv.atomic_cas:
                        # a renewal is conditional too: a holder that
                        # stalled between its read and this write may
                        # have been deposed, and a plain put would
                        # clobber the rival's CAS-won claim
                        if not drv.put_if_match(
                                self.path, self._record_bytes(elections),
                                token):
                            self.held = False
                            self.nonce = uuid.uuid4().hex
                            return False
                        self._renewed_mono = self._mono()
                    else:
                        self._write(elections)
                return True
        expired = token is None or self.observed_expired(rec, fp=token)
        if rec is not None and rec.get("nonce") != self.nonce \
                and not expired:
            return False  # someone else holds a live lease
        elections = int((rec or {}).get("elections", 0)) + 1
        if drv.atomic_cas:
            # free or expired: one conditional put against the judged
            # token (None: absent) is claim and confirmation at once
            if not drv.put_if_match(self.path,
                                    self._record_bytes(elections), token):
                return False  # lost the race, or the holder renewed
            self._renewed_mono = self._mono()
            self.held = True
            self.elections = elections
            return True
        # posix: claim, settle, confirm (one nonce survives a concurrent
        # claim; the losers stand again next poll)
        self._write(elections)
        self._sleep(self.settle_s)
        back = self.read()
        if back is not None and back.get("nonce") == self.nonce:
            self.held = True
            self.elections = elections
            return True
        return False

    def _record_bytes(self, elections: int) -> bytes:
        return json.dumps({
            "holder": self.host_id, "nonce": self.nonce,
            "ttl_s": self.ttl_s, "elections": int(elections),
            "time": self._time()  # informational only, never compared
        }, indent=1).encode()

    def _write(self, elections: int) -> None:
        storage.get_driver(self.path).put_atomic(
            self.path, self._record_bytes(elections))
        self._renewed_mono = self._mono()

    def release(self) -> None:
        """Drop the lease if we hold it (a clean exit: the next leader
        need not wait out the ttl)."""
        if not self.held:
            return
        rec = self.read()
        if rec is not None and rec.get("nonce") == self.nonce:
            storage.get_driver(self.path).delete(self.path)
        self.held = False


# -- the per-host agent -------------------------------------------------------


class FleetAgent(Babysitter):
    """One host's agent (module docstring)::

        agent = FleetAgent(cmd, rendezvous_dir, rank=0, world=2)
        result = agent.run()

    `result` is {"healed", "exit_code", "epochs", "elections", "led",
    "evicted", "readmitted", "stale_kills", "restarts", "history"}:
    `healed` means the job completed (the leader wrote DONE), `epochs`
    is the last epoch this agent saw, `elections` how many times this
    agent won the lease, `evicted` that the roster dropped this host
    while it ran, `readmitted` that this agent started as a returned
    host and was re-admitted, and `history` one record per local
    incarnation or bump (the history the FAILED marker also carries)."""

    def __init__(self, cmd: List[str], rendezvous_dir: str, *,
                 rank: int = 0, world: int = 1,
                 host_id: Optional[str] = None,
                 roster: Optional[List[str]] = None,
                 heartbeat_path: Optional[str] = None,
                 trainer_stale_after_s: float = 300.0,
                 host_stale_after_s: float = 15.0,
                 host_grace_s: float = 30.0,
                 lease_ttl_s: float = 10.0,
                 poll_s: float = 0.2,
                 max_epochs: int = retry.RETRY_ATTEMPTS,
                 backoff_s: float = retry.RETRY_BACKOFF_S,
                 backoff_factor: float = 2.0,
                 backoff_cap_s: float = 120.0,
                 rejoin: bool = True,
                 max_readmits: int = 3,
                 broker_coordinator: bool = True,
                 coord_host: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 monotonic=time.monotonic,
                 time_fn=time.time,
                 log=print):
        roster = (list(roster) if roster is not None
                  else default_roster(world))
        if not 0 <= int(rank) < len(roster):
            raise ValueError(
                f"fleet rank {rank} is outside the launch roster of "
                f"{len(roster)} host(s) — pass --fleet-rank in "
                f"[0, {len(roster) - 1}] (a negative rank would "
                f"silently alias another host's heartbeat file)")
        host_id = host_id if host_id is not None else roster[int(rank)]
        if host_id not in roster:
            raise ValueError(
                f"host_id {host_id!r} is not in the launch roster "
                f"{roster} — every agent must agree on the initial "
                f"membership")
        super().__init__(cmd, heartbeat_path=heartbeat_path,
                         stale_after_s=trainer_stale_after_s,
                         poll_s=poll_s, max_restarts=max_epochs,
                         backoff_s=backoff_s,
                         backoff_factor=backoff_factor,
                         backoff_cap_s=backoff_cap_s, env=env, log=log)
        self.rendezvous_dir = str(rendezvous_dir)
        self.host_id = host_id
        self.launch_roster = roster
        self.host_stale_after_s = float(host_stale_after_s)
        self.host_grace_s = float(host_grace_s)
        self.max_epochs = int(max_epochs)
        self._mono = monotonic
        self._time = time_fn
        self.lease = FileLease(
            os.path.join(self.rendezvous_dir, LEASE_FILE), host_id,
            ttl_s=lease_ttl_s, monotonic=monotonic, time_fn=time_fn)
        self._tracker = _ChangeTracker(monotonic)
        #: the leader's bookkeeping: when a problem was first seen per
        #: host (monotonic; the grace runs from here) and the earliest
        #: time the next bump may land (backoff pacing)
        self._problem_since: Dict[str, float] = {}
        self._next_bump_mono = float("-inf")
        self.elections_won = 0
        self.led = False
        self.bumps_seen = 0
        #: re-grow (module docstring): a returned host requests
        #: re-admission; an agent evicted while running exits
        self.rejoin = bool(rejoin)
        #: the per-host re-admission budget, counted in the EPOCH record
        #: (``readmits``) so it survives a failover: a machine in a
        #: reboot loop is a "returned host" on every boot, and since
        #: roster-changing bumps are outside the epoch budget, only this
        #: cap ends its evict-and-rejoin cycle
        self.max_readmits = int(max_readmits)
        #: coordinator brokering: roster[0]'s agent advertises a fresh
        #: rank-0 port each epoch at this host name (module docstring)
        self.broker_coordinator = bool(broker_coordinator)
        self.coord_host = (str(coord_host) if coord_host is not None
                           else socket.gethostname())
        self._coord_addr: Optional[str] = None
        #: whether this agent ever saw itself on the roster: the
        #: returned-host / evicted-host distinction `rejoin` keys on
        self._was_in_roster = False
        self.readmitted = False

    # -- rendezvous paths -----------------------------------------------------
    def _p(self, name: str) -> str:
        return storage.join(self.rendezvous_dir, name)

    def _drv(self) -> storage.StorageDriver:
        return storage.get_driver(self.rendezvous_dir)

    def _exists(self, name: str) -> bool:
        return self._drv().exists(self._p(name))

    def _host_path(self, host_id: str) -> str:
        return storage.join(self.rendezvous_dir, HOSTS_DIR,
                            f"{host_id}.json")

    def _join_path(self, host_id: str) -> str:
        return storage.join(self.rendezvous_dir, JOINS_DIR,
                            f"{host_id}.json")

    def _coord_path(self, epoch: int) -> str:
        return storage.join(self.rendezvous_dir, COORD_DIR,
                            f"epoch-{int(epoch):06d}.json")

    def _read_epoch(self) -> Dict:
        """The current EPOCH record, tolerant of transient read errors
        (a blip of the shared storage must not crash the agent and get a
        healthy host evicted): a missing record re-inits, a present but
        unreadable one is retried for up to the host-staleness window
        (past that this host is lost anyway), then raises."""
        t0 = self._mono()
        while True:
            rec = _read_json(self._p(EPOCH_FILE))
            if rec is not None:
                return rec
            if not self._exists(EPOCH_FILE):
                self._init_rendezvous()
                continue
            if self._mono() - t0 > self.host_stale_after_s:
                raise RuntimeError(
                    f"fleet rendezvous EPOCH record "
                    f"{self._p(EPOCH_FILE)!r} exists but stayed "
                    f"unreadable for {self.host_stale_after_s:.0f}s — "
                    f"the shared filesystem is unreachable from this "
                    f"host (by then the leader will treat this host "
                    f"as lost)")
            time.sleep(self.poll_s)

    def _init_rendezvous(self) -> None:
        """Create the directories and the one initial EPOCH record by
        the no-clobber publish: exactly one agent's record lands, races
        and stalls notwithstanding (its nonce is what every agent keys
        change on). The losers read the winner's."""
        drv = self._drv()
        drv.makedirs(storage.join(self.rendezvous_dir, HOSTS_DIR))
        drv.makedirs(storage.join(self.rendezvous_dir, JOINS_DIR))
        drv.makedirs(storage.join(self.rendezvous_dir, COORD_DIR))
        if self._exists(EPOCH_FILE):
            return
        _write_json_exclusive(self._p(EPOCH_FILE), {
            "epoch": 0, "roster": self.launch_roster,
            "elections": 0, "nonce": uuid.uuid4().hex,
            "reason": "launch", "time": self._time()})

    # -- spawn ----------------------------------------------------------------
    def _child_env(self) -> Dict[str, str]:
        env = dict(os.environ if self.env is None else self.env)
        rec = self._cur_rec
        roster = rec["roster"]
        env[HEARTBEAT_ENV] = self.heartbeat_path
        env[counters.FLEET_ENV] = "1"
        env[counters.FLEET_EPOCH_ENV] = str(rec["epoch"])
        # the live lease carries the fleet's election ordinal; the EPOCH
        # record's copy is refreshed only at bumps (a healthy run's
        # trainers would otherwise report 0 elections)
        lease_rec = self.lease.read()
        env[counters.FLEET_ELECTIONS_ENV] = str(max(
            int((lease_rec or {}).get("elections", 0)),
            int(rec.get("elections", 0))))
        env[WORLD_ENV] = str(len(roster))
        env[RANK_ENV] = str(roster.index(self.host_id))
        env[HOST_ENV] = self.host_id
        if self._coord_addr:
            env[COORD_ENV] = self._coord_addr
        return env

    # -- coordinator brokering ------------------------------------------------
    @staticmethod
    def _free_port() -> int:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            return int(s.getsockname()[1])

    def _broker_coordinator(self, rec: Dict) -> Optional[str]:
        """The epoch's coordinator exchange (module docstring):
        roster[0]'s agent advertises a fresh port by the no-clobber
        publish (one advertisement an epoch; a lost race re-reads the
        winner's); every other agent waits, bounded by the
        host-staleness window (past it the rank-0 host counts as lost
        and the leader is already turning that into a bump). Returns
        the address or None."""
        roster = list(rec["roster"])
        if not roster:
            return None
        path = self._coord_path(int(rec["epoch"]))
        if roster[0] == self.host_id:
            got = _read_json(path)
            if got is None:
                _write_json_exclusive(path, {
                    "address": f"{self.coord_host}:{self._free_port()}",
                    "host": self.host_id, "epoch": int(rec["epoch"]),
                    "time": self._time()})
                got = _read_json(path)
            return (got or {}).get("address")
        deadline = self._mono() + self.host_stale_after_s
        while self._mono() < deadline:
            got = _read_json(path)
            if got is not None:
                return got.get("address")
            if self._exists(DONE_FILE) or self._exists(FAILED_FILE):
                return None
            cur = _read_json(self._p(EPOCH_FILE))
            if cur is not None and cur.get("nonce") != rec.get("nonce"):
                return None  # the epoch moved: respawn anyway
            self._publish(status="coord_wait", epoch=rec["epoch"],
                          rc=None, proc=None, hb_age_s=None)
            # the wait must not starve the leader's duties: a leader
            # stuck here would let its lease lapse (and never evict the
            # rank-0 host whose silence it waits out)
            self._tend_lease(cur if cur is not None else rec)
            time.sleep(self.poll_s)
        self._log(f"# fleet[{self.host_id}]: no coordinator "
                  f"advertisement for epoch {rec['epoch']} within "
                  f"{self.host_stale_after_s:.0f}s (rank-0 host "
                  f"{roster[0]} lost?) — spawning without "
                  f"{COORD_ENV}")
        return None

    # -- host heartbeat -------------------------------------------------------
    def _publish(self, *, status: str, epoch: int, rc, proc,
                 hb_age_s: Optional[float]) -> None:
        _write_json(self._host_path(self.host_id), {
            "host": self.host_id, "status": status, "epoch": int(epoch),
            "rc": rc, "pid": os.getpid(),
            "trainer_pid": getattr(proc, "pid", None),
            "hb_age_s": None if hb_age_s is None else round(hb_age_s, 3),
            "time": self._time()})

    # -- leader duties --------------------------------------------------------
    def _lead(self, rec: Dict) -> None:
        """One leadership tick (the lease held): read the roster's host
        heartbeats, write DONE when every host is done, turn problems
        into an epoch bump (paced and budgeted) and drop hosts gone past
        the grace window."""
        now = self._mono()
        roster = list(rec["roster"])
        problems: List[str] = []
        gone: List[str] = []
        done: List[str] = []
        settled = set()  # published at this epoch, or a known problem
        for hid in roster:
            path = self._host_path(hid)
            age = self._tracker.age_s(("host", hid), _fingerprint(path))
            hrec = _read_json(path)
            problem = None
            if age > self.host_stale_after_s:
                problem = (f"host {hid}: agent heartbeat stale "
                           f"{age:.1f}s (host lost?)")
            elif hrec is not None and \
                    int(hrec.get("epoch", -1)) == int(rec["epoch"]):
                settled.add(hid)
                st = hrec.get("status")
                if st == "stale":
                    problem = (f"host {hid}: trainer heartbeat stale "
                               f"{hrec.get('hb_age_s')}s (hard hang)")
                elif st == "exited":
                    problem = (f"host {hid}: trainer exited "
                               f"rc={hrec.get('rc')}")
                elif st == "done":
                    done.append(hid)
            # else: not re-published at this epoch yet (respawning):
            # only the agent-record staleness above judges it
            if problem is None:
                self._problem_since.pop(hid, None)
            else:
                settled.add(hid)
                self._problem_since.setdefault(hid, now)
                problems.append(problem)
                if now - self._problem_since[hid] > self.host_grace_s:
                    gone.append(hid)
        if len(done) == len(roster):
            _write_json(self._p(DONE_FILE), {
                "epoch": int(rec["epoch"]), "roster": roster,
                "elections": int(rec.get("elections", 0)),
                "time": self._time()})
            self._log(f"# fleet[{self.host_id}]: every roster host "
                      f"done at epoch {rec['epoch']} — job complete")
            return
        joiners, readmit_counts = self._join_requests(roster, rec)
        if not problems and not joiners:
            return
        # pacing: the shared backoff between bumps, and no re-bump until
        # every host without a problem re-published at this epoch (a
        # slow respawn must not burn the budget, a grow must not land
        # mid-heal)
        if now < self._next_bump_mono:
            return
        if len(settled) < len(roster):
            return
        if not self._still_leading(rec):
            return
        # the epoch budget bounds retries under the same conditions; a
        # bump that changes the roster (a shrink drops the lost host, a
        # grow adds capacity) changes them and is always granted, or a
        # lost host would fail the job before its grace elapsed instead
        # of being evicted into the elastic resume
        if int(rec["epoch"]) >= self.max_epochs and not gone \
                and not joiners:
            self.history.append({"epoch": int(rec["epoch"]),
                                 "problems": problems,
                                 "action": "budget exhausted"})
            _write_json(self._p(FAILED_FILE), {
                "reason": f"epoch budget exhausted "
                          f"({rec['epoch']}/{self.max_epochs})",
                "problems": problems, "history": self.history,
                "time": self._time()})
            self._log(f"# fleet[{self.host_id}]: {problems} with the "
                      f"epoch budget exhausted "
                      f"({rec['epoch']}/{self.max_epochs}) — writing "
                      f"FAILED; the latest committed checkpoint is "
                      f"the resume point")
            return
        new_roster = [h for h in roster if h not in gone]
        if not new_roster:
            new_roster = [self.host_id]  # the leader itself is alive
        # re-grow: returned hosts append in sorted order, so every
        # survivor keeps its rank and only the tail is new
        new_roster += [h for h in joiners if h not in new_roster]
        reasons = list(problems) + [f"re-admit {h}" for h in joiners]
        new_epoch = int(rec["epoch"]) + 1
        self.history.append({"epoch": new_epoch, "problems": problems,
                             "joined": joiners,
                             "roster": new_roster, "action": "bump"})
        bump_nonce = uuid.uuid4().hex
        for hid in joiners:
            readmit_counts[hid] = int(readmit_counts.get(hid, 0)) + 1
        # the heal's root span on the leader's timeline; the peers (and
        # their trainers' restore spans) correlate by epoch and nonce
        with trace.span("fleet.epoch_bump", epoch=new_epoch,
                        nonce=bump_nonce, roster=new_roster,
                        dropped=gone, joined=joiners,
                        reason="; ".join(reasons)[:200]):
            _write_json(self._p(EPOCH_FILE), {
                "epoch": new_epoch, "roster": new_roster,
                "elections": int(self.lease.elections),
                "nonce": bump_nonce,
                "readmits": readmit_counts,
                "reason": "; ".join(reasons)[:500],
                "time": self._time()})
        counters.bump("fleet_epochs")
        for hid in joiners:
            counters.bump("fleet_readmit")
            # the granted request is consumed, and the returned host gets
            # a fresh liveness clock: problem state inherited from its
            # previous life would evict it again at once
            self._drv().delete(self._join_path(hid))
            self._problem_since.pop(hid, None)
            self._tracker.forget(("host", hid))
        self._next_bump_mono = now + retry.exp_backoff_s(
            new_epoch - 1, self.backoff_s, self.backoff_factor,
            self.backoff_cap_s)
        self._log(
            f"# fleet[{self.host_id}]: epoch {rec['epoch']} -> "
            f"{new_epoch} ({'; '.join(reasons)}); roster "
            f"{new_roster}" + (
                f" — dropped {gone} (gone past the "
                f"{self.host_grace_s:.0f}s grace window)" if gone
                else "") + (
                f" — re-admitted {joiners} at the grown world"
                if joiners else ""))

    def _join_requests(self, roster: List[str], rec: Dict):
        """(grantable hosts, readmit counts) for the fresh join requests
        (module docstring, "re-grow"). The joiner republishes its
        request every poll, so freshness is observed change again: a
        leftover request whose fingerprint stopped past the
        host-staleness window is ignored. Requests from hosts already on
        the roster are stale grants and are consumed; a host past
        ``max_readmits`` (the EPOCH record's ``readmits``) is denied:
        its request is consumed and a ``.denied`` marker tells the
        waiting joiner to exit."""
        out = []
        drv = self._drv()
        counts = {str(k): int(v)
                  for k, v in (rec.get("readmits") or {}).items()}
        for name in drv.list(self._p(JOINS_DIR)):
            if not name.endswith(".json"):
                continue
            path = storage.join(self._p(JOINS_DIR), name)
            jrec = _read_json(path)
            hid = (jrec or {}).get("host")
            if not hid:
                continue
            if hid in roster:
                drv.delete(path)
                continue
            reset = storage.join(self._p(JOINS_DIR), f"{hid}.reset")
            if drv.exists(reset):
                # the operator's remedy for a repaired host: a .reset
                # marker zeroes the budget (the counts live in the EPOCH
                # record, so clearing .denied alone would be re-denied on
                # sight); the grant's bump persists the reset counts.
                # .denied goes first: a waiting joiner exits on ".denied
                # and no .reset", which the reference's order (.reset
                # first) shows it for a moment
                counts.pop(hid, None)
                drv.delete(storage.join(self._p(JOINS_DIR),
                                        f"{hid}.denied"))
                drv.delete(reset)
                self._log(f"# fleet[{self.host_id}]: operator reset "
                          f"for host {hid} — re-admission budget "
                          f"cleared")
            if counts.get(hid, 0) >= self.max_readmits:
                denied = storage.join(self._p(JOINS_DIR),
                                      f"{hid}.denied")
                if not drv.exists(denied):
                    _write_json(denied, {
                        "host": hid, "readmits": counts.get(hid, 0),
                        "limit": self.max_readmits,
                        "time": self._time()})
                    self._log(
                        f"# fleet[{self.host_id}]: denying host "
                        f"{hid}'s re-admission — already re-admitted "
                        f"{counts.get(hid, 0)}x (limit "
                        f"{self.max_readmits}); a flapping machine "
                        f"must not burn the fleet forever")
                drv.delete(path)
                continue
            age = self._tracker.age_s(("join", hid), _fingerprint(path))
            if age <= self.host_stale_after_s:
                out.append(hid)
        return sorted(out), counts

    def _still_leading(self, rec: Dict) -> bool:
        """The last check before a terminal write (an EPOCH bump,
        FAILED): the lease still carries our nonce and the EPOCH record
        is the one this tick judged. A leader that stalled between
        tend() and here may have been deposed and superseded. This is
        check-then-act, not a compare-and-swap: it shrinks the race from
        a whole scan to the final write, and the next bump re-converges
        any remainder (agents obey the latest record)."""
        lease = self.lease.read()
        if lease is None or lease.get("nonce") != self.lease.nonce:
            return False  # deposed: stand down, judge again next tick
        cur = _read_json(self._p(EPOCH_FILE))
        return cur is not None and cur.get("nonce") == rec.get("nonce")

    def _tend_lease(self, rec: Dict) -> None:
        was = self.lease.held
        if not self.lease.tend():
            return
        if not was:
            self.led = True
            self.elections_won += 1
            counters.bump("elections")
            trace.event("fleet.election", host=self.host_id,
                        election=self.lease.elections,
                        failover=self.lease.elections > 1)
            self._log(f"# fleet[{self.host_id}]: acquired the restart "
                      f"lease (election #{self.lease.elections})"
                      + ("" if self.lease.elections <= 1 else
                         " — leader failover"))
            # a new leader judges afresh: inherited problem clocks would
            # count time the previous leader already saw
            self._problem_since.clear()
            self._next_bump_mono = self._mono()
        self._lead(rec)

    # -- the agent loop -------------------------------------------------------
    def run(self) -> Dict[str, object]:
        try:
            return super().run()  # the base removes its heartbeat dir
        finally:
            self.lease.release()

    def _run(self) -> Dict[str, object]:
        return self._run_fleet()

    def _result(self, *, healed: bool, exit_code, epoch: int,
                evicted: bool = False) -> Dict[str, object]:
        return {"healed": healed, "exit_code": exit_code,
                "epochs": int(epoch), "elections": self.elections_won,
                "led": self.led, "evicted": evicted,
                "readmitted": self.readmitted,
                "stale_kills": self.stale_kills,
                "restarts": self.restarts,
                "history": list(self.history)}

    def _await_readmission(self, rec: Dict) -> str:
        """The returned host's side of re-grow (module docstring):
        republish a join request every poll until the leader's bump puts
        this host back on the roster, the job reaches a terminal marker,
        the leader denies the request, or no live leader is left to
        grant it (the lease's fingerprint stops moving well past every
        renewal deadline). An evicted host must not tend, or win, the
        lease, so nothing here touches it. Returns "admitted", "done",
        "failed", "denied" or "dead"."""
        self._log(f"# fleet[{self.host_id}]: host returned outside "
                  f"the epoch-{rec['epoch']} roster {rec['roster']} — "
                  f"requesting re-admission")
        denied_path = storage.join(self._p(JOINS_DIR),
                                   f"{self.host_id}.denied")
        reset_path = storage.join(self._p(JOINS_DIR),
                                  f"{self.host_id}.reset")
        dead_after = max(self.host_grace_s, self.lease.ttl_s * 3.0,
                         self.host_stale_after_s * 2.0)
        while True:
            cur = self._read_epoch()
            if self.host_id in cur["roster"]:
                self._drv().delete(self._join_path(self.host_id))
                self.readmitted = True
                self.history.append({"epoch": int(cur["epoch"]),
                                     "action": "readmitted"})
                self._log(f"# fleet[{self.host_id}]: re-admitted at "
                          f"epoch {cur['epoch']} (roster "
                          f"{cur['roster']}) — joining the job")
                return "admitted"
            if self._exists(DONE_FILE):
                return "done"
            if _read_json(self._p(FAILED_FILE)) is not None:
                return "failed"
            if self._drv().exists(denied_path) \
                    and not self._drv().exists(reset_path):
                # a pending operator .reset outranks a stale .denied:
                # keep requesting until the leader processes the reset
                self.history.append({"epoch": int(cur["epoch"]),
                                     "action": "rejoin denied"})
                self._log(f"# fleet[{self.host_id}]: re-admission "
                          f"DENIED by the leader (readmit budget) — "
                          f"exiting; an operator can write "
                          f"joins/{self.host_id}.reset in the "
                          f"rendezvous to zero this host's budget "
                          f"and allow another return")
                return "denied"
            if self._tracker.age_s(
                    "rejoin-leader",
                    _fingerprint(self._p(LEASE_FILE))) > dead_after:
                self.history.append({"epoch": int(cur["epoch"]),
                                     "action": "fleet dead"})
                self._log(f"# fleet[{self.host_id}]: no leader "
                          f"renewed the lease for {dead_after:.0f}s "
                          f"while this host awaited re-admission — "
                          f"the fleet is gone; exiting")
                return "dead"
            _write_json(self._join_path(self.host_id), {
                "host": self.host_id, "epoch_seen": int(cur["epoch"]),
                "time": self._time()})
            self._publish(status="rejoining", epoch=cur["epoch"],
                          rc=None, proc=None, hb_age_s=None)
            time.sleep(self.poll_s)

    def _run_fleet(self) -> Dict[str, object]:
        # a rendezvous is per job: a terminal marker from an earlier run
        # would make this launch an instant DONE or an inherited FAILED,
        # so refuse it. A live EPOCH without a marker is fine: that is an
        # agent re-joining a running job.
        for marker in (DONE_FILE, FAILED_FILE):
            if self._exists(marker):
                raise RuntimeError(
                    f"fleet rendezvous dir {self.rendezvous_dir!r} "
                    f"holds a terminal {marker} marker from a previous "
                    f"job — each launch needs a fresh rendezvous dir "
                    f"(or clear the directory to reuse the path)")
        self._init_rendezvous()
        while True:
            rec = self._read_epoch()
            if self.host_id not in rec["roster"]:
                # an agent that never held a seat in this life is a
                # returned host and may ask to re-join; one evicted
                # while running exits: the leader judged a live host
                # unhealthy, and rejoining would flap forever
                if self.rejoin and not self._was_in_roster:
                    got = self._await_readmission(rec)
                    if got == "admitted":
                        continue
                    cur = self._read_epoch()
                    return self._result(healed=(got == "done"),
                                        exit_code=(0 if got == "done"
                                                   else None),
                                        epoch=cur["epoch"])
                self._publish(status="evicted", epoch=rec["epoch"],
                              rc=None, proc=None, hb_age_s=None)
                self._log(f"# fleet[{self.host_id}]: dropped from the "
                          f"epoch-{rec['epoch']} roster "
                          f"{rec['roster']} — exiting (a RETURNED "
                          f"host's fresh agent re-joins through the "
                          f"join protocol)")
                return self._result(healed=False, exit_code=None,
                                    epoch=rec["epoch"], evicted=True)
            self._was_in_roster = True
            self._cur_rec = rec
            # the election comes before the first spawn: leadership is
            # settled from the start, and the child's election count
            # includes the one this launch just held
            self._tend_lease(rec)
            # the epoch's brokered coordinator (after the election: the
            # wait tends the lease)
            self._coord_addr = (self._broker_coordinator(rec)
                                if self.broker_coordinator else None)
            self._tracker.forget("trainer")
            proc = self._spawn()
            outcome, rc = self._watch_fleet(proc, rec)
            if outcome == "done":
                return self._result(healed=True, exit_code=0,
                                    epoch=rec["epoch"])
            if outcome == "failed":
                return self._result(healed=False, exit_code=rc,
                                    epoch=rec["epoch"])
            # outcome "epoch": respawn at the new epoch after the shared
            # backoff (the pause keeps publishing and tending the lease:
            # a backing-off leader must not look dead). The epoch ordinal
            # is the fleet's restart count; it rides into the trainers as
            # SINGA_FLEET_EPOCH, so no agent-local counter is kept.
            new = self._read_epoch()
            self.bumps_seen = max(self.bumps_seen, int(new["epoch"]))
            self.restarts = int(new["epoch"])
            self.history.append({"epoch": int(new["epoch"]),
                                 "action": "respawn", "rc": rc})
            delay = retry.exp_backoff_s(
                max(0, int(new["epoch"]) - 1), self.backoff_s,
                self.backoff_factor, self.backoff_cap_s)
            self._log(f"# fleet[{self.host_id}]: respawning at epoch "
                      f"{new['epoch']} in {delay:.1f}s "
                      f"({new.get('reason')})")
            t0 = self._mono()
            while self._mono() - t0 < delay:
                cur = self._read_epoch()
                self._publish(status="respawning", epoch=cur["epoch"],
                              rc=rc, proc=None, hb_age_s=None)
                # the pause obeys the watch loop's signals: a job that
                # finishes, fails or evicts us mid-backoff gets no doomed
                # respawn, and an evicted host does not tend the lease
                if self._exists(DONE_FILE):
                    return self._result(healed=True, exit_code=0,
                                        epoch=cur["epoch"])
                if _read_json(self._p(FAILED_FILE)) is not None:
                    return self._result(healed=False, exit_code=rc,
                                        epoch=cur["epoch"])
                if self.host_id not in cur["roster"]:
                    break  # the outer loop's roster check evicts us
                self._tend_lease(cur)
                time.sleep(self.poll_s)

    def _watch_fleet(self, proc, rec: Dict):
        """Watch one incarnation: publish the host heartbeat, tend the
        lease (and lead), obey DONE, FAILED and epoch transitions.
        Returns ("done" | "failed" | "epoch", last rc)."""
        rc = None
        status = "running"
        while True:
            if rc is None:
                rc = proc.poll()
                if rc is not None:
                    status = "done" if rc == 0 else "exited"
                    if rc != 0:
                        self._log(f"# fleet[{self.host_id}]: trainer "
                                  f"exited rc={rc} at epoch "
                                  f"{rec['epoch']} — a job-level "
                                  f"restart needs the leader's epoch "
                                  f"bump")
            hb_age = None
            if rc is None:
                hb_age = self._tracker.age_s(
                    "trainer", _fingerprint(self.heartbeat_path))
                if hb_age > self.stale_after_s and status != "stale":
                    status = "stale"
                    self._log(
                        f"# fleet[{self.host_id}]: trainer heartbeat "
                        f"{hb_age:.1f}s stale (deadline "
                        f"{self.stale_after_s:.1f}s) — hard hang; "
                        f"reporting to the leader (only an epoch bump "
                        f"restarts a multi-process job)")
            self._publish(status=status, epoch=rec["epoch"], rc=rc,
                          proc=proc, hb_age_s=hb_age)
            if self._exists(DONE_FILE):
                if rc is None:
                    self._kill_tree(proc)  # done fleet-wide: stragglers
                return "done", 0
            failed = _read_json(self._p(FAILED_FILE))
            if failed is not None:
                if rc is None:
                    self._kill_tree(proc)
                return "failed", (rc if rc not in (None, 0) else 1)
            self._tend_lease(rec)
            if self._exists(DONE_FILE):
                # usually our own _lead wrote it just now, but a remote
                # leader may also have committed DONE during the tend: a
                # running local tree must not outlive the job
                if rc is None:
                    self._kill_tree(proc)
                return "done", 0
            if _read_json(self._p(FAILED_FILE)) is not None:
                if rc is None:
                    self._kill_tree(proc)
                return "failed", (rc if rc not in (None, 0) else 1)
            new = _read_json(self._p(EPOCH_FILE))
            # a transition is a changed record (nonce), not only a new
            # number: agents obey the latest record, so even a
            # same-numbered overwrite re-converges through a respawn
            if new is not None and new.get("nonce") != rec.get("nonce"):
                if rc is None:
                    if status == "stale":
                        self.stale_kills += 1
                        counters.bump("stale_kills")
                    self._kill_tree(proc)
                return "epoch", rc
            time.sleep(self.poll_s)
