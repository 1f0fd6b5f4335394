"""Replica router: N paged engines behind ONE queue (counterpart of
singa_tpu/serving/router.py: the reference's code with the port's
imports, per-replica CUDA streams for the parallel pump, and a process
entry for the spool server).

Rounds 15-21 built a mesh-native, prefix-cached, chunk-scheduled
serving engine — but one process serves one stream pool, so aggregate
throughput is capped at one engine and a dead server is an outage.
`ReplicaRouter` is the fleet front-end: it owns the one request queue
and dispatches across N replicas, mirroring AT THE FLEET LEVEL what
`ChunkedScheduler.order()` decides within one engine. Three signals
compose into the routing cost:

- **Prefix affinity.** The router keeps a SHADOW of each replica's
  prefix residency: on every dispatch it chains the request's
  full-block prompt keys (the replica engine's own `PrefixIndex`
  chain when the replica caches prefixes) and records them against
  the chosen replica — the registration event, observed optimistically
  at dispatch time rather than confirmed at prefill completion. The
  shadow is a BELIEF, not a lease: the engine verifies every mapped
  block on arrival (content-checked chain lookup), so a stale shadow
  entry — the block was LRU-reclaimed, the replica respawned cold —
  costs exactly one cold prefill and can never map wrong content.
  That staleness contract is what lets the shadow live router-side
  with no cache-coherence protocol. Local replicas additionally
  re-verify their shadow against the live index at each health turn
  (`index_entries` moving down evicts dead keys), so the belief decays
  toward truth instead of away from it.

- **Load.** The round-17 gauges, read host-side per replica: slot
  occupancy, KV-pool utilization, and queue depth (queued + prefilling
  per decode slot). They sum into a load score, and the dispatch cost
  is ``load - affinity_weight * warm_fraction`` — so an affine-but-
  saturated replica LOSES to a cold-but-idle one once its load exceeds
  the affinity discount, and `affinity_weight` is the tunable
  affinity-vs-balance knob (0 = pure load balancing; large = sticky
  routing). Ties rotate round-robin so equal replicas share arrivals.

- **Health.** A replica that dies (its pump raises), goes stale (the
  spool heartbeat ages past `stale_after_s` — the fleet's
  observed-change freshness rule), or is killed by the operator
  (`kill_replica`, the fault-injection surface) is DRAINED from the
  routing table: its incomplete streams are re-queued at the head of
  the router queue and re-routed. Token identity holds because a
  re-route restarts the stream from the prompt — decoding is
  deterministic in (prompt, seed, temperature), so the replacement
  stream re-emits the identical token sequence, and the router's
  exactly-once delivery (per-handle high-water mark) suppresses the
  already-delivered prefix, which a warm prefix cache makes cheap to
  recompute. A babysitter respawn re-admits the replica via
  `revive_replica` (shadow cleared: a fresh process holds no blocks).

**Fleet-wide tenant fairness.** With `sched="chunked"` the router
builds one `ChunkedScheduler` per replica but hands them ONE shared
deficit-account table (`ChunkedScheduler(accounts=...)`): a tenant's
served tokens accrue in the same ledger no matter which replica
served them, so deficit-round-robin holds across the fleet — one
tenant's storm on replica A queues behind another tenant's trickle
on replica B, exactly as it would inside one engine.

**Substrates.** In-process replicas (a `ServingEngine` or `Frontend`
per table entry) are the tier-1 substrate: deterministic, cheap, and
the identity oracle runs against them. `ProcessReplica` is the
process-backed mode: a real server process (``python -m
singa_tpu_torch.serving.router --spool DIR``, started as a fresh
interpreter, never forked from a process with CUDA up) serves a spool
directory through its own Frontend, touches the spool heartbeat every
scheduler turn, and publishes its load gauges to ``status.json`` — the
router reads health from heartbeat freshness and load from the status
file; a supervisor owns the respawn.

**Threads on the card.** The parallel pump steps each live local
replica on its own thread. On the card each local replica steps on its
engine's own CUDA stream (`ServingEngine.stream`, which first waits on
the caller's stream, and which the caller's stream waits on after the
pump), the stream its graphs were captured on: cuBLAS keys its
workspace by (handle, stream), so engines that captured or ran on one
stream would share a workspace, and their concurrent steps corrupt each
other's products. An engine that captures a suffix-chunk width at first
use does so behind the engine module's process-wide capture lock, in
thread-local capture mode, so the other thread keeps launching
meanwhile.

Telemetry: `router_dispatches`, `router_affinity_hits`,
`router_rebalances`, `router_replica_deaths`, `router_requeued`
(metrics.HELP; host-side ungated twins in `ReplicaRouter.stats`), and
the `router.dispatch` / `router.failover` span pair.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from singa_tpu_torch import resilience
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.observability import trace as obs_trace
from singa_tpu_torch.resilience import counters
from singa_tpu_torch.serving.blocks import PrefixIndex
from singa_tpu_torch.serving.engine import emitted_token_count
from singa_tpu_torch.serving.frontend import Frontend
from singa_tpu_torch.serving.sched import ChunkedScheduler

__all__ = ["ReplicaRouter", "RouterHandle", "ProcessReplica",
           "run_spool_server"]


class RouterHandle:
    """Caller-facing view of one routed stream. Unlike the per-replica
    `StreamHandle`, `tokens` is ROUTER-OWNED with exactly-once
    semantics: a failover restarts the underlying stream from the
    prompt, the replacement re-emits the identical sequence
    (determinism in prompt/seed/temperature), and the handle's
    high-water mark suppresses the already-delivered prefix — the
    caller observes one uninterrupted stream across any number of
    replica deaths."""

    def __init__(self, rid, prompt, max_new: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 on_token: Optional[Callable[[int, bool], None]] = None,
                 priority: str = "normal",
                 tenant: Optional[str] = None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.on_token = on_token
        self.priority = priority
        self.tenant = tenant
        self.tokens: List[int] = []
        self.status = "queued"
        self.error: Optional[Exception] = None
        #: name of the replica currently (or last) serving this stream
        self.replica: Optional[str] = None
        #: dispatch count — 1 on the happy path, +1 per failover
        self.attempts = 0
        #: the replica-side StreamHandle (local replicas only)
        self._inner = None
        #: per-replica chain-key cache, keyed by the replica's chain
        #: root (identical replicas share one entry)
        self._chains: Dict[bytes, list] = {}

    @property
    def done(self) -> bool:
        return self.status in ("done", "cancelled", "preempted",
                               "refused")

    def _deliver(self, tok: int, done: bool) -> None:
        """Exactly-once token delivery across failover re-emissions:
        the caller invokes this once per (attempt, position) in order;
        positions at or below the high-water mark are duplicates of an
        earlier attempt's identical tokens and are dropped."""
        self._attempt_pos += 1
        if self._attempt_pos <= len(self.tokens):
            return  # re-emitted prefix of a restarted stream
        self.tokens.append(int(tok))
        if self.on_token is not None:
            self.on_token(int(tok), bool(done))

    def _begin_attempt(self) -> None:
        self._attempt_pos = 0

    _attempt_pos = 0


class _Replica:
    """One routing-table entry: a backend (local Frontend or
    ProcessReplica) plus the router's per-replica state — the shadow
    prefix index, the assigned-stream map, and liveness."""

    def __init__(self, name: str, backend, local: bool):
        self.name = name
        self.backend = backend
        self.local = local
        self.alive = True
        #: router-side shadow of the replica's prefix residency:
        #: chain keys the router BELIEVES are resident there
        self.shadow: set = set()
        #: rid -> RouterHandle for streams dispatched here and not done
        self.assigned: Dict[object, RouterHandle] = {}

    # -- prefix chains -----------------------------------------------------

    def _chain_index(self):
        """The PrefixIndex whose key chain this replica's shadow keys
        ride: the engine's own index for a caching local replica (so
        shadow keys are directly verifiable against residency), a
        router-local chain otherwise (affinity only needs internal
        consistency — the engine still verifies content on arrival)."""
        if self.local and getattr(self.backend.engine, "prefix_cache",
                                  False):
            return self.backend.engine.prefix_index
        idx = getattr(self, "_own_index", None)
        if idx is None:
            idx = self._own_index = PrefixIndex(
                "router-shadow", self.block_size())
        return idx

    def block_size(self) -> int:
        if self.local:
            return self.backend.engine.block_size
        return self.backend.block_size

    def chain(self, handle: RouterHandle) -> list:
        idx = self._chain_index()
        cached = handle._chains.get(idx.root)
        if cached is None:
            cached = [k for k, _ in idx.chain_keys(handle.prompt)]
            handle._chains[idx.root] = cached
        return cached

    def affinity_tokens(self, handle: RouterHandle) -> int:
        """Shadow-matched prompt tokens: the longest run of the
        handle's chain keys the router believes resident here, in
        tokens. Belief, not lease — see the module staleness
        contract."""
        n = 0
        for key in self.chain(handle):
            if key not in self.shadow:
                break
            n += 1
        return n * self.block_size()

    def note_dispatch(self, handle: RouterHandle) -> None:
        """The registration event, observed optimistically: the
        replica will register these full blocks when its prefill
        completes (first writer wins engine-side)."""
        self.shadow.update(self.chain(handle))

    def verify_shadow(self) -> None:
        """Decay the belief toward truth (local caching replicas):
        drop shadow keys whose blocks are no longer in the live index
        — LRU reclaim or CoW retirement evicted them. Process replicas
        skip this (their index is remote); their shadow resets only on
        death/revive, and the engine-side verified lookup bounds the
        cost of any drift at one cold prefill."""
        if not (self.local and getattr(self.backend.engine,
                                       "prefix_cache", False)):
            return
        idx = self.backend.engine.prefix_index
        self.shadow = {k for k in self.shadow
                       if idx.block_of(k) is not None}

    # -- load + health -----------------------------------------------------

    def load(self) -> float:
        """Slot occupancy + KV utilization + queue pressure, each in
        [0, 1]-ish — the round-17 gauges as one host-side scalar."""
        if self.local:
            eng = self.backend.engine
            depth = (len(self.backend._queue)
                     + len(self.backend._inflight)) / max(1, eng.slots)
            return eng.slot_occupancy + eng.kv_utilization + depth
        return self.backend.load()

    def healthz(self) -> Dict[str, object]:
        h = self.backend.healthz()
        h["alive"] = self.alive
        return h

    def check_alive(self) -> bool:
        """Liveness probe: local replicas die only by exception or
        operator kill; process replicas by heartbeat staleness."""
        if not self.alive:
            return False
        if not self.local and not self.backend.fresh():
            return False
        return True


class ReplicaRouter:
    """One queue, N replicas — affinity + load + health routing with
    drain/requeue failover and fleet-wide tenant fairness (module
    docstring has the full semantics).

    `replicas`: a sequence of `ServingEngine` (wrapped in a fresh
    `Frontend` each), `Frontend` (used as-is), or `ProcessReplica`
    entries. `sched="chunked"` gives every router-built frontend a
    `ChunkedScheduler` sharing ONE deficit-account table; frontends
    passed in with their own sched are re-pointed at the shared table
    too (their existing per-tenant balances merge in). `quorum`
    (default majority) is the live-replica floor below which
    `healthz()` reports "degraded". `affinity_weight` trades prefix
    stickiness against load balance; `affinity=False` zeroes it
    (pure load + round-robin). `parallel_pump` steps live local
    replicas from one thread each — engines are independent, so their
    compiled steps overlap on the device/cores; defaults on when more
    than one local replica is in the table."""

    def __init__(self, replicas: Sequence, *,
                 affinity: bool = True,
                 affinity_weight: float = 1.0,
                 quorum: Optional[int] = None,
                 drain_token_budget: Optional[int] = None,
                 sched: Optional[str] = None,
                 chunk_budget: int = 2,
                 parallel_pump: Optional[bool] = None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.affinity = bool(affinity)
        self.affinity_weight = (float(affinity_weight) if affinity
                                else 0.0)
        self.drain_token_budget = drain_token_budget
        #: the ONE deficit ledger every replica's scheduler charges —
        #: fleet-wide fairness is per-engine fairness over a shared
        #: account table
        self.shared_accounts: Dict[object, int] = {}
        self._replicas: List[_Replica] = []
        for i, rep in enumerate(replicas):
            name = f"r{i}"
            if isinstance(rep, ProcessReplica):
                rep.name = rep.name or name
                self._replicas.append(_Replica(rep.name, rep,
                                               local=False))
                continue
            if isinstance(rep, Frontend):
                fe = rep
            else:  # a ServingEngine (or Speculative) — wrap it
                fe = Frontend(
                    rep, drain_token_budget=drain_token_budget,
                    sched=(ChunkedScheduler(
                        chunk_budget=chunk_budget,
                        accounts=self.shared_accounts)
                        if sched == "chunked" else None))
            if fe.sched is not None:
                # merge any pre-existing balances, then share the table
                for t, v in fe.sched._served.items():
                    self.shared_accounts[t] = (
                        self.shared_accounts.get(t, 0) + v)
                fe.sched._served = self.shared_accounts
            self._replicas.append(_Replica(name, fe, local=True))
        n = len(self._replicas)
        self.quorum = int(quorum) if quorum is not None else n // 2 + 1
        if not (1 <= self.quorum <= n):
            raise ValueError(
                f"quorum {self.quorum} must be in 1..{n} replicas")
        if parallel_pump is None:
            parallel_pump = sum(1 for r in self._replicas if r.local) > 1
        self.parallel_pump = bool(parallel_pump)
        self._queue: Deque[RouterHandle] = collections.deque()
        self._next_rid = 0
        self._rr = 0  # round-robin rotation for cost ties
        self._draining = False
        #: host-side ungated telemetry twins of the router_* metrics
        self.stats = {"dispatches": 0, "affinity_hits": 0,
                      "rebalances": 0, "replica_deaths": 0,
                      "requeued": 0}
        #: cumulative seconds each replica spent inside its own pump —
        #: the load-imbalance probe (a balanced fleet's entries track
        #: each other), and the fleet-wall basis bench.py uses: the
        #: replicas are independent engines (separate hosts in a real
        #: fleet), so fleet wall = router serial time + the SLOWEST
        #: replica's busy time, even where this container time-slices
        #: them on one core
        self.replica_busy_s: Dict[str, float] = {}
        self._m = {}  # cached metric handles (round-17 idiom)
        self._pool = None

    # -- introspection -----------------------------------------------------

    @property
    def replicas(self) -> List[_Replica]:
        return list(self._replicas)

    @property
    def live_replicas(self) -> List[_Replica]:
        return [r for r in self._replicas if r.alive]

    @property
    def draining(self) -> bool:
        return self._draining

    def healthz(self) -> Dict[str, object]:
        """The fleet health judgment an `export.MetricsServer` mounts:
        per-replica payloads (the round-15 single-engine `Frontend.
        healthz` reported one engine; the fleet's answer names each),
        aggregate "ok" only when a QUORUM of replicas is live —
        "degraded" below it (503: stop routing new traffic here),
        "draining" once a SIGTERM drain began."""
        live = len(self.live_replicas)
        status = ("draining" if self._draining
                  else "ok" if live >= self.quorum else "degraded")
        return {
            "status": status,
            "live": live,
            "replicas": len(self._replicas),
            "quorum": self.quorum,
            "queued": len(self._queue),
            "replica_health": {r.name: r.healthz()
                               for r in self._replicas},
        }

    def _bump(self, name: str, key: str, n: int = 1) -> None:
        self.stats[key] += n
        if obs_metrics.enabled():
            c = self._m.get(name)
            if c is None:
                c = self._m[name] = obs_metrics.counter(name)
            c.inc(n)

    # -- submission --------------------------------------------------------

    def submit(self, prompt, max_new: int, *,
               temperature: float = 0.0, seed: int = 0,
               on_token: Optional[Callable[[int, bool], None]] = None,
               rid=None, priority: str = "normal",
               tenant: Optional[str] = None) -> RouterHandle:
        """Enqueue a request on the ROUTER queue; the next `pump`
        turn routes it. Same surface as `Frontend.submit`."""
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        h = RouterHandle(rid, prompt, max_new, temperature=temperature,
                         seed=seed, on_token=on_token,
                         priority=priority, tenant=tenant)
        self._queue.append(h)
        return h

    def cancel(self, handle: RouterHandle) -> None:
        """Stop a routed stream wherever it is: still router-queued,
        or live on a replica (local replicas evict it; a process
        replica's copy runs to completion remotely but its tokens are
        dropped here)."""
        if handle.done:
            return
        if handle in self._queue:
            self._queue.remove(handle)
            handle.status = "cancelled"
            return
        for rep in self._replicas:
            if handle.rid in rep.assigned:
                rep.assigned.pop(handle.rid, None)
                if rep.local and rep.alive and handle._inner is not None:
                    rep.backend.cancel(handle._inner)
                handle.status = "cancelled"
                return
        handle.status = "cancelled"

    # -- routing -----------------------------------------------------------

    def _score(self, rep: _Replica, handle: RouterHandle):
        aff_tok = (rep.affinity_tokens(handle) if self.affinity_weight
                   else 0)
        warm = aff_tok / max(1, len(handle.prompt))
        return rep.load() - self.affinity_weight * warm, aff_tok

    def _choose(self, handle: RouterHandle):
        """Min-cost live replica; ties rotate round-robin so equal
        replicas share arrivals instead of herding on index 0."""
        live = self.live_replicas
        order = live[self._rr % len(live):] + live[:self._rr % len(live)]
        best = None
        best_cost = best_aff = None
        max_aff = 0
        for rep in order:
            cost, aff = self._score(rep, handle)
            max_aff = max(max_aff, aff)
            if best is None or cost < best_cost - 1e-12:
                best, best_cost, best_aff = rep, cost, aff
        self._rr += 1
        return best, best_cost, best_aff, max_aff

    def _dispatch_one(self, handle: RouterHandle) -> None:
        rep, cost, aff, max_aff = self._choose(handle)
        with obs_trace.span("router.dispatch", rid=handle.rid,
                            replica=rep.name, affinity_tokens=aff,
                            cost=round(cost, 4),
                            attempt=handle.attempts + 1):
            handle.attempts += 1
            handle.replica = rep.name
            handle._begin_attempt()
            handle.status = "active"
            rep.assigned[handle.rid] = handle
            if rep.local:
                cb = handle._deliver
                handle._inner = rep.backend.submit(
                    handle.prompt, handle.max_new,
                    temperature=handle.temperature, seed=handle.seed,
                    on_token=cb, rid=handle.rid,
                    priority=handle.priority, tenant=handle.tenant)
            else:
                handle._inner = None
                rep.backend.submit(handle)
            rep.note_dispatch(handle)
        self._bump("router_dispatches", "dispatches")
        if aff > 0:
            self._bump("router_affinity_hits", "affinity_hits")
        if max_aff > aff:
            # an affine replica existed but lost on load: the router
            # traded a warm prefix for balance
            self._bump("router_rebalances", "rebalances")

    def _route_queue(self) -> None:
        if not self._queue:
            return
        if not self.live_replicas:
            raise RuntimeError(
                f"all {len(self._replicas)} replicas are dead "
                f"({len(self._queue)} requests queued) — revive a "
                "replica (babysitter respawn) before routing resumes")
        while self._queue:
            self._dispatch_one(self._queue.popleft())

    # -- failover ----------------------------------------------------------

    def kill_replica(self, which) -> None:
        """Operator/fault-injection surface: drain replica `which`
        (name or index) from the routing table NOW — its incomplete
        streams re-queue and re-route on the next turn."""
        self._fail_replica(self._resolve(which), cause="killed")

    def revive_replica(self, which, backend=None) -> None:
        """Re-admit a drained replica (the babysitter-respawn path).
        `backend` replaces the dead one (a fresh `ServingEngine`,
        `Frontend`, or `ProcessReplica` — the respawned process holds
        none of its predecessor's state); omit it to revive the
        existing in-process backend (operator kill, not a real
        death). The shadow clears either way: a respawn is cold, and
        a false cold belief only costs one prefill."""
        rep = self._resolve(which)
        if backend is not None:
            if isinstance(backend, ProcessReplica):
                backend.name = rep.name
                rep.backend, rep.local = backend, False
            elif isinstance(backend, Frontend):
                rep.backend, rep.local = backend, True
            else:
                rep.backend = Frontend(
                    backend, drain_token_budget=self.drain_token_budget)
                rep.local = True
        rep.alive = True
        rep.shadow = set()
        rep.assigned = {}

    def _resolve(self, which) -> _Replica:
        if isinstance(which, _Replica):
            return which
        if isinstance(which, int):
            return self._replicas[which]
        for rep in self._replicas:
            if rep.name == which:
                return rep
        raise KeyError(f"no replica named {which!r}")

    def _fail_replica(self, rep: _Replica, cause: str) -> None:
        if not rep.alive:
            return
        rep.alive = False
        self._bump("router_replica_deaths", "replica_deaths")
        with obs_trace.span("router.failover", replica=rep.name,
                            cause=cause,
                            in_flight=len(rep.assigned)) as sp:
            requeued = 0
            # re-queue at the FRONT, preserving each stream's relative
            # order — a failover must not demote a stream behind
            # traffic that arrived after it
            for rid in sorted(rep.assigned, key=str, reverse=True):
                h = rep.assigned[rid]
                if h.done:
                    continue
                h.status = "queued"
                h._inner = None
                h.replica = None
                self._queue.appendleft(h)
                requeued += 1
            rep.assigned = {}
            rep.shadow = set()
            self._bump("router_requeued", "requeued", max(requeued, 0))
            sp.end(requeued=requeued)

    def _check_health(self) -> None:
        for rep in self._replicas:
            if rep.alive and not rep.check_alive():
                self._fail_replica(rep, cause="stale")
            elif rep.alive:
                rep.verify_shadow()

    # -- the serve loop ----------------------------------------------------

    def _pump_replica(self, rep: _Replica,
                      stream=None) -> Dict[object, int]:
        """One scheduler turn of one replica (on `stream`, a CUDA
        stream, when given), with the death/refusal triage: an
        exception whose blame lands on a specific stream (the frontend
        marked it refused/preempted with the error — over-window
        prompt, never-fits pool) surfaces to THAT router handle and
        the replica keeps serving; any other exception is the replica
        dying mid-step — drain it and re-route."""
        t0 = time.perf_counter()
        try:
            if stream is None:
                return rep.backend.pump()
            with torch.cuda.stream(stream):
                return rep.backend.pump()
        except Exception as err:
            blamed = False
            if rep.local:
                for rid, h in list(rep.assigned.items()):
                    inner = h._inner
                    if inner is not None and inner.status in (
                            "refused", "preempted"):
                        h.status = inner.status
                        h.error = inner.error or err
                        rep.assigned.pop(rid, None)
                        blamed = True
            if not blamed:
                self._fail_replica(rep, cause=type(err).__name__)
            return {}
        finally:
            self.replica_busy_s[rep.name] = (
                self.replica_busy_s.get(rep.name, 0.0)
                + time.perf_counter() - t0)

    def _sync_done(self) -> List[object]:
        done = []
        for rep in self._replicas:
            if not rep.alive:
                continue
            for rid, h in list(rep.assigned.items()):
                inner = h._inner
                if rep.local:
                    if inner is not None and inner.done:
                        h.status = inner.status
                        h.error = inner.error
                        rep.assigned.pop(rid, None)
                        if h.status == "done":
                            done.append(rid)
                else:
                    st = rep.backend.poll_one(h)
                    if st is not None:
                        h.status = st
                        rep.assigned.pop(rid, None)
                        if st == "done":
                            done.append(rid)
        return done

    def _replica_streams(self, reps: List[_Replica]) -> Dict[str, object]:
        """{replica name: its engine's own CUDA stream} for the local
        replicas on the card, each made to wait on the caller's stream,
        so work queued before the pump comes first."""
        out = {}
        for rep in reps:
            st = rep.backend.engine.stream
            if st is None:
                continue
            st.wait_stream(torch.cuda.current_stream(st.device))
            out[rep.name] = st
        return out

    def _pump_all(self) -> Dict[object, int]:
        """Step every live replica once — thread-per-replica when
        `parallel_pump` (engines are independent, so their steps
        overlap: PyTorch releases the GIL in its kernels and launches).
        On the card each local replica steps on its own stream, serial
        or parallel, and the caller's stream waits on them after."""
        emitted: Dict[object, int] = {}
        live = self.live_replicas
        locals_ = [r for r in live if r.local]
        streams = self._replica_streams(locals_)
        if self.parallel_pump and len(locals_) > 1:
            import concurrent.futures

            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=len(self._replicas),
                    thread_name_prefix="router-pump")
            futs = [self._pool.submit(self._pump_replica, r,
                                      streams.get(r.name))
                    for r in locals_]
            for f in futs:
                emitted.update(f.result() or {})
            for rep in live:
                if not rep.local:
                    emitted.update(self._pump_replica(rep) or {})
        else:
            for rep in live:
                emitted.update(self._pump_replica(
                    rep, streams.get(rep.name)) or {})
        for st in streams.values():
            torch.cuda.current_stream(st.device).wait_stream(st)
        return emitted

    def pump(self) -> Dict[object, int]:
        """One router turn: health-check the table, route the queue,
        step every live replica, settle completions. Returns the
        merged {rid: token} of streams that advanced."""
        self._check_health()
        self._route_queue()
        emitted = self._pump_all()
        self._sync_done()
        return emitted

    def _busy(self) -> bool:
        if self._queue:
            return True
        for rep in self._replicas:
            if rep.alive and rep.assigned:
                return True
        return False

    def run(self, exit_on_preempt: bool = False,
            guard=None) -> Dict[str, object]:
        """Serve until every routed stream settles, draining on
        SIGTERM with the `Frontend.run` contract: router-queued and
        replica-queued work hands back unstarted ("preempted"),
        in-flight streams decode to completion (bounded fleet-wide by
        `drain_token_budget` extra tokens), the drain stamps
        `preempt_drains`, and `exit_on_preempt` exits 0."""
        completed: List[object] = []
        preempted: List[object] = []
        drained = False
        drain_tokens = 0
        drain_span = None
        own_guard = guard is None
        if own_guard:
            guard = resilience.PreemptionGuard()
            guard.__enter__()
        try:
            while self._busy():
                if guard.triggered and not drained:
                    drained = True
                    self._draining = True  # /healthz flips NOW
                    preempted.extend(self._drain_queues())
                    drain_span = obs_trace.begin_span(
                        "router.preempt_drain",
                        queued=len(preempted))
                if not drained:
                    self._check_health()
                    self._route_queue()
                emitted = self._pump_all()
                completed.extend(self._sync_done())
                if drained:
                    drain_tokens += emitted_token_count(emitted)
                    if (self.drain_token_budget is not None
                            and drain_tokens >= self.drain_token_budget):
                        preempted.extend(self._cancel_active())
                if drained and not emitted and not self._busy():
                    break
        finally:
            if drain_span is not None:
                drain_span.end(drain_tokens=drain_tokens,
                               preempted=len(preempted))
            if own_guard:
                guard.__exit__(None, None, None)
        report = {"completed": completed, "preempted": preempted,
                  "drained": drained, "drain_tokens": drain_tokens}
        if drained:
            counters.bump("preempt_drains")
            if exit_on_preempt:
                raise SystemExit(0)
        return report

    def _drain_queues(self) -> List[object]:
        """Hand every not-yet-decoding stream back unstarted: the
        router queue, and each replica's own queued/prefilling
        handles (their tokens lists are empty — nothing is lost)."""
        out = []
        while self._queue:
            h = self._queue.popleft()
            h.status = "preempted"
            out.append(h.rid)
        for rep in self.live_replicas:
            if not rep.local:
                continue
            for rid, h in list(rep.assigned.items()):
                inner = h._inner
                if inner is not None and inner.status == "queued":
                    rep.backend.cancel(inner)
                    h.status = "preempted"
                    rep.assigned.pop(rid, None)
                    out.append(rid)
        return out

    def _cancel_active(self) -> List[object]:
        out = []
        for rep in self.live_replicas:
            for rid, h in list(rep.assigned.items()):
                if rep.local and h._inner is not None:
                    rep.backend.cancel(h._inner)
                h.status = "preempted"
                rep.assigned.pop(rid, None)
                out.append(rid)
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


# -- the process-backed replica (spool transport) -----------------------------


class ProcessReplica:
    """Router-side client of an out-of-process serve loop speaking the
    SPOOL protocol over one directory (atomic tmp+rename writes, so a
    reader never sees a torn file):

    - ``inbox/<rid>.json``  — router -> server: one request
    - ``outbox/<rid>.json`` — server -> router: the finished stream
    - ``status.json``       — server's load gauges, rewritten per turn
    - ``heartbeat``         — touched per scheduler turn
      (`resilience.touch_heartbeat`)
    - ``stop``              — router -> server: drain and exit 0

    Health IS heartbeat freshness (`fresh()`): a server that wedges or
    dies stops touching the file, the router drains it from the table
    exactly like a local death, and a supervisor owns the respawn.
    Delivery is stream-granular: tokens arrive when the remote stream
    completes, then replay through the handle's exactly-once path in
    order — identical bytes to a local serve, coarser timing."""

    def __init__(self, spool_dir: str, *, name: Optional[str] = None,
                 block_size: int = 16, stale_after_s: float = 30.0):
        self.spool_dir = str(spool_dir)
        self.name = name
        self.block_size = int(block_size)
        self.stale_after_s = float(stale_after_s)
        self.inbox = os.path.join(self.spool_dir, "inbox")
        self.outbox = os.path.join(self.spool_dir, "outbox")
        os.makedirs(self.inbox, exist_ok=True)
        os.makedirs(self.outbox, exist_ok=True)

    def _write_atomic(self, path: str, payload: dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def submit(self, handle: RouterHandle) -> None:
        self._write_atomic(
            os.path.join(self.inbox, f"{handle.rid}.json"),
            {"rid": str(handle.rid),
             "prompt": [int(t) for t in handle.prompt],
             "max_new": handle.max_new,
             "temperature": handle.temperature,
             "seed": handle.seed})

    def poll_one(self, handle: RouterHandle) -> Optional[str]:
        """Terminal status of `handle`'s remote stream if it finished
        ("done"/"refused"), else None. Tokens replay through the
        exactly-once delivery on completion."""
        path = os.path.join(self.outbox, f"{handle.rid}.json")
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        toks = rec.get("tokens", [])
        for i, t in enumerate(toks):
            handle._deliver(int(t), i == len(toks) - 1)
        if rec.get("status") == "refused":
            handle.error = RuntimeError(rec.get("error", "refused"))
            return "refused"
        return "done"

    def pump(self) -> Dict[object, int]:
        """The server steps itself; the router-side pump is a no-op
        (completions are collected by `poll_one` at settle time)."""
        return {}

    def cancel(self, handle) -> None:  # remote copy runs to completion
        pass

    def load(self) -> float:
        st = self.status()
        if not st:
            return 0.0
        slots = max(1, st.get("slots", 1))
        occ = st.get("active", 0) / slots
        kv = st.get("kv_used", 0) / max(1, st.get("kv_capacity", 1))
        depth = (st.get("queued", 0) + st.get("prefilling", 0)) / slots
        return occ + kv + depth

    def status(self) -> Dict[str, object]:
        try:
            with open(os.path.join(self.spool_dir, "status.json"),
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def healthz(self) -> Dict[str, object]:
        st = self.status()
        return {"status": "ok" if self.fresh() else "stale",
                "queued": st.get("queued", 0),
                "prefilling": st.get("prefilling", 0),
                "active": st.get("active", 0)}

    def fresh(self) -> bool:
        """The fleet's observed-change freshness rule on the server's
        heartbeat mtime. A heartbeat that never appeared yet reads as
        fresh — the server is inside its spawn/build window, which its
        supervisor polices, not ours. On the card, give `stale_after_s`
        room for a turn that captures a graph."""
        hb = os.path.join(self.spool_dir, "heartbeat")
        try:
            age = time.time() - os.stat(hb).st_mtime
        except OSError:
            return True
        return age <= self.stale_after_s

    def stop(self) -> None:
        with open(os.path.join(self.spool_dir, "stop"), "w"):
            pass


def run_spool_server(spool_dir: str, frontend: Frontend, *,
                     poll_s: float = 0.02,
                     max_idle_s: Optional[float] = None) -> int:
    """The server half of the spool protocol: serve `spool_dir`
    through `frontend` until a ``stop`` marker lands (and all work
    drained) or `max_idle_s` passes with nothing to do. Every turn
    touches the heartbeats (the `Frontend.pump` touch through
    ``SINGA_HEARTBEAT_FILE`` when supervised, and the spool's own
    ``heartbeat`` file the ROUTER's freshness probe reads) and
    rewrites ``status.json`` with the engine's load gauges. Returns
    the number of streams served. ``python -m
    singa_tpu_torch.serving.router --spool DIR`` (`main`) is the
    process entry that builds a seeded GPT and calls this."""
    inbox = os.path.join(spool_dir, "inbox")
    outbox = os.path.join(spool_dir, "outbox")
    os.makedirs(inbox, exist_ok=True)
    os.makedirs(outbox, exist_ok=True)
    hb = os.path.join(spool_dir, "heartbeat")
    seen: set = set()
    live: Dict[str, object] = {}
    served = 0
    idle_since = time.monotonic()

    def write_atomic(path, payload):
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def publish_status():
        eng = frontend.engine
        write_atomic(os.path.join(spool_dir, "status.json"), {
            "slots": eng.slots,
            "active": eng.n_active,
            "queued": len(frontend._queue),
            "prefilling": len(frontend._inflight),
            "kv_used": eng.allocator.used_blocks,
            "kv_capacity": eng.allocator.capacity,
            "block_size": eng.block_size,
            "decode_compiles": eng.decode_compiles,
            "tokens_emitted": eng.tokens_emitted,
        })

    while True:
        for fn in sorted(os.listdir(inbox)):
            if not fn.endswith(".json") or fn in seen:
                continue
            seen.add(fn)
            try:
                with open(os.path.join(inbox, fn),
                          encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            rid = rec["rid"]
            live[rid] = frontend.submit(
                np.asarray(rec["prompt"], np.int32),
                int(rec["max_new"]),
                temperature=float(rec.get("temperature", 0.0)),
                seed=int(rec.get("seed", 0)), rid=rid)
        busy = (frontend._queue or frontend._active
                or frontend._inflight)
        if busy:
            idle_since = time.monotonic()
            try:
                frontend.pump()
            except Exception as err:
                # a per-stream refusal: report it and keep serving
                for rid, h in list(live.items()):
                    if h.done and h.status in ("refused", "preempted"):
                        write_atomic(
                            os.path.join(outbox, f"{rid}.json"),
                            {"rid": rid, "status": "refused",
                             "tokens": [],
                             "error": str(h.error or err)})
                        live.pop(rid, None)
        for rid, h in list(live.items()):
            if h.done:
                write_atomic(os.path.join(outbox, f"{rid}.json"),
                             {"rid": rid, "status": h.status,
                              "tokens": [int(t) for t in h.tokens]})
                live.pop(rid, None)
                served += 1
        resilience.touch_heartbeat(hb)
        publish_status()
        if not busy:
            if os.path.exists(os.path.join(spool_dir, "stop")):
                return served
            if (max_idle_s is not None
                    and time.monotonic() - idle_since > max_idle_s):
                return served
            time.sleep(poll_s)


# -- the spool server's process entry -----------------------------------------


def main(argv=None) -> int:
    """``python -m singa_tpu_torch.serving.router --spool DIR [--device
    cpu] [--gpt-medium]``: build a GPT with seeded random weights (the
    small one of the CPU tests: vocab 31, d 32, 1 block of 2 heads,
    max_len 32, served at slots 2, block 8, window 32; or gpt_medium
    at slots 8, block 16, window 1024), serve DIR through
    `run_spool_server(DIR, Frontend(engine))`, and return 0 once a
    ``stop`` marker lands and all work drained."""
    import argparse

    from singa_tpu_torch import device as device_module
    from singa_tpu_torch.examples.serve_gpt import seeded_weights
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models.gpt import GPT, gpt_medium
    from singa_tpu_torch.serving.engine import ServingEngine

    p = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    p.add_argument("--spool", required=True, help="the spool directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0)")
    p.add_argument("--gpt-medium", action="store_true",
                   help="serve gpt_medium instead of the small GPT")
    p.add_argument("--seed", type=int, default=0,
                   help="numpy seed of the random weights")
    args = p.parse_args(argv)
    dev = device_module.resolve(args.device)
    if dev.type == "cuda":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.gpt_medium:
        m = gpt_medium(device=dev)
        ekw = dict(slots=8, block_size=16, window=1024)
    else:
        m = GPT(vocab_size=31, d_model=32, num_layers=1, num_heads=2,
                max_len=32, dropout=0.0, scan_blocks=True, device=dev)
        ekw = dict(slots=2, block_size=8, window=32)
    load_singa_tpu_params(m, seeded_weights(m, args.seed))
    m.eval()
    served = run_spool_server(args.spool, Frontend(ServingEngine(m, **ekw)))
    print(f"router replica server done: {served} streams served")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
