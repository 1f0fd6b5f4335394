"""Minimal streaming serving front-end: queue in, token callbacks out
(counterpart of singa_tpu/serving/frontend.py; host-only, the
reference's code with the port's imports).

`Frontend.submit` enqueues a request and returns a `StreamHandle`
whose `tokens` grow as the engine decodes (per-token `on_token`
callbacks fire from the serve loop's host thread). `Frontend.run`
is the serve loop: admit from the queue whenever a slot AND the blocks
are free (continuous batching — admission happens between compiled
steps), step the engine, repeat.

Preemption uses the resilience `PreemptionGuard`: the SIGTERM handler
only sets a flag (the step in flight always completes), and the loop
observes it between steps, then DRAINS: still-queued requests are
returned unstarted (status "preempted"), in-flight requests decode to
completion or to `drain_token_budget` extra tokens, whichever first,
and the drain is stamped into the process fault counters
(``preempt_drains``). `run(exit_on_preempt=True)` then exits 0: the
scheduler sees preemption handled, not failed.

Two more behaviours:

- **Overlapped continuous prefill** (``overlap_prefill=True``): instead
  of admitting synchronously between decode steps (stalling all N
  streams for every prefill), the loop DISPATCHES prefill(k+1), a
  `ServingEngine.begin_prefill_async` ticket, and admits the finished
  streams at a later step boundary. The policy is decode-first: at
  most one ticket in flight, and a ticket is finished only when
  `ticket.ready()` says finishing will not block, or when decode has
  nothing to do. The reserved slots stay inactive and trash-paged until
  the finish, so the captured decode step never changes. On the card
  the ticket's work is queued on the same stream as decode, so the
  overlap is of host work only (the reference's semantics). A drain
  with a prefill in flight hands those requests back unstarted
  (`abort_prefill`) and the `serve.preempt_drain` span counts them as
  queued.
- **Babysitter heartbeat**: every scheduler turn touches the
  ``SINGA_HEARTBEAT_FILE`` heartbeat (`resilience.touch_heartbeat`, a
  no-op when the variable is unset), so a supervisor can tell a hung
  server from a busy one.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from singa_tpu_torch import resilience
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.observability import trace as obs_trace
from singa_tpu_torch.resilience import counters
from singa_tpu_torch.serving.engine import Request, emitted_token_count

__all__ = ["Frontend", "StreamHandle"]


class StreamHandle:
    """Caller-facing view of one stream: `tokens` (grows live),
    `status` in {"queued", "active", "done", "cancelled", "preempted",
    "refused"}, `done` once no more tokens will arrive. A "refused"
    handle carries the admission `error` (e.g. an over-window request
    no configuration of this engine could serve) — one malformed
    request never takes the serve loop down."""

    def __init__(self, rid, request: Request):
        self.rid = rid
        self.request = request
        self.status = "queued"
        self.error: Optional[Exception] = None

    @property
    def tokens(self) -> List[int]:
        return self.request.tokens

    @property
    def done(self) -> bool:
        return self.status in ("done", "cancelled", "preempted",
                               "refused")


class Frontend:
    """Request queue + serve loop over a `ServingEngine`.

    `drain_token_budget` bounds how many MORE tokens a SIGTERM drain
    may decode across all in-flight streams (None = run every in-flight
    request to completion — bounded anyway by their max_new)."""

    def __init__(self, engine, drain_token_budget: Optional[int] = None,
                 overlap_prefill: bool = False, sched=None):
        self.engine = engine
        self.drain_token_budget = drain_token_budget
        #: round 18: dispatch prefill asynchronously while decode runs
        #: (requires the engine's begin/finish prefill split — any
        #: round-18 ServingEngine/SpeculativeEngine)
        self.overlap_prefill = bool(overlap_prefill)
        #: round 21: a `sched.ChunkedScheduler` turns the loop into
        #: the chunked-prefill scheduler — prefill advances at most
        #: `sched.chunk_budget` chunks per step boundary, admission
        #: order comes from the policy (lanes + tenant fairness +
        #: prefix affinity). Mutually composable with everything the
        #: overlap path serves; `overlap_prefill` is ignored when a
        #: sched is given (the chunked boundary subsumes it).
        self.sched = sched
        self._queue: Deque[StreamHandle] = collections.deque()
        self._active: Dict[object, StreamHandle] = {}
        #: handles riding the in-flight prefill ticket (status stays
        #: "queued" until the boundary admit — no tokens exist yet)
        self._inflight: Dict[object, StreamHandle] = {}
        self._ticket = None
        self._ticket_handles: List[StreamHandle] = []
        self._next_rid = 0
        self._draining = False
        #: round 21: the prefix-affine sort runs only when this is set
        #: (a submit, an admission) — an idle decode-heavy loop stops
        #: paying O(n log n) per turn. `_prefix_sorts` counts actual
        #: sorts (the spy the regression test reads).
        self._queue_dirty = True
        self._prefix_sorts = 0
        self._queue_gauge = None  # round-17: cached metric handle
        self._prefill_gauge = None
        self._stall_hist = None   # round 21: serve_decode_stall_ms
        # babysitter liveness (round 18): the env var the babysitter
        # exports at spawn; falsy outside one — touch is then a no-op
        self._hb_path = os.environ.get(resilience.HEARTBEAT_ENV)

    # -- observability -----------------------------------------------------

    @property
    def draining(self) -> bool:
        """True from the moment a SIGTERM drain begins (it never
        un-drains: the process exits after). The /healthz judgment."""
        return self._draining

    def healthz(self) -> Dict[str, object]:
        """The health judgment an `export.MetricsServer` mounts:
        status "draining" (HTTP 503 — take this replica out of
        rotation, in-flight work is finishing) once a drain began,
        "ok" otherwise, plus the live queue/active counts and the
        engine's capacity gauges. This payload describes ONE engine —
        a fleet's aggregate judgment (quorum of replicas live, each
        named) is `ReplicaRouter.healthz`, which embeds one of these
        per replica."""
        eng = self.engine
        return {"status": "draining" if self._draining else "ok",
                "queued": len(self._queue),
                "prefilling": len(self._inflight),
                "active": len(self._active),
                "slots": eng.slots,
                "free_slots": eng.free_slots,
                "kv_utilization": round(eng.kv_utilization, 4)}

    def _record_queue_depth(self) -> None:
        if not obs_metrics.enabled():
            return
        g = self._queue_gauge
        if g is None:
            g = self._queue_gauge = obs_metrics.gauge(
                "serve_queue_depth")
        g.set(len(self._queue))
        if self.overlap_prefill:
            pg = self._prefill_gauge
            if pg is None:
                pg = self._prefill_gauge = obs_metrics.gauge(
                    "serve_prefill_queue")
            pg.set(len(self._inflight))

    def _beat(self) -> None:
        """Per-turn babysitter liveness: a wedged serve loop (device
        hang, SIGSTOP) stops touching the heartbeat and the babysitter
        SIGKILLs + respawns the process — `--inject serve_hang`."""
        if self._hb_path:
            resilience.touch_heartbeat(self._hb_path)

    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               seed: int = 0,
               on_token: Optional[Callable[[int, bool], None]] = None,
               rid=None, priority: str = "normal",
               tenant: Optional[str] = None) -> StreamHandle:
        """Enqueue a request; returns its handle immediately. Tokens
        arrive once `run` (or `pump`) admits and steps it. `priority`
        ("high"/"normal"/"background") and `tenant` only matter under
        a `ChunkedScheduler` — the default loop serves FIFO."""
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new=int(max_new), temperature=temperature,
                      seed=seed, on_token=on_token,
                      priority=priority, tenant=tenant)
        handle = StreamHandle(rid, req)
        self._queue.append(handle)
        self._queue_dirty = True
        return handle

    def cancel(self, handle: StreamHandle) -> None:
        """Stop a stream: dequeue it, evict it mid-flight (its slot
        and blocks free immediately — the fragmentation source), or —
        overlap mode — cancel it mid-PREFILL: the engine defers the
        eviction to the ticket's finish so the in-flight scatter can
        never write into re-allocated blocks."""
        if handle.status == "queued":
            if handle.rid in self._inflight:
                self.engine.cancel(handle.rid)  # deferred evict
                self._inflight.pop(handle.rid, None)
                handle.status = "cancelled"
            else:
                self._queue.remove(handle)
                handle.status = "cancelled"
        elif handle.status == "active":
            self.engine.cancel(handle.rid)
            self._active.pop(handle.rid, None)
            handle.status = "cancelled"

    # -- serve loop --------------------------------------------------------

    def _prefix_sort_queue(self) -> None:
        """Prefix-affine admission (round 20): when the engine's prefix
        cache is on, STABLE-sort the queue so requests whose prompt
        prefix is resident admit first — a multi-turn follow-up lands
        while its cache blocks are still warm instead of queueing
        behind cold traffic that may LRU-reclaim them. Stable: hits
        keep their arrival order among themselves, and so do misses
        (no starvation flip-flopping — a miss only ever yields to
        requests that were going to prefill less). The probe is cheap
        (chain keys cache on the request, so steady state is dict
        lookups) but not free: since round 21 the sort runs only when
        the queue is DIRTY — a submit landed or an admission moved
        blocks/registrations — so an idle decode-heavy loop pays a
        boolean per turn, not O(n log n). The one-turn staleness this
        admits (a queued request turning warm purely from
        mid-decode registrations) resolves at the next admission."""
        eng = self.engine
        if not getattr(eng, "prefix_cache", False) or len(self._queue) < 2:
            return
        if not self._queue_dirty:
            return
        self._queue = collections.deque(sorted(
            self._queue,
            key=lambda h: eng.prefix_match_tokens(h.request) == 0))
        self._queue_dirty = False
        self._prefix_sorts += 1

    def _admit_from_queue(self) -> int:
        """Admit queued requests while slots AND blocks allow, letting
        the engine batch their prefills (admit_ready chunks reserves
        into `prefill_batch`-wide passes). A capacity refusal for the
        queue head just means "later" (unless nothing is in flight AND
        nothing was admitted — then the request can NEVER fit and the
        refusal must surface to the submitter); a VALIDATION refusal
        (over-window, empty prompt) fails that one handle as "refused"
        and serving continues."""
        admitted = 0
        self._prefix_sort_queue()
        while self._queue:
            handles = list(self._queue)
            slots, err = self.engine.admit_ready(
                [h.request for h in handles])
            for h in handles[:len(slots)]:
                self._queue.popleft()
                h.status = "active"
                self._active[h.rid] = h
            admitted += len(slots)
            if err is None:
                break  # the whole queue went in
            head = self._queue[0]
            if isinstance(err, ValueError):
                # malformed: refuse this one and keep serving the rest
                self._queue.popleft()
                head.status = "refused"
                head.error = err
                continue
            if self.engine.n_active == 0 and admitted == 0:
                self._queue.popleft()
                head.status = "preempted"
                raise err
            break  # capacity: retry after the next eviction
        # the caller settles: a max_new=1 request finishes AT prefill
        # and must land in the same completed record as every other
        if admitted:
            # admissions move blocks and prefix registrations: queued
            # requests' warm/cold status may have changed
            self._queue_dirty = True
        self._record_queue_depth()
        return admitted

    # -- the overlap scheduler (round 18) ----------------------------------

    def _overlap_boundary(self) -> int:
        """One step-boundary turn of the overlapped-prefill scheduler:
        (1) ADMIT the in-flight ticket if finishing will not block —
        `ticket.ready()`, or decode has nothing to do anyway
        (`n_active == 0`: blocking on prefill IS the fastest path to
        tokens then) — and (2) DISPATCH the next prefill for whatever
        the queue holds, to drain on the device while the next decode
        step runs. At most ONE ticket is in flight: that bounds how
        much device time prefill can steal from decode per window (the
        don't-starve-decode policy) and is exactly the round-13
        double-buffer shape — issue (k+1), run (k)."""
        eng = self.engine
        admitted = 0
        if self._ticket is not None and (
                eng.n_active == 0 or self._ticket.ready()):
            admitted += self._finish_ticket()
        self._prefix_sort_queue()
        while self._queue and self._ticket is None:
            handles = list(self._queue)
            ticket, err = eng.begin_prefill_async(
                [h.request for h in handles])
            n = len(ticket.requests) if ticket is not None else 0
            took = []
            for h in handles[:n]:
                self._queue.popleft()
                self._inflight[h.rid] = h
                took.append(h)
            if ticket is not None:
                self._ticket = ticket
                self._ticket_handles = took
            if err is None:
                break
            if not self._queue:
                break
            head = self._queue[0]
            if isinstance(err, ValueError):
                # malformed: refuse this one, keep scheduling the rest
                self._queue.popleft()
                head.status = "refused"
                head.error = err
                continue
            if (eng.n_active == 0 and self._ticket is None
                    and not self._active and not self._inflight
                    and admitted == 0):
                # nothing running, nothing in flight, nothing admitted:
                # this request can NEVER fit — surface the refusal
                self._queue.popleft()
                head.status = "preempted"
                raise err
            break  # capacity: retry at a later boundary
        self._record_queue_depth()
        return admitted

    def _finish_ticket(self) -> int:
        """Admit the in-flight ticket's streams: force/install/activate
        via the engine, move the not-cancelled handles to active, clear
        the ticket. The CALLER decides when (ticket ready, decode
        idle, or — chunked — staged work drained). Marks the queue
        dirty: finishing registers prefix blocks, which can warm
        queued requests."""
        admitted = 0
        self.engine.finish_prefill(self._ticket)
        for h in self._ticket_handles:
            self._inflight.pop(h.rid, None)
            if h.status == "queued":   # not cancelled meanwhile
                h.status = "active"
                self._active[h.rid] = h
                admitted += 1
        self._ticket = None
        self._ticket_handles = []
        self._queue_dirty = True
        return admitted

    # -- the chunked scheduler (round 21) ----------------------------------

    def _sched_boundary(self) -> int:
        """One step-boundary turn of the CHUNKED scheduler:
        (1) ADVANCE the in-flight ticket's staged prefill by at most
        the policy's chunk budget; (2) ADMIT it once `ready()` (all
        chunks ran, device resolved) or decode has nothing to do
        anyway (`finish_prefill` drains the remainder then — blocking
        IS the fastest path to tokens when no stream is active);
        (3) with no ticket left, DISPATCH the policy's order as a new
        chunked ticket and spend any leftover budget on it
        immediately. At most one ticket in flight, exactly like the
        overlap loop — the chunk BUDGET, not the ticket count, is
        what bounds how much device time prefill steals from active
        streams per step."""
        eng = self.engine
        sched = self.sched
        admitted = 0
        budget = sched.chunk_budget
        if self._ticket is not None:
            if eng.n_active > 0:
                budget -= eng.advance_prefill(self._ticket,
                                              max_chunks=budget)
            if eng.n_active == 0 or self._ticket.ready():
                admitted += self._finish_ticket()
        while self._queue and self._ticket is None:
            handles = sched.order(list(self._queue), eng)
            ticket, err = eng.begin_prefill_async(
                [h.request for h in handles], chunked=True)
            n = len(ticket.requests) if ticket is not None else 0
            took = []
            for h in handles[:n]:
                self._queue.remove(h)
                self._inflight[h.rid] = h
                sched.commit(h)
                took.append(h)
            if ticket is not None:
                self._ticket = ticket
                self._ticket_handles = took
            if err is None:
                break
            if not handles[n:]:
                break
            head = handles[n]
            if isinstance(err, ValueError):
                # malformed: refuse this one, keep scheduling the rest
                self._queue.remove(head)
                head.status = "refused"
                head.error = err
                continue
            if (eng.n_active == 0 and self._ticket is None
                    and not self._active and not self._inflight
                    and admitted == 0):
                # nothing running, nothing in flight, nothing admitted:
                # this request can NEVER fit — surface the refusal
                self._queue.remove(head)
                head.status = "preempted"
                raise err
            break  # capacity: retry at a later boundary
        if self._ticket is not None:
            if eng.n_active == 0:
                admitted += self._finish_ticket()
            elif budget > 0:
                eng.advance_prefill(self._ticket, max_chunks=budget)
        self._record_queue_depth()
        return admitted

    def _boundary(self) -> int:
        """One admission turn, routed by mode (chunked policy >
        overlap > synchronous) and timed into the
        `serve_decode_stall_ms` histogram whenever active streams
        were waiting on it: the wall a boundary spends while decode
        HAS work is exactly the decode gap prefill causes — the
        number chunked scheduling exists to bound."""
        had_active = self.engine.n_active > 0
        rec = had_active and obs_metrics.enabled()
        t0 = time.perf_counter() if rec else 0.0
        if self.sched is not None:
            admitted = self._sched_boundary()
        elif self.overlap_prefill:
            admitted = self._overlap_boundary()
        else:
            admitted = self._admit_from_queue()
        if rec:
            h = self._stall_hist
            if h is None:
                h = self._stall_hist = obs_metrics.histogram(
                    "serve_decode_stall_ms")
            h.observe((time.perf_counter() - t0) * 1000.0)
        return admitted

    def _abort_inflight_prefill(self) -> List[object]:
        """Drain path: hand the in-flight ticket's requests back
        unstarted (they decoded nothing — `abort_prefill` frees their
        reservations without activating a slot). Returns their rids,
        which the drain report counts as queued-back."""
        if self._ticket is None:
            return []
        self.engine.abort_prefill(self._ticket)
        rids = []
        for h in self._ticket_handles:
            self._inflight.pop(h.rid, None)
            if h.status == "queued":
                h.status = "preempted"
                rids.append(h.rid)
        self._ticket = None
        self._ticket_handles = []
        return rids

    def _settle(self) -> List[object]:
        """Move handles whose requests finished out of the active set;
        returns the newly completed rids."""
        done = [r for r, h in self._active.items() if h.request.done]
        for rid in done:
            self._active.pop(rid).status = "done"
        return done

    def pump(self) -> Dict[object, int]:
        """One scheduler turn: admit what fits (synchronously, or via
        the overlap boundary), run one decode step. Returns
        {rid: token} for streams that advanced — the unit the serve
        loop (and tests) iterate."""
        self._beat()
        self._boundary()
        emitted = self.engine.step()
        self._settle()
        return emitted

    def run(self, exit_on_preempt: bool = False,
            guard=None) -> Dict[str, object]:
        """Serve until queue and slots are empty, draining on SIGTERM.

        Returns a report: {"completed": [rids], "preempted": [rids],
        "drained": bool, "drain_tokens": n}. With `exit_on_preempt` a
        drain ends in SystemExit(0) — the PreemptionGuard exit-0
        contract. Pass an entered `guard` to share an outer
        PreemptionGuard; otherwise one is installed for the loop."""
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
            while self._queue or self._active or self._inflight:
                self._beat()
                if guard.triggered and not drained:
                    drained = True
                    self._draining = True  # /healthz flips to 503 NOW
                    in_flight = len(self._active)
                    # the drain: queued work is handed back unstarted —
                    # including an overlapped prefill still in flight
                    # (it decoded nothing; abort_prefill frees its
                    # reservation, the report counts it queued-back)
                    preempted.extend(self._abort_inflight_prefill())
                    while self._queue:
                        h = self._queue.popleft()
                        h.status = "preempted"
                        preempted.append(h.rid)
                    # …under one span covering the whole drain: the
                    # recorded in-flight/queued counts are the drain
                    # result's own numbers (oracle in
                    # tests/test_observability_serving.py)
                    drain_span = obs_trace.begin_span(
                        "serve.preempt_drain", in_flight=in_flight,
                        queued=len(preempted))
                    self._record_queue_depth()
                if not drained:
                    self._boundary()
                    completed.extend(self._settle())
                if not self._active:
                    if not drained and (self._inflight or self._queue):
                        continue  # the next boundary admits/finishes
                    break
                emitted = self.engine.step()
                completed.extend(self._settle())
                if drained:
                    # …and in-flight streams finish within the budget
                    # (a speculative engine's step emits a LIST of
                    # tokens per stream — the budget counts tokens,
                    # not steps)
                    drain_tokens += emitted_token_count(emitted)
                    if (self.drain_token_budget is not None
                            and drain_tokens >= self.drain_token_budget):
                        for rid, h in list(self._active.items()):
                            self.engine.cancel(rid)
                            h.status = "preempted"
                            preempted.append(rid)
                        self._active.clear()
        finally:
            # end the drain span HERE so an exception mid-drain (a
            # refused admit, a stepped-on engine) still writes the
            # record and pops the thread-local span stack — a leaked
            # open span would orphan every later span under a phantom
            # parent id (Span.end is idempotent)
            if drain_span is not None:
                drain_span.end(drain_tokens=drain_tokens,
                               preempted=len(preempted))
            if own_guard:
                guard.__exit__(None, None, None)

        report = {
            "completed": completed,
            "preempted": preempted,
            "drained": drained,
            "drain_tokens": drain_tokens,
        }
        if drained:
            counters.bump("preempt_drains")
            if exit_on_preempt:
                raise SystemExit(0)
        return report
