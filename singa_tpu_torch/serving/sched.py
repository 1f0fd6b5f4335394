"""Scheduler policy for the serving frontend (counterpart of
singa_tpu/serving/sched.py, copied whole with the port's imports;
host-only). From the reference's docstring (round 21):

The round-18 overlap loop has exactly one admission policy baked in:
decode-first, one ticket in flight, whole prompts in one dispatch. A
single long prompt therefore stalls every active stream for the full
prefill — the tail-latency cliff chunked prefill exists to remove.
`ChunkedScheduler` is the policy object `Frontend(sched=...)` runs
instead:

- **Chunk budget**: the in-flight prefill advances at most
  `chunk_budget` block_size-wide passes per step boundary
  (`ServingEngine.advance_prefill`), so active streams pay a bounded,
  configurable stall per decode step no matter how long the arriving
  prompt is.
- **Priority lanes**: each `Request.priority` is "high", "normal" or
  "background" (unknown labels schedule as "normal"). The pick is
  strict-then-weighted: "high" dispatches strictly before "normal"
  (the latency lane — a sustained high load MAY starve normal, by
  design), while the favored pair as a class shares with "background"
  by weighted credits (default 4:1) — so background makes progress
  under ANY sustained high/normal load: at least 1 dispatch in every
  `sum(lane_weights)` is background's. That is the starvation bound
  tests/test_serving_sched.py pins.
- **Per-tenant fairness**: within the chosen lane, deficit round-robin
  over `Request.tenant` — the tenant with the LEAST service received
  (dispatch-time cost: prompt + max_new tokens) goes first, so one
  tenant's prompt storm queues behind everyone else's trickle instead
  of starving it. `None` tenants share one anonymous account.
- **Prefix affinity** (round 20 compose): within the chosen tenant's
  candidates, a request whose prefix is resident dispatches first
  (stable otherwise) — the same wasting-asset argument as
  `Frontend._prefix_sort_queue`, applied inside the fairness order
  rather than across it.

`order()` is PURE — it simulates the pick sequence on copies of the
credit/deficit state so the frontend can cut the dispatched prefix at
engine capacity; `commit()` then accounts each handle actually
dispatched. Accounting depends only on the committed sequence (never
on who else was queued), so the replay is exact by construction.

Telemetry: `serve_sched_lane_picks` counts committed dispatches,
`serve_tenant_deficit` gauges the max served-token spread between
tenants (the fairness number: bounded under DRR, unbounded under
FIFO). Host-side probes: `lane_picks`, `tenant_deficit()`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from singa_tpu_torch.observability import metrics as obs_metrics

__all__ = ["ChunkedScheduler", "LANES"]

#: recognized priority lanes, strongest first; unknown labels
#: schedule as "normal"
LANES = ("high", "normal", "background")


class ChunkedScheduler:
    """The chunked-prefill admission policy `Frontend(sched=)` runs:
    bounded prefill-chunk budgets per turn, strict-then-weighted
    priority lanes, deficit-round-robin tenant fairness (module
    docstring has the full semantics)."""

    def __init__(self, chunk_budget: int = 2,
                 lane_weights: Tuple[int, int] = (4, 1),
                 accounts: Dict[object, int] = None):
        if chunk_budget < 1:
            raise ValueError("chunk_budget must be >= 1 (0 would never "
                             "advance an in-flight prefill)")
        wn, wb = int(lane_weights[0]), int(lane_weights[1])
        if wn < 1 or wb < 1:
            raise ValueError(
                "lane weights must be >= 1 — a zero weight starves "
                "that class by construction, which is what the "
                "weighted pick exists to prevent")
        self.chunk_budget = int(chunk_budget)
        self.lane_weights = (wn, wb)
        #: weighted credits: "normal" is the favored CLASS (high +
        #: normal — strict between them), "background" the yielder
        self._credit = {"normal": wn, "background": wb}
        #: tokens of service each tenant has received at dispatch
        #: (cost = prompt + max_new); deficit = leader - self. Pass
        #: `accounts=` to SHARE one ledger across schedulers — the
        #: round-22 ReplicaRouter hands every replica's scheduler the
        #: same dict, lifting deficit-round-robin from per-engine to
        #: fleet-wide (exact, because `_charge` depends only on the
        #: committed request, never on which engine served it)
        self._served: Dict[object, int] = (
            accounts if accounts is not None else {})
        #: lifetime committed dispatches per lane (host probe)
        self.lane_picks = {lane: 0 for lane in LANES}
        self._picks_counter = None
        self._deficit_gauge = None

    # -- classification ----------------------------------------------------

    @staticmethod
    def _lane(req) -> str:
        p = getattr(req, "priority", "normal")
        return p if p in LANES else "normal"

    @staticmethod
    def _cost(req) -> int:
        return int(len(req.prompt)) + int(req.max_new)

    def tenant_deficit(self) -> int:
        """Max served-token spread between any two tenants — 0 with
        one (or no) tenant; bounded by one request's cost plus a
        quantum under DRR ordering."""
        if not self._served:
            return 0
        vals = self._served.values()
        return max(vals) - min(vals)

    # -- the pick ----------------------------------------------------------

    def order(self, handles: Sequence, engine=None) -> List:
        """Dispatch order for `handles` under the CURRENT credit and
        deficit state. Pure: simulates on copies — the frontend cuts
        this at engine capacity and `commit`s only the dispatched
        prefix, so un-dispatched picks never move the real state."""
        credit = dict(self._credit)
        served = dict(self._served)
        remaining = list(handles)
        out: List = []
        while remaining:
            h = self._choose(remaining, served, credit, engine)
            remaining.remove(h)
            self._charge(h.request, served, credit)
            out.append(h)
        return out

    def commit(self, handle) -> None:
        """Account one handle the frontend actually dispatched: move
        the real credits and the tenant's served-token account, bump
        the lane-pick telemetry."""
        req = handle.request
        self._charge(req, self._served, self._credit)
        self.lane_picks[self._lane(req)] += 1
        if obs_metrics.enabled():
            c = self._picks_counter
            if c is None:
                c = self._picks_counter = obs_metrics.counter(
                    "serve_sched_lane_picks")
                self._deficit_gauge = obs_metrics.gauge(
                    "serve_tenant_deficit")
            c.inc()
            self._deficit_gauge.set(float(self.tenant_deficit()))

    def _charge(self, req, served: Dict, credit: Dict) -> None:
        # accounting depends ONLY on the picked request — that is what
        # makes commit() an exact replay of order()'s prefix
        cl = ("background" if self._lane(req) == "background"
              else "normal")
        if credit["normal"] <= 0 and credit["background"] <= 0:
            credit["normal"], credit["background"] = self.lane_weights
        credit[cl] -= 1
        t = getattr(req, "tenant", None)
        served[t] = served.get(t, 0) + self._cost(req)

    def _choose(self, handles: Sequence, served: Dict, credit: Dict,
                engine) -> object:
        lanes: Dict[str, List] = {}
        for h in handles:
            lanes.setdefault(self._lane(h.request), []).append(h)
        favored = lanes.get("high") or lanes.get("normal")
        background = lanes.get("background")
        if favored and background:
            cn, cb = credit["normal"], credit["background"]
            if cn <= 0 and cb <= 0:   # judge on refreshed credits
                cn, cb = self.lane_weights
            cands = favored if cn > 0 else background
        else:
            cands = favored or background
        return self._choose_in_lane(cands, served, engine)

    def _choose_in_lane(self, handles: List, served: Dict,
                        engine) -> object:
        by_tenant: Dict[object, List] = {}
        for h in handles:
            by_tenant.setdefault(
                getattr(h.request, "tenant", None), []).append(h)
        # least-served tenant first; ties break by first appearance
        # (dict order = arrival order) so equal tenants round-robin
        tenant = min(by_tenant, key=lambda t: served.get(t, 0))
        cands = by_tenant[tenant]
        if (engine is not None
                and getattr(engine, "prefix_cache", False)
                and len(cands) > 1):
            for h in cands:   # warm first, stable within each class
                if engine.prefix_match_tokens(h.request) > 0:
                    return h
        return cands[0]
