"""Typed runtime metric registry: counters, gauges, fixed-bucket
histograms (counterpart of singa_tpu/observability/metrics.py, copied
as the port's own host-only code).

- **Counter**: a monotonically increasing integer.
- **Gauge**: a last-written value (slot occupancy, KV block-pool
  utilization, the prefix-cache hit rate).
- **Histogram**: fixed upper-bound buckets (Prometheus exposition
  semantics: cumulative `le` counts + sum + count) PLUS a bounded
  reservoir of recent raw samples so `percentile()` answers exactly;
  `percentile(samples, q)` at module level is the ONE percentile
  implementation, the reference's serve p50/p95 math.

Two cost tiers, by contract:

- **Event-driven** updates go straight through the registry: a lock
  and a dict op, unconditionally.
- **Hot-path** updates (the per-decode-step serving gauges) are gated
  by `enabled()`, OFF by default (env ``SINGA_METRICS=1`` or `enable()`
  turns them on), and the instrumented call sites cache their metric
  handles, so the disabled path is one boolean read.

Every metric name the port emits, and every key of
`resilience.counters.SUPERVISOR_KEYS`, is declared in the `HELP`
inventory below with a help string; the names and their meaning are the
reference's, and the inventory holds every name the reference declares.
`singa_tpu_torch.observability.lint` fails on an emitted name missing
here; `observability.export` renders the help text on the Prometheus
page.

Stdlib-only and thread-safe (one registry lock).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "DEFAULT",
           "counter", "gauge", "histogram", "percentile", "snapshot",
           "reset", "enabled", "enable", "disable", "HELP",
           "HOT_PATH_ENV", "DEFAULT_MS_BUCKETS"]

#: env var that turns the HOT-PATH instrumentation on at import (the
#: per-decode-step serving gauges); event-driven metrics record
#: regardless
HOT_PATH_ENV = "SINGA_METRICS"

#: default fixed buckets for millisecond latency histograms (upper
#: bounds; +Inf is implicit) — spans sub-ms decode steps on a card
#: through multi-second first steps
DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 10000.0)

#: raw samples a Histogram retains for exact percentile answers (a
#: long-lived serve process reports percentiles over the most recent
#: window)
_RESERVOIR = 4096


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """The ONE percentile implementation (nearest-rank by truncation):
    index ``min(n - 1, int(n * q))`` of the sorted samples — exactly
    the reference's serve p50/p95 math. None on an empty sample
    set."""
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(len(s) * float(q)))]


class Counter:
    """Monotonically-increasing integer (inc returns the new value).
    `touched` distinguishes "set to 0" from "never seen", so
    `snapshot()` leaves never-touched counters out (missing means
    zero)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", *, _lock=None):
        self.name = name
        self.help = help
        self._lock = _lock or threading.Lock()
        self._value = 0
        self.touched = False

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += int(n)
            self.touched = True
            return self._value

    def set_(self, v: int) -> None:
        """Absorb an externally-carried count: SET, not bumped, so a
        re-import does not double-count."""
        with self._lock:
            self._value = int(v)
            self.touched = True

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0
            self.touched = False


class Gauge:
    """A last-written float (set wins; inc/dec for level tracking)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", *, _lock=None):
        self.name = name
        self.help = help
        self._lock = _lock or threading.Lock()
        self._value = 0.0
        self.touched = False

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self.touched = True

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += float(n)
            self.touched = True

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self.touched = False


class Histogram:
    """Fixed-bucket histogram (Prometheus exposition semantics) plus a
    bounded reservoir of recent raw samples for exact percentiles via
    the shared `percentile()`."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS, *,
                 _lock=None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket "
                             f"upper bound (+Inf is implicit)")
        self._lock = _lock or threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._samples: deque = deque(maxlen=_RESERVOIR)
        self.touched = False

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._samples.append(v)
            self.touched = True

    def percentile(self, q: float) -> Optional[float]:
        """Exact percentile over the retained sample window (the same
        math as module `percentile`)."""
        with self._lock:
            samples = list(self._samples)
        return percentile(samples, q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(le_upper_bound, cumulative_count)] incl. the +Inf bucket —
        the Prometheus `_bucket{le=...}` series."""
        with self._lock:
            out = []
            acc = 0
            for b, c in zip(self.buckets, self._counts):
                acc += c
                out.append((b, acc))
            out.append((float("inf"), acc + self._counts[-1]))
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._samples.clear()
            self.touched = False


class Registry:
    """Thread-safe name -> metric map with get-or-create accessors.
    Type conflicts (a gauge where a counter lives) refuse loudly —
    silently returning the wrong type would corrupt both series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help or HELP.get(name, ""), **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is already registered as a "
                    f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def all_metrics(self) -> List[object]:
        with self._lock:
            return sorted(self._metrics.values(),
                          key=lambda m: m.name)

    def counter_snapshot(self) -> Dict[str, int]:
        """Every TOUCHED counter's value (missing == 0 to readers; a
        never-bumped registered counter stays out)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.value for m in metrics
                if isinstance(m, Counter) and m.touched}

    def reset(self) -> None:
        """Zero every metric (test isolation)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


#: the process-global registry the instrumented hot paths share
DEFAULT = Registry()


def counter(name: str, help: str = "") -> Counter:
    return DEFAULT.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return DEFAULT.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS
              ) -> Histogram:
    return DEFAULT.histogram(name, help, buckets=buckets)


def snapshot() -> Dict[str, int]:
    return DEFAULT.counter_snapshot()


def reset() -> None:
    DEFAULT.reset()


# -- the hot-path gate --------------------------------------------------------

_hot = os.environ.get(HOT_PATH_ENV, "") not in ("", "0")


def enabled() -> bool:
    """Whether HOT-PATH instrumentation records (per-step timing,
    per-decode-step gauges). One module-global boolean read — the
    disabled fast path."""
    return _hot


def enable() -> None:
    global _hot
    _hot = True


def disable() -> None:
    global _hot
    _hot = False


# -- the declared metric inventory --------------------------------------------
#
# Name -> help string for every metric singa_tpu_torch/ emits (the
# training step's and the serving stack's, as the reference names them),
# and for the fault counters the resilience layer declares: the
# metric-name lint (observability/lint.py) fails on any emitted literal
# or counters.SUPERVISOR_KEYS entry missing here.

HELP: Dict[str, str] = {
    # -- fault counters (the counters.py registry) ----------------------
    "retries": "transient errors absorbed by the bounded retry policy",
    "restores": "checkpoint restores performed",
    "saves": "checkpoints committed",
    "restarts": "supervised in-process restarts after a crash/hang",
    "rollbacks": "loss-spike rollbacks to the last good checkpoint",
    "hangs": "watchdog-detected step deadline expiries",
    "reshapes": "supervisor mesh reshapes after fleet probes",
    "babysit": "1 when the process runs under the resilience "
               "babysitter",
    "restarts_external": "hard-kill respawns by the out-of-process "
                         "babysitter",
    "stale_kills": "process trees SIGKILLed on a stale heartbeat",
    "fleet": "1 when the process runs under a babysitter-fleet agent",
    "fleet_epochs": "job-level epoch-bump restarts the fleet leader "
                    "ordered",
    "elections": "fleet lease elections held (>1 means leader "
                 "failover)",
    # -- storage / async checkpointing / re-grow ------------------------
    "ckpt_async_saves": "background checkpoint commits completed by "
                        "save(async_=True) (the snapshot never "
                        "stalls the step path)",
    "ckpt_async_failures": "background checkpoint commits that "
                           "raised — the previous checkpoint stays "
                           "committed; surfaced via "
                           "AsyncSaveHandle.result()",
    "fleet_readmit": "returned hosts the fleet leader re-admitted "
                     "into the roster (epoch bump at the grown "
                     "world)",
    # -- the training step (graph.GraphStep) ----------------------------
    "graph_compiles": "GraphStep builds: CUDA Graph captures of the "
                      "training step on the card, new input signatures "
                      "on the CPU",
    "train_steps": "training steps dispatched through GraphStep "
                   "(hot-path gated)",
    "train_step_ms": "per-step host wall time of a GraphStep call, ms "
                     "(a replay returns once it is enqueued; the first "
                     "samples of a signature include its uncaptured "
                     "first step and its capture)",
    "serve_steps": "decode steps (speculative: propose+verify "
                   "rounds) executed",
    "serve_tokens": "tokens emitted by the serving engine "
                    "(hot-path gated; engine.tokens_emitted is the "
                    "ungated lifetime total)",
    "serve_token_ms": "per-token decode latency, ms (a step's wall "
                      "normalized by tokens/streams — the reference's "
                      "bench p50/p95 math)",
    "serve_slots_active": "decode slots occupied by live streams",
    "serve_slot_occupancy": "fraction of decode slots occupied "
                            "(0..1)",
    "serve_kv_blocks_used": "KV-cache pool blocks held by in-flight "
                            "requests",
    "serve_kv_utilization": "fraction of allocatable KV pool blocks "
                            "held (0..1 — blocks.py capacity math)",
    "serve_prefill_wait_ms": "wall time from a prefill ticket's async "
                             "dispatch to its boundary admit, ms",
    "serve_prefix_hits": "admissions that mapped at least one shared "
                         "full-block prompt prefix from the prefix "
                         "cache (suffix-only prefill ran)",
    "serve_prefix_misses": "admissions that found no resident prefix "
                           "(full prefill ran)",
    "serve_shared_pages": "page-table pages currently backed by a "
                          "shared block beyond its first reference "
                          "(pages costing zero pool blocks)",
    "serve_prefix_hit_rate": "lifetime prefix-cache hit rate over "
                             "admissions (0..1)",
    "serve_cow_copies": "copy-on-write block copies performed before "
                        "a decode write could touch a shared block "
                        "(0 in the normal append-only flow)",
    "serve_prefill_chunks": "block-wide prefill passes run through "
                            "advance_prefill (the chunked scheduler's "
                            "unit of preemptible prefill work)",
    # -- the frontend, speculative engine and scheduler ---------------
    "preempt_drains": "SIGTERM drains the serving frontend absorbed",
    "spec_accepts": "draft tokens the speculative verify step "
                    "accepted",
    "spec_rejects": "draft tokens the speculative verify step "
                    "rejected",
    "serve_queue_depth": "requests queued at the frontend awaiting "
                         "admission",
    "serve_acceptance_rate": "speculative decoding lifetime "
                             "acceptance rate (0..1)",
    "serve_prefill_queue": "streams reserved with a prefill still in "
                           "flight (dispatched, not yet admitted at a "
                           "step boundary)",
    "serve_sched_lane_picks": "requests dispatched by the chunked "
                              "scheduler's lane/fairness pick "
                              "(ChunkedScheduler.lane_picks splits "
                              "the count per lane host-side)",
    "serve_tenant_deficit": "max served-token spread between any two "
                            "tenants at the last dispatch (bounded "
                            "under deficit round-robin; grows "
                            "unbounded under FIFO — the fairness "
                            "number)",
    "serve_decode_stall_ms": "wall time a step boundary (admission + "
                             "prefill work) spent while decode had "
                             "active streams waiting, ms — the decode "
                             "gap chunked prefill exists to bound",
    # -- the replica router --------------------------------------------
    "router_dispatches": "requests routed from the fleet queue onto a "
                         "replica (one per dispatch attempt, so a "
                         "failover re-route counts again)",
    "router_affinity_hits": "dispatches whose chosen replica held "
                            "shadow-resident prefix blocks for the "
                            "prompt (the router expected a warm "
                            "prefill there)",
    "router_rebalances": "dispatches where a MORE prefix-affine "
                         "replica existed but lost on load — the "
                         "router traded a warm prefix for balance",
    "router_replica_deaths": "replicas drained from the routing table "
                             "(pump raised, heartbeat went stale, or "
                             "an operator kill_replica)",
    "router_requeued": "in-flight streams re-queued at the head of "
                       "the fleet queue by a replica death, awaiting "
                       "re-route (token identity holds: the retry "
                       "restarts from the prompt and the handle's "
                       "high-water mark dedups delivery)",
}
