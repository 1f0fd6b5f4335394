"""Metric exporters: Prometheus text, a JSON snapshot, and an opt-in
stdlib HTTP endpoint (counterpart of singa_tpu/observability/export.py,
the port's own copy over the port's registry).

- `prometheus_text()` renders the registry in Prometheus exposition
  format (counters and gauges plain, histograms as cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count``), touched metrics only.
- `json_snapshot()` is the same truth as one JSON document, plus exact
  p50/p95 per histogram from the shared percentile
  (`metrics.percentile`).
- `MetricsServer` mounts both on a stdlib ``http.server`` (threaded,
  daemonised, port 0 picks a free port): ``/metrics``, ``/healthz``
  and ``/snapshot``. It is opt-in: nothing in the package starts one;
  `examples/serve_gpt.py --metrics-port` does. ``/healthz`` answers 200
  for a caller-supplied judgment whose status is ``"ok"`` and 503 for
  any other status (a draining serve frontend reports ``"draining"``,
  `Frontend.healthz`).
- `heartbeat_healthz` builds that judgment from a heartbeat file by the
  reference fleet's freshness rule: staleness is observed CHANGE of the
  file's (mtime_ns, size) on the observer's monotonic clock, never
  arithmetic on a timestamp written by another clock.

Host-side stdlib only: no torch, no collective, nothing that touches a
captured step. For the same observations, `prometheus_text` and
`json_snapshot` give the reference's text and document byte for byte.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from singa_tpu_torch.observability import metrics as metrics_module
from singa_tpu_torch.observability.metrics import (Counter, Gauge, Histogram,
                                                   Registry)

__all__ = ["prometheus_text", "json_snapshot", "MetricsServer",
           "heartbeat_healthz"]


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(registry: Optional[Registry] = None) -> str:
    """The registry in Prometheus exposition format (touched metrics
    only: an idle process exports a near-empty page, not a wall of
    zeros)."""
    registry = registry or metrics_module.DEFAULT
    lines = []
    for m in registry.all_metrics():
        if not m.touched:
            continue
        lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            for le, c in m.cumulative_buckets():
                lines.append(
                    f'{m.name}_bucket{{le="{_fmt(le)}"}} {c}')
            lines.append(f"{m.name}_sum {_fmt(m.sum)}")
            lines.append(f"{m.name}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def json_snapshot(registry: Optional[Registry] = None) -> Dict:
    """{"counters": {...}, "gauges": {...}, "histograms": {name:
    {"count", "sum", "p50", "p95", "buckets"}}}, touched metrics only;
    percentiles from the one shared implementation."""
    registry = registry or metrics_module.DEFAULT
    out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for m in registry.all_metrics():
        if not m.touched:
            continue
        if isinstance(m, Counter):
            out["counters"][m.name] = m.value
        elif isinstance(m, Gauge):
            out["gauges"][m.name] = m.value
        elif isinstance(m, Histogram):
            out["histograms"][m.name] = {
                "count": m.count,
                "sum": round(m.sum, 6),
                "p50": m.percentile(0.5),
                "p95": m.percentile(0.95),
                "buckets": {_fmt(le): c
                            for le, c in m.cumulative_buckets()},
            }
    return out


def heartbeat_healthz(path: str, stale_after_s: float
                      ) -> Callable[[], Dict]:
    """Health judgment from a heartbeat file, by the fleet's freshness
    rule (resilience/fleet.py `_ChangeTracker`): healthy while its
    fingerprint keeps changing within `stale_after_s` of this process's
    monotonic clock; a file first observed now gets the full window."""
    from singa_tpu_torch.resilience.fleet import _ChangeTracker, _fingerprint

    tracker = _ChangeTracker()
    stale_after_s = float(stale_after_s)

    def healthz() -> Dict:
        age = tracker.age_s("heartbeat", _fingerprint(path))
        return {"status": "ok" if age <= stale_after_s else "stale",
                "heartbeat_age_s": round(age, 3),
                "stale_after_s": stale_after_s}

    return healthz


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    registry: Registry
    healthz_fn: Optional[Callable[[], Dict]]


class _Handler(BaseHTTPRequestHandler):
    server_version = "singa-metrics"

    def log_message(self, fmt, *args):  # a scraper a second must not
        pass                            # fill the serve log

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, prometheus_text(self.server.registry),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            fn = self.server.healthz_fn
            rec = {"status": "ok"} if fn is None else dict(fn())
            code = 200 if rec.get("status") == "ok" else 503
            self._send(code, json.dumps(rec), "application/json")
        elif path == "/snapshot":
            self._send(200, json.dumps(json_snapshot(
                self.server.registry)), "application/json")
        else:
            self._send(404, "metrics endpoints: /metrics /healthz "
                            "/snapshot\n", "text/plain")


class MetricsServer:
    """Opt-in metrics endpoint on a daemon thread::

        srv = MetricsServer(healthz=frontend.healthz)
        port = srv.start()      # port 0 -> a free port, returned
        ...
        srv.stop()

    `healthz` is any zero-argument callable returning a dict with a
    ``"status"`` key ("ok" -> 200, anything else -> 503); None answers
    a constant ok. Binds 127.0.0.1 by default: a wider interface is the
    operator's explicit choice."""

    def __init__(self, *, registry: Optional[Registry] = None,
                 healthz: Optional[Callable[[], Dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._want_port = int(port)
        self._registry = registry or metrics_module.DEFAULT
        self._healthz = healthz
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> int:
        if self._server is not None:
            return int(self.port)
        srv = _Server((self._host, self._want_port), _Handler)
        srv.registry = self._registry
        srv.healthz_fn = self._healthz
        self._server = srv
        self.port = int(srv.server_address[1])
        self._thread = threading.Thread(
            target=srv.serve_forever, name="singa-metrics",
            daemon=True)
        self._thread.start()
        return self.port

    @property
    def url(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None
