"""Span tracing on monotonic clocks, written as append-only JSONL
(counterpart of singa_tpu/observability/trace.py, copied as the port's
own host-only code). The serving engine opens a `serve.prefill` span
around each prefill dispatch::

    with span("serve.prefill", batch=2, cached_tokens=0):
        ...

Record format (one JSON object per line)::

    {"name": ..., "sid": "<pid>-<seq>", "parent": sid-or-null,
     "pid": n, "ts": wall-clock-at-start, "dur_s": monotonic-duration,
     "attrs": {...}}

Durations come from `time.monotonic` (never wall-clock arithmetic —
the fleet's clock-skew lesson); `ts` is wall time, carried only for
cross-file ordering and operator readability. An `event()` is a
zero-duration span. Parent ids come from a thread-local span stack, so
nesting is lexical per thread; a process's ROOT spans adopt the
``SINGA_TRACE_PARENT`` env id when a parent process exported one (the
spawn path of a supervising process).

File routing: ``SINGA_TRACE_FILE`` names the base path. The process
that called `enable(path)` (which also exports the env var) writes the
base file; any process that merely INHERITED the env var writes
``<base>.<pid>`` NEXT TO it (one
file per process: concurrent writers never interleave partial lines).
`read_events(base)` merges the whole family back into one ts-ordered
list for assertions and offline analysis.

Cost contract: with no trace file configured, `span()` returns a
shared no-op context manager after one boolean/env check. Enabled writes are
fsync-LIGHT: one buffered `write` + `flush` per record, no fsync (a
trace is diagnostics, not a commit protocol).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["span", "begin_span", "event", "enable", "disable",
           "enabled", "current_span_id", "trace_path", "read_events",
           "find_spans", "Span", "TRACE_ENV", "OWNER_ENV",
           "PARENT_ENV"]

#: base path of the event log; presence turns tracing ON (env-routed:
#: babysat/fleet children inherit it and land their files next to the
#: agent's)
TRACE_ENV = "SINGA_TRACE_FILE"
#: pid that owns the BASE file (set by `enable`); every other pid
#: derives ``<base>.<pid>``
OWNER_ENV = "SINGA_TRACE_OWNER"
#: span id a parent process exported for a child's root spans (set by
#: the babysitter/fleet spawn path)
PARENT_ENV = "SINGA_TRACE_PARENT"

_lock = threading.Lock()
_seq = itertools.count(1)
_tls = threading.local()
_explicit_path: Optional[str] = None
_file = None
_file_pid: Optional[int] = None


def enabled() -> bool:
    """One env-dict lookup when not explicitly enabled — the disabled
    fast path."""
    return _explicit_path is not None or TRACE_ENV in os.environ


def enable(path: str) -> None:
    """Route this process's spans to `path` and export the env
    contract so children land theirs next to it."""
    global _explicit_path
    disable()
    _explicit_path = str(path)
    os.environ[TRACE_ENV] = _explicit_path
    os.environ[OWNER_ENV] = str(os.getpid())


def disable() -> None:
    """Stop tracing and drop the env contract (test isolation)."""
    global _explicit_path, _file, _file_pid
    with _lock:
        if _file is not None:
            try:
                _file.close()
            except OSError:
                pass
        _file = None
        _file_pid = None
    _explicit_path = None
    os.environ.pop(TRACE_ENV, None)
    os.environ.pop(OWNER_ENV, None)


def trace_path() -> Optional[str]:
    """The file THIS process writes: the base path for the enabling
    process, ``<base>.<pid>`` for one that inherited the env var."""
    base = _explicit_path or os.environ.get(TRACE_ENV)
    if not base:
        return None
    if _explicit_path is not None or \
            os.environ.get(OWNER_ENV) == str(os.getpid()):
        return base
    return f"{base}.{os.getpid()}"


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span_id() -> Optional[str]:
    st = _stack()
    if st:
        return st[-1]
    return os.environ.get(PARENT_ENV) or None


def _write(rec: Dict[str, Any]) -> None:
    global _file, _file_pid
    path = trace_path()
    if path is None:
        return
    line = json.dumps(rec, default=str) + "\n"
    with _lock:
        pid = os.getpid()
        if _file is None or _file_pid != pid:
            try:
                _file = open(path, "a", encoding="utf-8")
            except OSError:
                return  # diagnostics must never crash the run
            _file_pid = pid
        try:
            _file.write(line)
            _file.flush()  # fsync-light: flush, never fsync
        except (OSError, ValueError):
            pass


class Span:
    """One timed span; created by `span()`/`begin_span()`. `end()` is
    idempotent and pops this span off the stack of the thread that
    OPENED it, wherever it sits — the span keeps a reference to its
    owning stack, so a non-lexical `begin_span` consumer may end it
    out of order or from another thread (a watchdog, an HTTP handler)
    without stranding the sid as the origin thread's phantom parent."""

    __slots__ = ("name", "sid", "parent", "attrs", "_t0", "_ts",
                 "_done", "_stk")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = str(name)
        self.sid = f"{os.getpid()}-{next(_seq)}"
        self.parent = current_span_id()
        self.attrs = attrs
        self._t0 = time.monotonic()
        self._ts = time.time()
        self._done = False
        self._stk = _stack()
        self._stk.append(self.sid)

    def end(self, **extra: Any) -> None:
        if self._done:
            return
        self._done = True
        dur = time.monotonic() - self._t0
        try:
            # the OWNING thread's stack (captured at begin), not the
            # ending thread's — list.remove is atomic under the GIL
            self._stk.remove(self.sid)
        except ValueError:
            pass  # defensive: sid already gone
        if extra:
            self.attrs.update(extra)
        _write({"name": self.name, "sid": self.sid,
                "parent": self.parent, "pid": os.getpid(),
                "ts": round(self._ts, 6), "dur_s": round(dur, 6),
                "attrs": self.attrs})

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()


class _NullSpan:
    """The disabled fast path: one shared instance, every method a
    no-op."""

    __slots__ = ()
    sid = None
    parent = None

    def end(self, **extra: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, **attrs: Any):
    """Context manager timing a lexical scope (no-op when disabled)::

        with span("decode_step", slot_count=n):
            ...
    """
    if not enabled():
        return _NULL
    return Span(name, attrs)


def begin_span(name: str, **attrs: Any):
    """A span whose scope is NOT lexical (a drain that starts at a
    signal and ends at loop exit): the caller must `end()` it."""
    if not enabled():
        return _NULL
    return Span(name, attrs)


def event(name: str, **attrs: Any) -> None:
    """A zero-duration record (a detection, a skip, an election),
    parented under the current span."""
    if not enabled():
        return
    _write({"name": str(name), "sid": f"{os.getpid()}-{next(_seq)}",
            "parent": current_span_id(), "pid": os.getpid(),
            "ts": round(time.time(), 6), "dur_s": 0.0,
            "attrs": attrs})


# -- reading ------------------------------------------------------------------


def read_events(base_path: str) -> List[Dict[str, Any]]:
    """Parse the event-log FAMILY (the base file plus every
    ``<base>.<pid>`` sibling a child process wrote), merged and
    ts-ordered. Malformed lines (a process killed mid-write) are
    skipped, not fatal — this reads diagnostics, often of runs that
    died on purpose."""
    import glob as _glob

    paths = [base_path] + sorted(_glob.glob(base_path + ".*"))
    events: List[Dict[str, Any]] = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "name" in rec:
                        events.append(rec)
        except OSError:
            continue
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def find_spans(events: List[Dict[str, Any]], name: str
               ) -> List[Dict[str, Any]]:
    """Every record with this span/event name, in ts order."""
    return [e for e in events if e.get("name") == name]
