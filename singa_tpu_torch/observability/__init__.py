"""Runtime telemetry (counterpart of singa_tpu/observability), host-side
only: `metrics` (counters, gauges, fixed-bucket histograms and the one
percentile implementation), `trace` (span tracing to append-only JSONL),
`export` (Prometheus text, a JSON snapshot and the opt-in `/metrics`,
`/healthz`, `/snapshot` endpoint) and `lint` (every emitted metric name
declared with a help string; ``python -m
singa_tpu_torch.observability.lint``).

`export` and `lint` load at first access (``observability.export``, or
``from singa_tpu_torch.observability import export``), so running the
lint as ``python -m`` does not find it imported already."""

import importlib

from singa_tpu_torch.observability import metrics  # noqa: F401
from singa_tpu_torch.observability import trace  # noqa: F401

__all__ = ["export", "lint", "metrics", "trace"]


def __getattr__(name):
    if name in ("export", "lint"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
