"""Runtime telemetry (counterpart of singa_tpu/observability), host-side
only: `metrics` (counters, gauges, fixed-bucket histograms and the one
percentile implementation) and `trace` (span tracing to append-only
JSONL). The exporters and the metric-name lint wait for ROADMAP queue 1
item 18."""

from singa_tpu_torch.observability import metrics  # noqa: F401
from singa_tpu_torch.observability import trace  # noqa: F401

__all__ = ["metrics", "trace"]
