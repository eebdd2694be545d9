"""Observability for the port: spans and counters, copied from
tpudl.obs (stdlib only). The exporter, SLO monitor, request log and
metering plane are not ported yet (ROADMAP queue A)."""

from tpudl_torch.obs.counters import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    percentile,
    registry,
)
from tpudl_torch.obs.spans import (  # noqa: F401
    SpanRecorder,
    active_recorder,
    disable,
    enable,
)
