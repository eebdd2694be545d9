"""Observability for the port: spans, counters and the goodput report,
copied from tpudl.obs (stdlib only). The exporter, SLO monitor, request
log, metering plane and the report and fleet views are not ported yet
(ROADMAP queue A)."""

from tpudl_torch.obs.counters import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    percentile,
    registry,
)
from tpudl_torch.obs.goodput import (  # noqa: F401
    classify,
    classify_by_process,
    format_goodput,
)
from tpudl_torch.obs.spans import (  # noqa: F401
    SpanRecorder,
    active_recorder,
    disable,
    enable,
)
