"""Observability for the port, copied from tpudl.obs (stdlib only):
spans, counters, the goodput report, the live telemetry exporter
(``/metrics``, ``/healthz``, ``/snapshot``, activated by
``TPUDL_OBS_PORT``) and the SLO burn-rate monitor. Still to come: the
request log and the metering plane (ROADMAP queue A item 16(b)), and the
report and fleet views."""

from tpudl_torch.obs.counters import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    percentile,
    registry,
)
from tpudl_torch.obs.exporter import (  # noqa: F401
    Heartbeat,
    ObsExporter,
    active_exporter,
    format_labels,
    health_snapshot,
    maybe_start_from_env,
    register_health_source,
    render_prometheus,
    start_exporter,
    stop_exporter,
    unregister_health_source,
)
from tpudl_torch.obs.goodput import (  # noqa: F401
    classify,
    classify_by_process,
    format_goodput,
)
from tpudl_torch.obs.slo import Objective, SloMonitor  # noqa: F401
from tpudl_torch.obs.spans import (  # noqa: F401
    SpanRecorder,
    active_recorder,
    disable,
    enable,
)
