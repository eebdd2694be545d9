"""Structured per-step metrics: stdlib logging + JSONL sink + TensorBoard.

The port's copy of tpudl.train.logging. Metrics flow through one
`MetricLogger` that fans out to:

- stdlib logging (machine-parseable key=value line per step, on the
  ``tpudl_torch.metrics`` logger);
- a JSONL file (one {"step": ..., metrics...} object per line — the
  greppable artifact for offline analysis; the same lines as tpudl's);
- TensorBoard scalars when ``torch.utils.tensorboard`` imports (guarded:
  without it the logger writes JSONL only);
- the tpudl_torch.obs span stream, when observability is enabled: each
  log call lands as a {"kind": "event", "name": "metrics"} record in the
  run's span JSONL and sets metric_<name> gauges in the counters
  registry.

`MetricLogger.__call__(step, metrics)` matches the `logger=` callback
contract of tpudl_torch.train.fit, so wiring is one argument.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import spans as obs_spans

_log = logging.getLogger("tpudl_torch.metrics")


class MetricLogger:
    """Fan-out metrics sink; every method tolerates absent backends."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        jsonl_name: str = "metrics.jsonl",
        tensorboard: bool = True,
        stdlog: bool = True,
    ):
        self._stdlog = stdlog
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, jsonl_name), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:  # no TB in this environment: JSONL only
                    self._tb = None

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        self.log(step, metrics)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._stdlog:
            rendered = " ".join(f"{k}={v:.6g}" for k, v in scalars.items())
            _log.info("step=%d %s", step, rendered)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        rec = obs_spans.active_recorder()
        if rec is not None:
            # Metrics ride NESTED under one tag: user metric names are
            # arbitrary and must not collide with the record's reserved
            # keys (a metric literally named "step" or "ts" would).
            rec.event("metrics", cat="metrics", step=step, metrics=scalars)
            reg = obs_counters.registry()
            for k, v in scalars.items():
                reg.gauge(f"metric_{k}").set(v)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
