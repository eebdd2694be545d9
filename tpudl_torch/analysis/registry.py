"""Typed accessors for the ``TPUDL_*`` environment knobs the port reads.

The port's counterpart of tpudl.analysis.registry, cut to the accessors
(``env_str`` / ``env_int`` / ``env_float`` / ``env_flag``) and the knobs
this package reads. Knob names are the JAX package's, so one
environment configures either package. Semantics match it: an UNSET or
EMPTY-STRING variable reads as the default, malformed numerics raise ``ValueError`` naming the
variable, flags accept ``1/true/yes/on`` (case-insensitive), and reading
a name that is not declared below raises ``UnknownKnobError``.

Stdlib-only: tpudl_torch.obs imports this module.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_FLAG_TRUTHY = ("1", "true", "yes", "on")

#: name -> one-line doc. The JAX package's table (tpudl.analysis.registry)
#: documents each knob in full.
KNOBS: Dict[str, str] = {
    "TPUDL_OBS_DIR": "Span/counter JSONL output directory; set = recording on.",
    "TPUDL_OBS_HIST_WINDOW": "Histogram rolling-window size.",
    # The live telemetry exporter (tpudl_torch.obs.exporter).
    "TPUDL_OBS_PORT": "Live telemetry exporter port (/metrics, /healthz, "
                      "/snapshot); fit() and ServeSession start it when set; "
                      "0 = an ephemeral port.",
    "TPUDL_OBS_HOST": "Live telemetry exporter bind host; default loopback "
                      "127.0.0.1.",
    "TPUDL_OBS_HEARTBEAT_STALE_S": "Seconds before a running heartbeat reads "
                                   "stale on /healthz; default 60.",
    "TPUDL_PROFILE_DIR": "fit() writes a torch.profiler Chrome trace of its "
                         "profile_window steps here (same as profile_dir=).",
    "TPUDL_PROCESS_ID": "Process index tag on span records.",
    "TPUDL_SERVE_SLOTS": "Default slot count for ServeSession.from_model.",
    "TPUDL_SERVE_QUEUE_DEPTH": "Admission queue capacity.",
    "TPUDL_SERVE_PAGED": "Paged KV cache: per-slot page tables, no "
                         "shared write horizon.",
    "TPUDL_SERVE_PAGE_SIZE": "Paged KV cache: tokens per page (default 16).",
    "TPUDL_SERVE_LORA_RANK": "Multi-tenant adapters: per-tenant rank budget "
                             "(r_max); unset = the largest registered rank.",
    "TPUDL_SERVE_LORA_PAGES": "Multi-tenant adapters: pool size in pages "
                              "(one page = one rank unit; page 0 is the "
                              "zero page); unset = 64 full-rank adapters + 1.",
    "TPUDL_SERVE_LORA_DTYPE": "Multi-tenant adapters: page storage (int8 = "
                              "quantized pages with per-page f32 scales); "
                              "unset = f32 pages.",
    "TPUDL_PREFETCH_DEPTH": "Pin the prefetch queue depth and disable the "
                            "autotuner; unset = autotune.",
    "TPUDL_SERVE_KV_DTYPE": "Paged KV cache page storage (int8 = quantized "
                            "pages with per-(page, row, head) f32 scales; "
                            "requires paged); unset = the model dtype.",
    "TPUDL_SERVE_WEIGHT_DTYPE": "Serving weight quantization of the "
                                "attention/MLP projections (int8 | "
                                "fp8_e4m3); unset = full precision.",
    "TPUDL_SERVE_PREFIX_SHARE": "Radix prefix-sharing KV: COW page sharing "
                                "+ chunked suffix prefill (requires "
                                "paged).",
    "TPUDL_SERVE_SPEC_K": "Speculative-decoding window (draft proposes k "
                          "tokens per verify call); 0/unset = off.",
    # Training precision (tpudl_torch.train.precision,
    # tpudl_torch.ops.fp8_dot); the defaults are tpudl's.
    "TPUDL_TRAIN_PRECISION": "Mixed-precision training policy preset (f32 | "
                             "bf16 | fp8) for policy_from_env; unset = no "
                             "policy.",
    "TPUDL_FP8_AMAX_WINDOW": "fp8 delayed-scaling amax-history ring length "
                             "per tensor site; default 16.",
    "TPUDL_LOSS_SCALE_INIT": "Dynamic loss-scale starting value (a power of "
                             "two); default 32768.",
    "TPUDL_LOSS_SCALE_GROWTH_INTERVAL": "Consecutive finite steps before the "
                                        "dynamic loss scale doubles (capped "
                                        "at 2^24); default 2000.",
    # Fault tolerance and its fault injection (tpudl_torch.ft).
    "TPUDL_FT_GRACE_S": "Preemption grace window in seconds (SIGTERM -> "
                        "emergency checkpoint -> hard-exit watchdog); "
                        "default 15.",
    "TPUDL_FT_MAX_RESTARTS": "Supervisor restart retry budget; default 3.",
    "TPUDL_FT_BACKOFF_S": "Initial supervisor restart backoff; default 1.0.",
    "TPUDL_FT_MAX_BACKOFF_S": "Supervisor restart backoff cap; default 30.",
    "TPUDL_CHAOS_KILL_AT_STEP": "Fault injection: SIGKILL the matching rank "
                                "at step N.",
    "TPUDL_CHAOS_KILL_RANK": "Fault injection: rank to kill (unset = any).",
    "TPUDL_CHAOS_ONCE_DIR": "Fault injection: marker directory making each "
                            "rank's kill fire once across supervised "
                            "restarts.",
    "TPUDL_CHAOS_IO_DELAY_S": "Fault injection: added delay per checkpoint "
                              "write (slow-disk simulation); default 0.",
    # Serving fault injection (tpudl_torch.serve.chaos).
    "TPUDL_SERVE_CHAOS_KILL_STEP": "Serving chaos: raise ChaosKill in "
                                   "Engine.step at decode step N.",
    "TPUDL_SERVE_CHAOS_PREEMPT_STEP": "Serving chaos: raise ChaosPreempt in "
                                      "Engine.step at decode step N (its "
                                      "caller exports the seated requests).",
    "TPUDL_SERVE_CHAOS_FREEZE_STEP": "Serving chaos: freeze Engine.step at "
                                     "decode step N for "
                                     "TPUDL_SERVE_CHAOS_FREEZE_S seconds.",
    "TPUDL_SERVE_CHAOS_FREEZE_S": "Serving chaos: freeze duration; default "
                                  "1.0.",
    "TPUDL_SERVE_CHAOS_ONCE_DIR": "Serving chaos: marker directory making "
                                  "each injected fault fire once across "
                                  "every engine of the process.",
    "TPUDL_SERVE_CHAOS_FLIP_MIGRATION": "Serving chaos: flip one bit of "
                                        "every migration payload an engine "
                                        "receives (the crc must catch it).",
}


class UnknownKnobError(KeyError):
    """A knob read that is not declared in ``KNOBS``."""


def env_raw(name: str) -> Optional[str]:
    """The raw string value, or None when unset OR empty."""
    if name not in KNOBS:
        raise UnknownKnobError(
            f"{name!r} is not a declared knob — add it to "
            f"tpudl_torch.analysis.registry.KNOBS"
        )
    raw = os.environ.get(name)
    return raw if raw else None


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    raw = env_raw(name)
    return raw if raw is not None else default


def env_int(
    name: str,
    default: Optional[int] = None,
    min_value: Optional[int] = None,
) -> Optional[int]:
    raw = env_raw(name)
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    if min_value is not None and value < min_value:
        raise ValueError(f"{name} must be >= {min_value}, got {value}")
    return value


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    raw = env_raw(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


def env_flag(name: str) -> bool:
    raw = env_raw(name)
    return raw is not None and raw.strip().lower() in _FLAG_TRUTHY
