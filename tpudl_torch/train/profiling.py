"""Device-trace analysis for fit's profiler hook: the port's counterpart
of tpudl.train.profiling.

tpudl_torch.train.fit records steps [a, b) with ``torch.profiler`` (CPU
activity, and CUDA activity on the card) when ``profile_dir`` or
TPUDL_PROFILE_DIR is set, and writes a Chrome trace there
(``<host>_<pid>.<ms>.pt.trace.json``, the name torch's TensorBoard
handler gives). Each profiled step is wrapped in a ``tpudl_step#<i>``
annotation. This module reads the trace back without a UI:

    state, m, info = fit(step, state, batches, rng,
                         profile_dir="/tmp/prof", profile_window=(2, 5))
    from tpudl_torch.train.profiling import summarize_trace, format_summary
    print(format_summary(summarize_trace("/tmp/prof")))

or ``python -m tpudl_torch.train.profiling /tmp/prof --steps 3``.

The summary gives the device time a step by kernel kind
(``KERNEL_KINDS``, the one classifier the repo's profile lines use), the
busy and idle share of the profiled window, and the top kernels. Where a
key means what tpudl's does it keeps tpudl's name (``trace_file``,
``total_ms_per_step``, ``num_events``, ``by_category``, ``top_ops``).
tpudl's TFLOP/s and GB/s columns come from XLA's per-op cost fields,
which a CUDA trace does not carry: they are left out, not estimated.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from typing import Optional

#: Device kernel kinds, by a substring of the kernel's name (first match).
KERNEL_KINDS = (
    # Ahead of the GEMMs: "quant_gemm_tma_kernel" holds "gemm".
    ("this repo's kernels", ("norm_fwd_", "norm_bwd_", "norm_colsum_kernel",
                             "column_sum_kernel", "bias_gelu_", "swiglu_",
                             "softmax_dropout_", "xent_", "flash_fwd_kernel",
                             "flash_dq_kernel", "flash_dq_tma_kernel",
                             "flash_dkv_kernel",
                             "whole_fwd_kernel", "whole_dq_kernel",
                             "whole_dkv_kernel", "whole_dq_tma_kernel",
                             "attn_dkv_tma_kernel",
                             "seg_lora_cluster_kernel", "quant_gemv_kernel",
                             "quant_gemv_mma_kernel",
                             "quant_gemm_kernel", "quant_gemm_tma_kernel",
                             "quant_split_sum_kernel")),
    # Ahead of the convolutions (cuDNN's own batch norm kernels live in its
    # namespace) and of the GEMMs (cuDNN's convolutions are implicit GEMMs).
    ("batch norm", ("batch_norm", "batchnorm", "BatchNorm", "bn_fw", "bn_bw",
                    "welford", "Welford")),
    ("convolutions (cuDNN)", ("implicit_gemm", "fprop", "dgrad", "wgrad",
                              "cudnn", "conv2d", "convolution",
                              "nchwToNhwc", "nhwcToNchw")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "Gemm", "cutlass", "splitKreduce")),
    ("softmax", ("softmax",)),
    ("random bits", ("distribution", "philox")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("casts and copies", ("copy_kernel", "direct_copy")),
    ("other elementwise", ("elementwise", "Functor", "where")),
)

#: Chrome-trace categories of device activity in a torch.profiler trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: The annotation fit wraps each profiled step in.
STEP_ANNOTATION = "tpudl_step#"


def device_kind(name: str) -> str:
    """The ``KERNEL_KINDS`` kind of a device kernel's name ("other" when
    no substring matches)."""
    for kind, keys in KERNEL_KINDS:
        if any(key in name for key in keys):
            return kind
    return "other"


def kernel_stem(name: str) -> str:
    """A kernel's name without its template arguments or signature."""
    stem = re.search(r"(\w+)[<(]", name)
    return stem.group(1) if stem else name[:40]


def trace_path(trace_dir: str, host: str, pid: int, ms: int) -> str:
    """Where fit writes a trace: torch's TensorBoard-handler file name."""
    return os.path.join(trace_dir, f"{host}_{pid}.{ms}.pt.trace.json")


def _find_trace_file(trace_dir: str) -> str:
    if os.path.isfile(trace_dir):
        return trace_dir
    hits = []
    for pat in ("*.pt.trace.json", "*.pt.trace.json.gz"):
        hits += glob.glob(os.path.join(trace_dir, pat))
    if not hits:
        raise FileNotFoundError(
            f"no *.pt.trace.json under {trace_dir} (fit(profile_dir=) "
            f"writes one per profiled window)")
    return max(hits, key=os.path.getmtime)  # the newest window


def _load(path: str) -> dict:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def summarize_trace(trace_dir: str, steps: Optional[int] = None,
                    top_n: int = 10) -> dict:
    """Read a torch.profiler Chrome trace (a file, or the newest under
    ``trace_dir``) into device time a step by kind and top kernels.

    ``steps`` divides every duration; None counts the trace's
    ``tpudl_step#`` annotations (1 when it has none). The window is from
    the first step annotation's start to the end of the last step
    annotation or device event, whichever is later (without annotations:
    the extent of the device events). ``busy`` is the union of the
    device events' intervals inside it, so kernels that overlap on two
    streams count once; ``total_ms_per_step`` sums their durations.

    Returns ``{"trace_file", "steps", "total_ms_per_step", "num_events",
    "kernels_per_step", "window_ms_per_step", "busy_ms_per_step",
    "busy_share", "idle_share", "by_category": {kind: {"ms_per_step",
    "share"}}, "top_ops": [{"name", "category", "ms_per_step",
    "calls_per_step"}], "ours": {stem: ms_per_step}}`` (``ours``: this
    repo's kernels by name stem)."""
    path = _find_trace_file(trace_dir)
    events = _load(path).get("traceEvents", [])
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if not dev:
        raise ValueError(
            f"no device events ({'/'.join(DEVICE_CATEGORIES)}) in {path}: "
            f"was the window profiled on the card?")
    marks = [e for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(STEP_ANNOTATION)]
    if steps is None:
        steps = max(1, len(marks))
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev_lo = min(float(e["ts"]) for e in dev)
    dev_hi = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    if marks:
        lo = min(float(e["ts"]) for e in marks)
        hi = max(dev_hi, max(float(e["ts"]) + float(e["dur"])
                             for e in marks))
    else:
        lo, hi = dev_lo, dev_hi
    window = hi - lo
    busy = _union_us(
        (max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
        for e in dev if float(e["ts"]) + float(e["dur"]) > lo
        and float(e["ts"]) < hi)

    by_kind = collections.defaultdict(float)
    per_op = collections.defaultdict(lambda: [0.0, 0])
    ours = collections.defaultdict(float)
    for e in dev:
        name, dur = str(e.get("name", "?")), float(e["dur"])
        kind = device_kind(name)
        by_kind[kind] += dur
        per_op[name][0] += dur
        per_op[name][1] += 1
        if kind == "this repo's kernels":
            ours[kernel_stem(name)] += dur
    total = sum(by_kind.values())
    return {
        "trace_file": path,
        "steps": steps,
        "total_ms_per_step": total / steps / 1e3,
        "num_events": len(dev),
        "kernels_per_step": len(dev) / steps,
        "window_ms_per_step": window / steps / 1e3,
        "busy_ms_per_step": busy / steps / 1e3,
        "busy_share": busy / window if window > 0 else 0.0,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "by_category": {
            kind: {"ms_per_step": t / steps / 1e3,
                   "share": t / total if total else 0.0}
            for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_ops": [
            {"name": name, "category": device_kind(name),
             "ms_per_step": t / steps / 1e3, "calls_per_step": n / steps}
            for name, (t, n) in sorted(per_op.items(),
                                       key=lambda kv: -kv[1][0])[:top_n]],
        "ours": {stem: t / steps / 1e3
                 for stem, t in sorted(ours.items(), key=lambda kv: -kv[1])},
    }


def format_summary(summary: dict) -> str:
    """Human-readable tables for a ``summarize_trace`` result."""
    lines = [
        f"trace: {summary['trace_file']}",
        f"total: {summary['total_ms_per_step']:.3f} ms/step of device time "
        f"({summary['kernels_per_step']:.0f} device events/step over "
        f"{summary['steps']} steps); window "
        f"{summary['window_ms_per_step']:.3f} ms/step, busy "
        f"{summary['busy_ms_per_step']:.3f} "
        f"({100 * summary['busy_share']:.1f}%), idle "
        f"{100 * summary['idle_share']:.1f}%",
        f"{'kind':30} {'ms/step':>9} {'share':>6}",
    ]
    for kind, r in summary["by_category"].items():
        lines.append(f"{kind:30} {r['ms_per_step']:9.3f} "
                     f"{100 * r['share']:5.1f}%")
    if summary.get("ours"):
        lines.append("this repo's kernels: " + ", ".join(
            f"{stem} {ms * 1e3:.1f} us" for stem, ms in
            summary["ours"].items()))
    lines.append("top ops:")
    for r in summary["top_ops"]:
        lines.append(f"  {r['ms_per_step']:8.3f} ms {r['calls_per_step']:6.1f}x"
                     f"  {r['category']:22} {r['name'][:90]}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Summarize a torch.profiler Chrome trace written by "
        "fit(profile_dir=): device time a step by kind, busy and idle "
        "share, top kernels")
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps in the profiled window (default: the "
                    "trace's step annotations)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    out = summarize_trace(args.trace_dir, steps=args.steps, top_n=args.top)
    print(json.dumps(out) if args.json else format_summary(out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
