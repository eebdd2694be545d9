#!/usr/bin/env python3
"""Chip smoke test of tpudl_torch, the PyTorch/CUDA port, on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result):

1. card    — name and power limit (nvidia-smi);
2. build   — compile every kernel under tpudl_torch/ops/csrc with nvcc;
3. kernels — each Hopper kernel against its plain PyTorch version at the
             shapes the serving path gives it, bf16 and f32, with times
             (CUDA-graph replay, so launch overhead is excluded) beside
             the bound and, where one exists, one PyTorch call's time;
4. tiny    — a small input against the CPU reference: LLAMA_TINY in f32
             with the kernels on the card and with the plain versions on
             the CPU (the path the CPU tests hold against tpudl): prefill
             logits, the whole cache and the served tokens agree;
5. slice   — Llama-3-8B at full width and depth (random weights from a
             seeded torch.Generator, max_seq_len 512) served through
             ServeSession.from_model with 4 slots: 8 ragged greedy
             requests and 1 sampled one. Every result must be ok, and the
             kernels' launch counters must show exactly 65 RMSNorm and 32
             SwiGLU launches per prefill and per decode step;
6. parity  — the same requests served with fused_ops=False (the plain
             versions, same weights): the kernel path may part from the
             plain one only at a near-tie (teacher-forced logit margin
             under an f32 oracle within the bf16 error band), and its
             logits must be as close to the oracle's as the plain path's.

The last three lines are the ``{"kernels": [...]}`` record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: Kernel vs plain tolerance (rtol = atol). f32: only the summation order
#: differs. bf16: the kernel adds the residual in f32 and normalizes the
#: unrounded sum, the plain version adds in bf16 — up to one bf16 rounding
#: step (tpudl's own band, tests/test_fused_norms.py:148-160).
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 0.05}

#: Whole-path tolerances (see parity_phase). Where the kernel and plain
#: paths pick different tokens, the f32 oracle may prefer the plain token
#: by at most ATOL_BANDS x the plain bf16 path's own max logit error: the
#: kernel path chose the other token, so the oracle margin is at most
#: 2 x the kernel path's error, which the second bound holds within 1.25 x
#: the plain path's. A fixed band like tpudl's 0.05 (tests/test_serve.py:655,
#: a tiny f32 model) is below the bf16 noise of 32 random-weight layers:
#: two plain bf16 computations of the same tokens already disagree by
#: ~0.1 logit there.
KERNEL_ERR_RATIO = 1.25
ATOL_BANDS = 2 * KERNEL_ERR_RATIO

PROMPT_LEN = 128
NUM_SLOTS = 4
MAX_SEQ_LEN = 512


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, calls: int = 50, reps: int = 9) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, median."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def eager_ms(fn, calls: int = 200, reps: int = 5) -> float:
    """Time per ``fn()`` call issued eagerly from Python (launch and
    wrapper overhead included, as the serving loop pays it), median."""
    import torch

    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def library_ms(fn):
    """``graph_ms`` of one PyTorch call, or None where that call does not
    take these inputs (printed, not fatal: it is a yardstick only)."""
    try:
        return graph_ms(fn)
    except (RuntimeError, TypeError) as e:
        print(f"library call not timed: {type(e).__name__}: {e}")
        return None


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(out, ref, tol):
    """(max abs error, max relative error, within tolerance)."""
    import torch

    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool(torch.all(d <= tol + tol * r))
    rel = float((d / r.clamp_min(1e-30)).max())
    return float(d.max()), rel, ok


def kernel_phase(torch, F):
    from tpudl_torch.ops.mlp_fused import swiglu, swiglu_ref
    from tpudl_torch.ops.norms import rms_norm, rms_norm_ref

    g = torch.Generator(device="cuda").manual_seed(1234)
    cases = {"rms_norm_fwd": [], "swiglu_fwd": []}
    hidden, inter = 4096, 14336
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tol = KERNEL_TOL[dname]
        e = torch.finfo(dtype).bits // 8
        for n in (NUM_SLOTS, PROMPT_LEN):
            x = torch.randn(n, hidden, generator=g, device="cuda").to(dtype)
            r = torch.randn(n, hidden, generator=g, device="cuda").to(dtype)
            scale = 1 + 0.1 * torch.randn(hidden, generator=g, device="cuda")
            for residual in (False, True):
                res = r if residual else None
                out = rms_norm(x, scale, res, impl="fused")
                ref = rms_norm_ref(x, scale, res)
                if residual:
                    e_y = errors(out[0], ref[0], tol)
                    e_s = errors(out[1], ref[1], tol)
                    err = (max(e_y[0], e_s[0]), max(e_y[1], e_s[1]),
                           e_y[2] and e_s[2])
                else:
                    err = errors(out, ref, tol)
                elems = n * hidden
                nbytes = elems * e * (4 if residual else 2) + hidden * 4
                ops = elems * (5 if residual else 4)
                lib = None
                if not residual:
                    lib = library_ms(
                        lambda: F.rms_norm(x, (hidden,), scale, 1e-5))
                cases["rms_norm_fwd"].append({
                    "shape": [n, hidden], "dtype": dname,
                    "variant": "residual+sum" if residual else "plain",
                    "max_abs_err": err[0], "max_rel_err": err[1], "tol": tol,
                    "ok": err[2],
                    "ms": graph_ms(lambda: rms_norm(x, scale, res, impl="fused")),
                    "plain_ms": graph_ms(lambda: rms_norm_ref(x, scale, res)),
                    "eager_ms": eager_ms(lambda: rms_norm(x, scale, res, impl="fused")),
                    "plain_eager_ms": eager_ms(lambda: rms_norm_ref(x, scale, res)),
                    "library_ms": lib,
                    "bound": bound(nbytes, ops),
                })
        for n in (NUM_SLOTS, PROMPT_LEN):
            gate = (2 * torch.randn(n, inter, generator=g, device="cuda")).to(dtype)
            up = torch.randn(n, inter, generator=g, device="cuda").to(dtype)
            err = errors(swiglu(gate, up, impl="fused"), swiglu_ref(gate, up), tol)
            elems = n * inter
            cases["swiglu_fwd"].append({
                "shape": [n, inter], "dtype": dname, "variant": "plain",
                "max_abs_err": err[0], "max_rel_err": err[1], "tol": tol,
                "ok": err[2],
                "ms": graph_ms(lambda: swiglu(gate, up, impl="fused")),
                "plain_ms": graph_ms(lambda: swiglu_ref(gate, up)),
                "eager_ms": eager_ms(lambda: swiglu(gate, up, impl="fused")),
                "plain_eager_ms": eager_ms(lambda: swiglu_ref(gate, up)),
                "library_ms": None,
                "bound": bound(3 * elems * e, 6 * elems),
            })
    bad = []
    for name, rows in cases.items():
        for c in rows:
            print(
                f"kernel {name} {c['variant']} {c['shape']} {c['dtype']}: "
                f"max_abs_err={c['max_abs_err']:.3e} "
                f"max_rel_err={c['max_rel_err']:.3e} tol={c['tol']} "
                f"{'ok' if c['ok'] else 'OUTSIDE TOLERANCE'} "
                f"kernel_ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                f"eager: kernel {c['eager_ms']:.5f} plain {c['plain_eager_ms']:.5f} "
                f"library_ms={c['library_ms'] if c['library_ms'] is None else round(c['library_ms'], 5)} "
                f"bound_us={c['bound'][0] * 1e3:.3f} ({c['bound'][1]})"
            )
            if not c["ok"]:
                bad.append(f"{name} {c['variant']} {c['shape']} {c['dtype']}")
    if bad:
        fail(f"kernel outside tolerance: {bad}")
    return cases


def requests_for(Request, vocab):
    import numpy as np

    rng = np.random.default_rng(0)
    greedy = [
        Request(
            f"g{i}",
            rng.integers(1, vocab, size=int(rng.integers(16, PROMPT_LEN + 1))).tolist(),
            max_new_tokens=int(rng.integers(16, 65)),
        )
        for i in range(8)
    ]
    sampled = Request(
        "s0", rng.integers(1, vocab, size=40).tolist(), max_new_tokens=24,
        temperature=0.8, seed=7,
    )
    return greedy, sampled


def pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def tiny_reference_phase(torch):
    """A small input against the CPU reference: LLAMA_TINY in f32 with the
    kernels on the card, and the same weights through the plain versions
    on the CPU — the path tests/test_torch_*.py hold against tpudl. Prefill
    logits and the whole cache agree at 1e-4 (TF32 off), and the served
    greedy tokens may part only at a near-tie (margin 1e-3 under the CPU
    model)."""
    import numpy as np

    from tpudl_torch.models.generate import prefill_fn
    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, init_params
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.serve import Request, ServeSession
    from tpudl_torch.serve.api import assert_tokens_match

    cfg = LLAMA_TINY(dtype=torch.float32, max_seq_len=96)
    params_cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    model_cpu = LlamaForCausalLM(cfg, device="meta")
    model_gpu = LlamaForCausalLM(cfg, device="meta")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, size=(2, 8))
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    before = (rms_norm.launches, swiglu.launches)
    lg, cg = prefill_fn(model_gpu)(params_gpu, ids, mask)
    lc, cc = prefill_fn(model_cpu)(params_cpu, ids, mask)
    if (rms_norm.launches, swiglu.launches) == before:
        fail("the tiny model on the card launched no kernel")
    worst = float((lg.cpu() - lc).abs().max())
    ok = torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name, layer in cc["model"].items():
        for key in ("k", "v"):
            g = cg["model"][name]["attention"][key].cpu()
            ok = ok and torch.allclose(g, layer["attention"][key],
                                       rtol=1e-4, atol=1e-4)
    if not ok:
        fail(f"tiny f32 model: kernel path on the card disagrees with the "
             f"CPU plain path (max logit difference {worst:.3e})")

    def requests():
        r = np.random.default_rng(1)
        return [Request(f"t{i}", r.integers(1, cfg.vocab_size,
                                            size=int(r.integers(2, 9))).tolist(),
                        max_new_tokens=int(r.integers(4, 20)))
                for i in range(8)]

    def serve(model, params):
        return ServeSession.from_model(model, params, prompt_len=8,
                                       num_slots=4).serve(requests())

    got, want = serve(model_gpu, params_gpu), serve(model_cpu, params_cpu)
    same = 0
    for req in requests():
        g = np.asarray(got[req.request_id].tokens)
        w = np.asarray(want[req.request_id].tokens)
        same += int(np.array_equal(g, w))
        assert_tokens_match(model_cpu, params_cpu, req, g, w, 1e-3)
    print(f"tiny: f32 LLAMA_TINY, kernels on the card vs plain on the CPU: "
          f"prefill logits max |diff| {worst:.3e} (tol 1e-4), cache ok, "
          f"{same}/8 served requests token-identical")


def slice_phase(torch, card):
    from tpudl_torch.models.llama import (
        LLAMA3_8B,
        LlamaForCausalLM,
        init_params,
    )
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.serve import Request, ServeSession

    cfg = LLAMA3_8B(dtype=torch.bfloat16, max_seq_len=MAX_SEQ_LEN)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="meta")
    params = init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"slice: Llama-3-8B, {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, "
          f"init {time.perf_counter() - t0:.1f} s")

    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                            num_slots=NUM_SLOTS).serve(
        [Request("warm", [1, 2, 3], max_new_tokens=2)]
    )
    greedy, sampled = requests_for(Request, cfg.vocab_size)
    session = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                      num_slots=NUM_SLOTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rms_norm.launches = 0
    swiglu.launches = 0
    t0 = time.perf_counter()
    results = session.serve(greedy + [sampled])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rms_norm_fwd": rms_norm.launches,
                "swiglu_fwd": swiglu.launches}
    eng = session.engine
    calls = eng.num_prefills + eng.num_decode_steps
    print(f"slice: {len(results)} requests, {eng.num_prefills} prefills, "
          f"{eng.num_decode_steps} decode steps, launches {launches}")
    bad = [rid for rid, r in results.items() if not r.ok]
    if bad:
        fail(f"requests not ok: {[(rid, results[rid].finish_reason) for rid in bad]}")
    for req in greedy + [sampled]:
        toks = results[req.request_id].tokens
        if len(toks) != req.max_new_tokens or not all(
            0 <= t < cfg.vocab_size for t in toks
        ):
            fail(f"request {req.request_id}: {len(toks)} tokens, expected "
                 f"{req.max_new_tokens} in [0, {cfg.vocab_size})")
    want = {"rms_norm_fwd": 65 * calls, "swiglu_fwd": 32 * calls}
    if launches != want:
        fail(f"kernel launches {launches} != expected {want} "
             f"(65 RMSNorm and 32 SwiGLU per prefill and decode step)")
    ttft = [r.ttft_s * 1e3 for r in results.values()]
    tpot = [r.tpot_s * 1e3 for r in results.values() if r.tpot_s is not None]
    tokens = sum(len(r.tokens) for r in results.values())
    print(f"slice metrics ({card}): TTFT p50 {pct(ttft, 50):.2f} ms, p90 "
          f"{pct(ttft, 90):.2f} ms; TPOT p50 {pct(tpot, 50):.3f} ms, p90 "
          f"{pct(tpot, 90):.3f} ms; {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; {eng.num_decode_steps} decode "
          f"steps ({wall / max(1, eng.num_decode_steps) * 1e3:.3f} ms per "
          f"step incl. prefills); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy = profile_decode(torch, model, params, Request)
    return model, params, greedy + [sampled], results, launches, {
        "ttft_p50_ms": pct(ttft, 50), "tpot_p50_ms": pct(tpot, 50),
        "tokens_per_s": tokens / wall, "decode_steps": eng.num_decode_steps,
        "prefills": eng.num_prefills, "decode_device_busy_share": busy,
    }


def profile_decode(torch, model, params, Request):
    """Device busy share and the top kernels and host ops over a steady
    window of decode steps (4 slots busy): the window's wall time is
    taken without the profiler (which slows the host), the device time
    from a second, profiled window of as many steps. Returns the busy
    share. Diagnostic: a profiler failure prints 'not measured', returns
    None and does not fail the run."""
    from tpudl_torch.serve import ServeSession

    session = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                      num_slots=NUM_SLOTS)
    for i in range(NUM_SLOTS):
        session.submit(Request(f"p{i}", list(range(1 + i, 101 + i)),
                               max_new_tokens=40))
    eng = session.engine
    for _ in range(4):
        eng.step()
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [
            k for k in prof.key_averages()
            if getattr(k, "device_type", None) == torch.autograd.DeviceType.CUDA
        ]
        busy_us = sum(k.self_device_time_total for k in kernels)
        if busy_us <= 0:
            raise RuntimeError("no device time in the trace")
        print(f"profile: {steps} decode steps, wall {wall_us / steps:.1f} "
              f"us/step ({prof_wall_us / steps:.1f} under the profiler), "
              f"device busy {busy_us / steps:.1f} us/step "
              f"({100 * busy_us / wall_us:.1f}% of the unprofiled step, "
              f"idle {100 * (1 - busy_us / wall_us):.1f}%), "
              f"{sum(k.count for k in kernels) / steps:.0f} kernels/step")
        for k in sorted(kernels, key=lambda k: -k.self_device_time_total)[:10]:
            print(f"profile:   device {k.self_device_time_total / steps:9.1f} "
                  f"us/step {k.count / steps:6.1f}x  {k.key[:90]}")
        host = [
            k for k in prof.key_averages()
            if getattr(k, "device_type", None) == torch.autograd.DeviceType.CPU
        ]
        for k in sorted(host, key=lambda k: -k.self_cpu_time_total)[:12]:
            print(f"profile:   host {k.self_cpu_time_total / steps:9.1f} "
                  f"us/step {k.count / steps:6.1f}x  {k.key[:90]}")
    except Exception as e:  # diagnostic only
        print(f"profile: not measured ({type(e).__name__}: {e})")
        busy_us = None
    session.collect()
    return None if busy_us is None else busy_us / wall_us


def all_logits(torch, model, params, ids):
    """[S, V] f32 logits of the decode-mode forward over ``ids`` (a
    teacher-forced prefix), through ``model`` bound to ``params``."""
    from tpudl_torch.models.llama import bind_params

    with torch.no_grad():
        bind_params(model, params)
        x = torch.as_tensor(ids, device="cuda")[None, :]
        logits, _ = model(x, torch.ones_like(x), decode=True)
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    return logits[0]


def parity_phase(torch, model, params, requests, fused_results):
    """The kernel path against the plain path and an f32 oracle.

    The greedy requests are served again with fused_ops=False (same
    weights, same requests, so the same schedule). Where the two token
    streams part, the prompt and the plain stream up to that step are
    teacher-forced through an f32 plain model (the oracle, TF32 off), and
    assert_tokens_match's margin contract holds the kernel path's choice:
    the oracle may prefer the plain path's token by at most ATOL_BANDS
    times the plain bf16 path's own max logit error against the oracle
    over that prefix — a near-tie inside bf16 noise, not wrong values.
    Over every teacher-forced prefix, the kernel path's mean logit error
    against the oracle must stay within KERNEL_ERR_RATIO of the plain
    path's."""
    import numpy as np

    from tpudl_torch.models.llama import LLAMA3_8B, LlamaForCausalLM
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.serve import Request, ServeSession
    from tpudl_torch.serve.api import assert_tokens_match

    plain = LlamaForCausalLM(
        LLAMA3_8B(dtype=torch.bfloat16, max_seq_len=MAX_SEQ_LEN,
                  fused_ops=False), device="meta")
    session = ServeSession.from_model(plain, params, prompt_len=PROMPT_LEN,
                                      num_slots=NUM_SLOTS)
    before = (rms_norm.launches, swiglu.launches)
    # Same requests (the sampled one included), so the schedule — and with
    # it every cache write position — is the kernel run's.
    plain_results = session.serve([Request(**r.__dict__) for r in requests])
    if (rms_norm.launches, swiglu.launches) != before:
        fail("the fused_ops=False path launched a kernel")
    del session
    oracle = LlamaForCausalLM(
        LLAMA3_8B(dtype=torch.float32, max_seq_len=MAX_SEQ_LEN,
                  fused_ops=False), device="meta")
    params32 = {k: v.float() for k, v in params.items()}
    greedy = [r for r in requests if r.temperature == 0.0]
    same = 0
    sums = {"kernel": 0.0, "plain": 0.0}
    count = 0
    for req in greedy:
        got = np.asarray(fused_results[req.request_id].tokens)
        want = np.asarray(plain_results[req.request_id].tokens)
        diff = np.nonzero(got != want)[0]
        t = int(diff[0]) if diff.size else len(want) - 1
        n0 = len(req.input_ids)
        ids = np.concatenate([np.asarray(req.input_ids), want[:t]])
        ref = all_logits(torch, oracle, params32, ids)[n0 - 1:]
        err_k = (all_logits(torch, model, params, ids)[n0 - 1:] - ref).abs()
        err_p = (all_logits(torch, plain, params, ids)[n0 - 1:] - ref).abs()
        sums["kernel"] += float(err_k.sum())
        sums["plain"] += float(err_p.sum())
        count += err_k.numel()
        if diff.size == 0:
            same += 1
            continue
        eps_plain = float(err_p.max())
        atol = ATOL_BANDS * eps_plain
        margin = float(ref[-1, int(want[t])] - ref[-1, int(got[t])])
        print(f"parity: {req.request_id} parts from the plain path at step "
              f"{t}/{len(want)}: oracle margin of the plain token {want[t]} "
              f"over the kernel path's {got[t]} = {margin:.4f}; plain bf16 "
              f"max logit error {eps_plain:.4f} (kernel path "
              f"{float(err_k.max()):.4f}), atol {atol:.4f}")
        assert_tokens_match(oracle, params32, req, got, want, atol)
    mean_k, mean_p = sums["kernel"] / count, sums["plain"] / count
    print(f"parity: {same}/{len(greedy)} greedy requests token-identical to "
          f"the plain path; mean |logit - f32 oracle| over {count} logits: "
          f"kernel path {mean_k:.5f}, plain path {mean_p:.5f}")
    if mean_k > KERNEL_ERR_RATIO * mean_p:
        fail(f"kernel path mean logit error {mean_k:.5f} > "
             f"{KERNEL_ERR_RATIO} x the plain path's {mean_p:.5f}")
    del params32
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    import tpudl_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(
            tpudl_torch.__file__))) != here:
        fail(f"tpudl_torch imported from {tpudl_torch.__file__}, not from "
             f"this checkout")
    import torch.nn.functional as F

    from tpudl_torch.ops import _build

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name, info in built.items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in info["ptxas"].splitlines()
                       if "Used " in line})
        print(f"build: {name}: {info['seconds']:.2f} s, ptxas {regs}")

    cases = kernel_phase(torch, F)
    tiny_reference_phase(torch)
    model, params, requests, results, launches, metrics = slice_phase(
        torch, card)
    parity_phase(torch, model, params, requests, results)

    sources = {"rms_norm_fwd": ("tpudl_torch/ops/csrc/norms.cu",
                                "tpudl/ops/norms.py:199"),
               "swiglu_fwd": ("tpudl_torch/ops/csrc/mlp_fused.cu",
                              "tpudl/ops/mlp_fused.py:197")}
    kernels = []
    for name, rows in cases.items():
        # The headline case: the decode shape in bf16 (the path's dtype),
        # without a residual (the variant the library call computes).
        head = next(c for c in rows if c["shape"][0] == NUM_SLOTS
                    and c["dtype"] == "bfloat16" and c["variant"] == "plain")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"],
            "cases": [{k: v for k, v in c.items() if k != "bound"}
                      | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                      for c in rows],
        })
    print(json.dumps({"slice": metrics, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
