"""Time kernels of two checkouts in turns on one card: A, B, B, A. The
serving kernels (RMSNorm with and without its residual, SwiGLU, the
norm forwards and SwiGLU at the training steps' shapes: RMSNorm with
row statistics at the Llama LoRA step's [8192, 4096], plain and
residual+sum, SwiGLU at its [8192, 14336], LayerNorm with statistics at
BERT-base's [32768, 768] with and without its residual; the segmented LoRA at the decode step's q_proj and down_proj and a 128-token
prefill, with its held-contract wall per eager call), the attention
backward rows (the whole-row backward, dQ and dK/dV launches, at
BERT-base's seq-512 step, with and without dropout; flash dQ and dK/dV
at the Llama-3-8B LoRA step, and flash dQ with dropout at BERT-base's
heads) and softmax_dropout forward and backward (the BERT-base seq-128
step's call with its padding mask and dropout 0.1, the same shape causal
without dropout, Skv 127, the unaligned path, causal with dropout, and
the step's shape in f32 with and without mask and dropout), the norm
backward at every shape of PERF.md's row 2 (BERT-base's and BERT-large's
LayerNorm calls, the Llama LoRA step's RMSNorm calls, frozen scales
included), the quantized product at the prefill's and BERT's shapes
(int8 and e4m3 weights, bf16 x) and its decode GEMV (the four Llama-3-8B
decode shapes at 4 rows, and 8 and 16 rows at [*, 4096] -> 4096, each
timed L2-warm and L2-cold).

    python3 -m tpudl_torch.tools.kernel_ab OTHER_CHECKOUT [ROUNDS] [GROUPS]

runs from the root of checkout B (this one) against checkout A (for
example the parent commit, unpacked with ``git archive`` into a
gitignored directory). GROUPS, comma-separated, limits the cases to
some of ``norms`` (the norm forwards and SwiGLU), ``attention``,
``seg_lora``, ``softmax``, ``norm_bwd``, ``quant`` and ``quant_gemv``
(default: all). Each turn is a fresh process that builds that
checkout's kernels and times every case by CUDA-graph replay with that
checkout's ``chip_smoke.graph_ms``; a ``quant_gemv`` case's "cold" time
replays calls that rotate over copies of the weight totalling more than
twice the 50 MB L2. ROUNDS (default 1) repeats the
A, B, B, A sequence; the report gives each case's median and range over
each checkout's turns and the ratio of the medians, B / A. Comparing
within one call keeps the card, its power limit and its neighbours the
same.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

#: (op, rows, width, residual) at the serving path's shapes, bf16 and f32.
CASES = [("rms_norm", n, 4096, res) for n in (4, 128) for res in (False, True)]
CASES += [("swiglu", n, 14336, False) for n in (4, 128)]
#: (op, rows, width, residual, dtypes): the training steps' calls, the
#: norms with the row statistics autograd saves (and without the sum
#: BERT never reads); RMSNorm's residual variant writes the sum.
TRAIN_CASES = [("rms_norm", 8192, 4096, res, ["bfloat16"])
               for res in (False, True)]
TRAIN_CASES += [("swiglu", 8192, 14336, False, ["bfloat16"])]
TRAIN_CASES += [("layer_norm", 32768, 768, True, ["bfloat16"]),
                ("layer_norm", 32768, 768, False, ["bfloat16", "float32"])]
#: (op, [b, sq, skv, h, d], causal, rate): the attention backward rows in
#: bf16 at their step shapes (PERF.md rows 13 and 11); the whole-row
#: rows take chip_smoke's padding mask (lengths uniform in [S/2, S]).
ATTENTION = [("whole_bwd", [32, 512, 512, 12, 64], False, rate)
             for rate in (0.1, 0.0)]
ATTENTION += [("flash_dq", [4, 2048, 2048, 32, 128], True, 0.0),
              ("flash_dq", [8, 1024, 1024, 12, 64], False, 0.1),
              ("flash_dkv", [4, 2048, 2048, 32, 128], True, 0.0)]
#: ([b, h, sq, skv], dtype, masking, rate): softmax_dropout (PERF.md rows
#: 14 and 15) in bf16, and in f32 as chip_smoke.py's fused_kernel_phase
#: holds it; the padding mask takes lengths uniform in [Skv/2, Skv].
SOFTMAX = [([256, 12, 128, 128], "bfloat16", "padding", 0.1),
           ([256, 12, 128, 128], "bfloat16", "causal", 0.0),
           ([64, 12, 127, 127], "bfloat16", "causal", 0.1),
           ([256, 12, 128, 128], "float32", "padding", 0.1),
           ([256, 12, 128, 128], "float32", "none", 0.0)]
#: (x shape, out): the segmented LoRA at the tenant slice's shapes, bf16 x
#: and base, four slots at rank 16 on f32 pages.
SEG_LORA = [([4, 4096], 4096), ([4, 14336], 4096), ([1, 128, 4096], 4096)]
#: (kind, rows, width, dtype, residual, sum gradient, scale sums): the norm
#: backward's calls (PERF.md row 2): BERT-base's encoder and embeddings,
#: BERT-large's, the Llama LoRA step's RMSNorm with its residual and the
#: sum's gradient (frozen scales: the LoRA path), plain, and at a
#: 2048-row shape.
NORM_BWD = [("layer", 32768, 768, "bfloat16", True, False, True),
            ("layer", 32768, 768, "bfloat16", False, False, True),
            ("layer", 32768, 768, "float32", False, False, True),
            ("layer", 8192, 1024, "bfloat16", True, False, True),
            ("layer", 8192, 1024, "bfloat16", False, False, True),
            ("layer", 8192, 1024, "float32", False, False, True),
            ("rms", 8192, 4096, "bfloat16", True, True, True),
            ("rms", 8192, 4096, "bfloat16", True, True, False),
            ("rms", 8192, 4096, "bfloat16", False, False, True),
            ("rms", 2048, 4096, "bfloat16", True, True, True)]
#: ([M, K], N): the quantized product's tiled shapes (PERF.md): a
#: Llama-3-8B prefill's projections at 128 tokens and BERT-base's at
#: 256 x 128 rows.
QUANT = [([128, 4096], 4096), ([128, 4096], 1024), ([128, 4096], 14336),
         ([128, 14336], 4096), ([32768, 768], 768), ([32768, 768], 3072),
         ([32768, 3072], 768)]
#: ([M, K], N): the decode GEMV (PERF.md's quant_dot table): the
#: Llama-3-8B decode step's projections at its 4 slots, and 8 and 16 rows.
QUANT_GEMV = [([4, 4096], 4096), ([4, 4096], 1024), ([4, 4096], 14336),
              ([4, 14336], 4096), ([8, 4096], 4096), ([16, 4096], 4096)]

_TURN = r"""
import json, sys, torch
import chip_smoke
from tpudl_torch.ops import flash_attention as fa
from tpudl_torch.ops import fused_attention as fu
from tpudl_torch.ops import keep_mask
from tpudl_torch.ops.mlp_fused import swiglu
from tpudl_torch.ops.norms import (_norm_bwd_cuda, _norm_fwd_cuda,
                                   norm_stats_ref, rms_norm)
from tpudl_torch.ops import quant_dot as qd
from tpudl_torch.quant.quantize import quantize_leaf
from tpudl_torch.ops import segmented_lora as sl
from tpudl_torch.ops import softmax_dropout as sd
g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for op, n, h, res in json.loads(sys.argv[1]):
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(n, h, generator=g, device="cuda").to(dtype)
        r = torch.randn(n, h, generator=g, device="cuda").to(dtype)
        s = torch.ones(h, device="cuda")
        if op == "rms_norm":
            fn = lambda: rms_norm(x, s, r if res else None, impl="fused")
        else:
            fn = lambda: swiglu(x, r, impl="fused")
        key = f"{op} [{n}, {h}] {str(dtype)[6:]}{' residual' if res else ''}"
        out[key] = chip_smoke.graph_ms(fn)
for op, n, h, res, dtypes in json.loads(sys.argv[5]):
    for dtype in (getattr(torch, d) for d in dtypes):
        x = torch.randn(n, h, generator=g, device="cuda").to(dtype)
        r = torch.randn(n, h, generator=g, device="cuda").to(dtype)
        s = 1 + 0.1 * torch.randn(h, generator=g, device="cuda")
        if op == "swiglu":
            fn = lambda: swiglu(x, r, impl="fused")
        elif op == "rms_norm":
            fn = lambda: _norm_fwd_cuda("rms", x, s, None, r if res else None,
                                        1e-5, res, stats=True)
        else:
            fn = lambda: _norm_fwd_cuda("layer", x, s, s, r if res else None,
                                        1e-12, False, stats=True)
        stats = "" if op == "swiglu" else " stats"
        key = (f"{op} [{n}, {h}] {str(dtype)[6:]}{stats}"
               f"{(' residual+sum' if op == 'rms_norm' else ' residual') if res else ''}")
        out[key] = chip_smoke.graph_ms(fn, calls=20, reps=5)
        del x, r, fn
        torch.cuda.empty_cache()
for op, (b, sq, skv, h, d), causal, rate in json.loads(sys.argv[2]):
    q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, skv, h, d, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kvmask = torch.ones(b, skv, dtype=torch.bool, device="cuda")
    masking = op == "whole_bwd" or rate > 0.0
    if masking:
        lengths = torch.randint(skv // 2, skv + 1, (b,), generator=g,
                                device="cuda")
        kvmask = torch.arange(skv, device="cuda")[None, :] < lengths[:, None]
    seed = keep_mask.draw_seed(g) if rate else keep_mask.zero_seed("cuda")
    args = (kvmask, seed, causal, d ** -0.5, rate)
    if op == "whole_bwd":
        o, lse = fu.fused_attention_fwd(q, k, v, *args, impl="fused")
        fn = lambda: fu.fused_attention_bwd(q, k, v, kvmask, seed, do, lse,
                                            causal, d ** -0.5, rate,
                                            impl="fused")
    else:
        o, lse = fa.flash_attention_fwd(q, k, v, *args, impl="fused")
        ops = fa.bwd_operands(q, k, v, kvmask, seed, do, lse,
                              fa.backward_delta(do, o))
        # A checkout whose dQ launch hands its keep bits to dK/dV takes
        # the scratch; the dK/dV launch reads what a dQ call wrote.
        kw = ({"bits": fa.keep_scratch(q, k, rate)}
              if hasattr(fa, "keep_scratch") else {})
        fa.launch_dq(ops, *args, **kw)
        launch = fa.launch_dq if op == "flash_dq" else fa.launch_dkv
        fn = lambda: launch(ops, *args, **kw)
    key = f"{op} {[b, sq, skv, h, d]} bf16{' causal' if causal else ''} rate {rate}"
    out[key] = chip_smoke.graph_ms(fn, calls=10, reps=5)
    del q, do, k, v, o, lse, fn
    torch.cuda.empty_cache()
for x_shape, fout in json.loads(sys.argv[3]):
    b, fin = x_shape[0], x_shape[-1]
    pools = {"a": torch.randn(65, fin, generator=g, device="cuda") / 16,
             "b": torch.randn(65, fout, generator=g, device="cuda") / 16}
    pools["a"][0] = pools["b"][0] = 0.0
    table = (torch.randperm(64, generator=g, device="cuda")[:b * 16]
             .reshape(b, 16).int() + 1)
    scale = torch.ones(b, device="cuda")
    x = torch.randn(x_shape, generator=g, device="cuda").bfloat16()
    y = torch.randn(x_shape[:-1] + [fout], generator=g,
                    device="cuda").bfloat16()
    key = f"seg_lora {x_shape} -> {fout} bf16 + base, rank 16"
    out[key] = chip_smoke.graph_ms(
        lambda: sl.segmented_lora(x, pools, table, scale, base=y,
                                  impl="fused"))
    if x_shape == [4, 4096]:
        held = (sl.SitePools(pools).args, sl.batch_args(table, scale))
        out[key + ", wall per eager call (held contract)"] = \
            chip_smoke.eager_us(torch, lambda: sl.launch(x, *held, y)) / 1e3
for shape, dt, masking, rate in json.loads(sys.argv[4]):
    b, skv = shape[0], shape[-1]
    dtype = getattr(torch, dt)
    x = (3.0 * torch.randn(shape, generator=g, device="cuda")).to(dtype)
    gy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    kvmask = None
    if masking == "padding":
        lengths = torch.randint(skv // 2, skv + 1, (b,), generator=g,
                                device="cuda")
        kvmask = torch.arange(skv, device="cuda")[None, :] < lengths[:, None]
    causal = masking == "causal"
    seed = keep_mask.draw_seed(g) if rate else keep_mask.zero_seed("cuda")
    key = (f"softmax_dropout {{}} {shape} {'bf16' if dt == 'bfloat16' else 'f32'}"
           f" {masking} rate {rate}")
    out[key.format("fwd")] = chip_smoke.graph_ms(
        lambda: sd._sd_fwd_cuda(x, kvmask, seed, causal, rate, dtype),
        calls=20, reps=5)
    out[key.format("bwd")] = chip_smoke.graph_ms(
        lambda: sd.softmax_dropout_bwd(x, kvmask, seed, gy, causal, rate,
                                       impl="fused"), calls=20, reps=5)
    del x, gy
    torch.cuda.empty_cache()
for kind, n, h, dt, res, with_gs, params in json.loads(sys.argv[6]):
    dtype = getattr(torch, dt)
    x = torch.randn(n, h, generator=g, device="cuda").to(dtype)
    r = torch.randn(n, h, generator=g, device="cuda").to(dtype) if res else None
    s = 1 + 0.1 * torch.randn(h, generator=g, device="cuda")
    gy = torch.randn(n, h, generator=g, device="cuda").to(dtype)
    gs = torch.randn(n, h, generator=g, device="cuda").to(dtype) if with_gs else None
    mean, rstd = norm_stats_ref(x, r, kind=kind, eps=1e-6)
    key = (f"norm_bwd {kind} [{n}, {h}] {'f32' if dt == 'float32' else 'bf16'}"
           f"{' residual' if res else ''}{' sum gradient' if with_gs else ''}"
           f"{'' if params else ' frozen scales'}")
    out[key] = chip_smoke.graph_ms(
        lambda: _norm_bwd_cuda(kind, x, s, r, mean, rstd, gy, gs, params),
        calls=20, reps=5)
    del x, r, gy, gs
    torch.cuda.empty_cache()
for (m, k), n in json.loads(sys.argv[7]):
    w = torch.randn(n, k, generator=g, device="cuda") * 0.02
    x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    for wd in ("int8", "fp8_e4m3"):
        leaf = quantize_leaf(w, wd)
        q, qs = leaf["qvalues"], leaf["qscale"]
        out[f"quant_dot [{m}, {k}] -> {n} {wd}"] = chip_smoke.graph_ms(
            lambda: qd._quant_dot_cuda(x, q, qs), calls=20, reps=5)
    del w, x, q, qs
    torch.cuda.empty_cache()
for (m, k), n in json.loads(sys.argv[8]):
    w = torch.randn(n, k, generator=g, device="cuda") * 0.02
    x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    for wd in ("int8", "fp8_e4m3"):
        leaf = quantize_leaf(w, wd)
        q, qs = leaf["qvalues"], leaf["qscale"]
        key = f"quant_gemv [{m}, {k}] -> {n} {wd}"
        out[key + " warm"] = chip_smoke.graph_ms(
            lambda: qd._quant_dot_cuda(x, q, qs), calls=50, reps=5)
        copies = [q] + [q.clone() for _ in range(-(-(120 << 20) // (n * k)) - 1)]
        turn = iter(range(10**9))
        out[key + " cold"] = chip_smoke.graph_ms(
            lambda: qd._quant_dot_cuda(x, copies[next(turn) % len(copies)], qs),
            calls=-(-60 // len(copies)) * len(copies), reps=5)
        del copies
    del w, x, q, qs
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


#: Case lists by group, in the order the turn script reads them.
GROUPS = {"norms": (CASES, TRAIN_CASES), "attention": (ATTENTION,),
          "seg_lora": (SEG_LORA,), "softmax": (SOFTMAX,),
          "norm_bwd": (NORM_BWD,), "quant": (QUANT,),
          "quant_gemv": (QUANT_GEMV,)}


def turn(tree: str, groups) -> dict:
    def cases(lst):
        keep = any(lst is c for g in groups for c in GROUPS[g])
        return json.dumps(lst if keep else [])

    proc = subprocess.run([sys.executable, "-c", _TURN, cases(CASES),
                           cases(ATTENTION), cases(SEG_LORA), cases(SOFTMAX),
                           cases(TRAIN_CASES), cases(NORM_BWD), cases(QUANT),
                           cases(QUANT_GEMV)],
                          cwd=tree, capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if len(argv) not in (2, 3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    a, b = os.path.abspath(argv[1]), os.getcwd()
    rounds = int(argv[2]) if len(argv) >= 3 else 1
    groups = argv[3].split(",") if len(argv) == 4 else list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        print(f"unknown groups {unknown}; known: {list(GROUPS)}",
              file=sys.stderr)
        return 2
    runs = {a: [], b: []}
    for tree in (a, b, b, a) * rounds:
        runs[tree].append(turn(tree, groups))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"kernel_ab ({card}): A = {a}, B = {b}; us per call, median "
          f"[min, max] of each checkout's {2 * rounds} turns")
    for key in runs[a][0]:
        ta, tb = ([r[key] * 1e3 for r in runs[t]] for t in (a, b))
        ma, mb = statistics.median(ta), statistics.median(tb)
        print(f"  {key:60s} A {ma:8.3f} [{min(ta):.3f}, {max(ta):.3f}]  "
              f"B {mb:8.3f} [{min(tb):.3f}, {max(tb):.3f}]  B/A {mb / ma:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
