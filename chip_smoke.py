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
             the launch floor (an empty one-block kernel, plain and as a
             programmatic dependent launch);
             and the dependent-launch chain (norm -> SwiGLU -> residual
             norm -> norm, each fed the one before's output, 8 rounds at
             the decode shape): serialized, eager and replayed from a
             CUDA graph, equal bit for bit, each stage within tolerance
             of its plain version;
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
   The 8B model is freed before the training phases.
7. train kernels — the four training kernels (LayerNorm forward, the norm
             backward, bias+GeLU forward and backward) against their plain
             versions at the BERT-base step's shapes ([32768, 768] and
             [32768, 3072]), bf16 and f32, and one unaligned shape, timed
             like phase 3 (library call: F.layer_norm,
             aten.native_layer_norm_backward and, for the RMS kind at the
             Llama microbatch's [8192, 4096] without residual,
             aten._fused_rms_norm_backward where they compute the same
             function; none computes bias+GeLU);
8. tiny_train — one train step of a BERT_TINY-shaped model in f32, dropout
             off, with the kernels on the card against the same step on
             the CPU plain path (the path the CPU tests hold against
             tpudl): loss, every gradient and the updated parameters;
9. train   — BERT-base (random weights from a seeded generator), batch 256,
             seq 128, dropout 0.1, fused_ops=True, the sst2_bert_base AdamW
             stack at a constant learning rate, through build_model ->
             create_train_state -> make_classification_train_step -> fit
             over synthetic_token_batches: step time, samples/s, MFU, peak
             memory, a profiled window (device busy share, top costs), and
             exactly 25 LayerNorm forward, 25 norm backward, 12 bias+GeLU
             forward and 12 backward launches per step (no RMSNorm or
             SwiGLU), every loss finite;
10. train_parity — from the same fresh weights, over 4 batches each with
             its own dropout seed, one step's losses and gradients on the
             kernel path, the plain bf16 path (fused_ops=False) and an f32
             oracle: the kernel path's relative L2 error of the
             per-example losses, of the whole gradient and of every
             gradient tensor (but two that cannot be judged, see UNGATED)
             may not exceed KERNEL_ERR_RATIO times the plain path's.

The fused slice (BERT-base with attention_impl="fused" and
loss_impl="auto", as bench.py's fused variant runs it) adds, in the
places named:

7b. fused kernels (after phase 7) — the dropout contract (philox.cuh's
             rounds against cuRAND's curand_Philox4x32_10 and the plain
             twin; keep masks bitwise equal to the plain
             version's at a rate within 5 sigma of 0.9; the backward
             regenerates the mask and is bitwise repeatable), then the
             softmax_dropout forward and backward at [256, 12, 128, 128]
             and the cross-entropy forward and backward at [256, 2] and
             [4096, 30522], against their plain versions, timed like
             phase 7;
8b. tiny_train_fused (after phase 8) — phase 8 with the slice's kernels;
11. train_fused (after phase 10) — phase 9 with the slice: exactly 12
             softmax_dropout forward and 12 backward, 1 cross-entropy
             forward and 1 backward, 25/25 norm and 12/12 bias+GeLU
             launches per step, then one eval batch through
             make_classification_eval_step (1 cross-entropy forward, no
             backward);
12. train_fused_parity — phase 10 with the slice on the kernel path
             against the plain path (attention_impl and loss_impl
             "reference"), attention dropout 0 and hidden dropout 0.1.

The Llama LoRA slice (Llama-3-8B fine-tuned with rank-16 adapters on the
7 projections, attention_impl="flash", fused_ops=True, batch 4 x seq
2048, the llama3_8b_lora optimizer) adds:

7c. llama kernels (after phase 7b) — the RMSNorm forward with row
             statistics at [8192, 4096] bf16 (plain and residual+sum,
             beside F.rms_norm) and the SwiGLU forward at [8192, 14336]
             bf16, each bitwise repeatable; the SwiGLU backward at [8192, 14336]
             (bf16, f32, unaligned) and flash forward, dQ and dK/dV at
             [4, 2048, 32, 128] bf16 causal (all-ones and padding masks,
             Sq != Skv, ragged 1000 / 1500, D 64 and 32, f32, dropout 0.1
             at [8, 1024, 12, 64]) against their plain versions, each
             backward bitwise repeatable, dK and dV exactly 0 on padded kv
             rows; flash's keep mask bitwise the
             plain one and its dropout-on output hybrid_attention's on the
             same seed words; timed like phase 7, beside
             F.scaled_dot_product_attention (and, for the backward rows,
             its backward alone);
8c. tiny_llama_train (after phase 8b) — an f32 LLAMA_TINY LoRA step with
             the kernels on the card against the CPU plain path;
13. llama_lora_train (after phase 12) — the slice at full width and depth
             through build_model -> create_train_state(lora_optimizer(...))
             -> make_classification_train_step(accum_steps=16) -> fit, at
             the config's global batch 64 as 16 microbatches of 4: per
             microbatch exactly 32 flash forward, dQ and dK/dV, 32 SwiGLU
             forward and backward, 65 RMSNorm forward and 64 norm backward
             launches (16 times that per step), finite losses, the frozen
             base bit-identical, step time, tokens/s, MFU, peak memory and
             a profiled window of the captured run;
14. llama_train_parity — full width, 2 layers, batch 1 x 2048: phase 10's
             gate on the kernel path, the plain path and an f32 oracle;
             the kernel path with remat=True gives its loss and gradients
             bit for bit (forward kernels launched twice), peak memory
             printed both ways.

The multi-tenant serving slice (Llama-3-8B with six LoRA tenants over
the paged KV cache, ServeSession.from_model(adapters=...)) and BERT-base
at seq 512 (attend("fused") reaching the whole-row attention) add:

3b. seg_lora kernels (after phase 3) — the segmented-LoRA kernel against
             its plain version at the decode step's [4, 4096] -> 4096 and
             -> 14336 and the prefill's [1, 128, 4096] -> 4096 (rank 16,
             f32 pages, bf16 x), int8 pages, f32 x with ragged ranks and
             an empty slot, 3-D x; bitwise repeatable; timed like phase 7,
             beside the page gather and two torch.bmm, and the two
             torch.bmm on pages gathered beforehand;
4b. tenant_tiny (after phase 4) — LLAMA_TINY in f32 with three tenants on
             the card: assert_tenant_parity exact for f32 pages, the CPU
             plain path's tokens, int8 pages within the margin;
6b. tenant_slice (after phase 6, the 8B weights still resident) — six
             tenants (five of rank 16, one of rank 8, lora_b nonzero) in a
             65-page pool, 12 ragged greedy requests over the tenants and
             the base and one sampled: every result ok, evictions and
             reloads, exactly 224 segmented-LoRA, 65 RMSNorm and 32 SwiGLU
             launches per prefill and decode step, TTFT / TPOT / tokens/s
             beside the dense slice's, a profiled decode window;
6c. tenant_parity — phase 6's gate on those requests: the plain path
             (fused_ops=False, adapter_impl="reference") and an f32 oracle
             with the tenant's adapter;
7d. whole attention kernels (after phase 7c) — the whole-row attention
             forward and two-launch backward at [32, 512, 12, 64] bf16
             (padding mask, dropout 0.1; no dropout; ragged S 300, 384
             and 301 with dropout; causal; f32; D 32 and 128) against
             their plain versions, each backward bitwise repeatable, its
             padded kv rows exactly 0, each gate rejecting a planted 5 %
             error; the keep mask bitwise the plain one, the dropout-on
             output hybrid_attention's; timed beside SDPA (the backward
             rows also beside SDPA's backward alone);
15. train_512 (after phase 12) — phase 11 at batch 32 x seq 512, 20 timed
             steps: exactly 12 whole-attention forward and 12 backward, no
             softmax_dropout, 25/25 norm, 12/12 bias+GeLU and 1/1
             cross-entropy launches per step, then one eval batch;
16. train_512_parity — phase 12's gate at seq 512 with 2 layers.

The CV path and the rest of the train loop (accumulation, BatchNorm
state, remat, evaluate, the augmenter) add:

11b. train_fused's checks (after phase 11) — from one set of seeded
             BERT-base weights at 256 x 128: with dropout 0.1,
             remat="layer" gives the step's loss and every gradient bit
             for bit (the encoder's forward kernels launched twice), peak
             memory printed both ways; with dropout off, accum_steps=8
             gives the monolithic step's loss and gradients within
             ACCUM_TOL (relative L2);
17. resnet50_train (after phase 16) — configs[2] (imagenet_resnet50_dp)
             through build_model("resnet50", 1000) -> create_train_state
             -> make_optimizer -> make_classification_train_step(0.1,
             accum_steps=8, input_transform=device_normalize(...),
             loss_impl="auto") -> fit, at global batch 1024 = 8 x 128 of
             uint8 224 x 224 images that the native BatchAugmenter pads
             by 8 and crops and flips afresh each step on the host (the
             native kernel checked against numpy first): step time,
             images/s, MFU, peak memory, a profiled window; exactly 8
             cross-entropy launches each way a step; losses finite,
             running statistics moved and finite; then evaluate over 1000
             images at batch 128, the 104-row tail padded, against the
             same images unpadded within EVAL_PAD_TOL;
18. resnet_parity — ResNet-50 at full width, 2 microbatches of 16 at
             224 x 224: the bf16 path against an f32 oracle (TF32 off),
             relative L2 errors of the logits, losses, gradients and
             running statistics; logits and losses gated at
             RESNET_PARITY_TOL.

The rest of the compiled serving path and the export harness add:

6d. generate_chunked (after phase 6c, the 8B weights still resident) —
             generate() at batch 4 (ragged) x prompt 128, 64 new tokens,
             chunks of 8: the chunked loop (a CUDA graph a chunk) against
             the per-token loop, greedy and sampled, tokens bit for bit,
             65 RMSNorm and 32 SwiGLU launches a token each way, tokens/s
             of both, the chunk graphs captured;
6e. export_llama_serving — export_serving_decoder of the slice (batch-1
             prefill at 128, 4-slot decode, the weights as inputs) at the
             8B's width cut to 4 layers, dense and paged (page 16): 9
             tpudl::rms_norm and 4 tpudl::swiglu nodes in each program,
             export and load seconds; ServeSession.from_artifacts
             (prefill and decode captured) reads back slots, window,
             bound (and page size and pool pages) and serves the slice's
             requests with the tokens and launches of a model session
             of the same cut model; TPOT beside that session's;
11c. export_bert (after phase 11b) — BERT-base seq 128, fused, its eval
             forward exported on the card: 25 tpudl::layer_norm, 12
             bias_gelu and 12 softmax_dropout nodes and no random op, as
             many launches for one forward of the loaded program, deployed
             parity card against CPU;
18b. export_resnet50 (after phase 18) — configs[2]'s ResNet-50 eval
             forward exported on the card from a meta model, the weights
             and statistics saved with save_params (safetensors) and read
             back bit for bit, artifact sizes; strict parity (f32, batch
             8, TF32 off in cuBLAS and cuDNN) and deployed parity (bf16,
             batch 128) card against CPU from one artifact;
             latency_benchmark at batch 1 and 128, the loaded program
             alone and replayed from a CUDA graph;
19. remat_captured (last) — compile_step with remat: BERT-base 256 x 128
             fused, remat="layer", dropout 0.1, and the 2-layer Llama LoRA
             classifier with remat=True, captured against eager bit for
             bit; step ms, capture s, recompute twins, peak memory.

Checkpointing and fault tolerance (tpudl_torch.checkpoint,
tpudl_torch.ft) add, after phase 18b:

20. ft_bert — BERT-base as train_fused runs it (256 x 128, dropout 0.1,
             captured), checkpointed by an AsyncCheckpointManager in a
             temporary directory: 12 uninterrupted steps; the same with
             checkpoint_every=4 (step time with and without the cadence,
             each save's stall and background write, the payload's
             bytes); SIGTERM from the logger at step 6 under a
             PreemptionGuard (a save at 4, the emergency save at 6,
             info["preempted"]); the step-4 checkpoint restored in place
             into that run's captured state (the same tensors) and
             replayed to step 12; resume_run into a state from another
             seed and 6 more steps (counts reset just before: the fused
             slice's launches a step); the same save with
             async_save=False. Every run equals the uninterrupted one bit
             for bit: losses, parameters, moments, counts and step;
21. ft_resnet50 — configs[2] at 1024 = 8 x 128 fed by
             prefetch_to_device under a ResumableIterator: 6 steps
             against a run saved at step 3 and resumed in a state from
             another seed, bit for bit (BatchNorm statistics and SGD
             traces included), 8 cross-entropy launches each way a
             resumed step;
22. ft_kill — tpudl_torch.ft.Supervisor over a one-process runner
             (OneProcessRunner: a spawn child a run): the child trains
             BERT-base 8 steps with a checkpoint every 2 and is
             SIGKILLed once at step 5 (TPUDL_CHAOS_KILL_AT_STEP,
             TPUDL_CHAOS_ONCE_DIR); the restarted child resumes at step 4
             and ends with the payload digest of an uninterrupted child;
             then the newest step is truncated and restore_full() falls
             back to the one before it, counting ft_corrupt_checkpoints
             once.

Mixed precision and fp8 (tpudl_torch.train.precision,
tpudl_torch.ops.fp8_dot) add:

23. fp8_matmul (after ft_kill) — fp8_dot's products (torch._scaled_mm)
             at BERT-base's and Llama-3-8B's projection shapes against the
             plain version (forward, dx, dw), and their times beside bf16
             torch.matmul, the bound at the fp8 peak, the plain version,
             and each site's casts, amaxes and transposed copies;
24. train_precision — BERT-base 256 x 128 fused, dropout 0.1, in four
             cells from one seed and one batch stream (f32 control, bf16,
             bf16 with bf16 first moments, fp8 with loss scaling), 20
             steps eager then captured, bit for bit, each cell's final
             loss within its band of the control's; the fp8 cell's rings
             after step 1, a sync save / restore in place replayed bit
             for bit, a planted nonfinite step skipped with everything
             but the loss scale unchanged and its retry drawing the same
             masks, the ok readback's cost and a profiled window;
25. llama_fp8_lora_train (after llama_lora_train) — configs[4] with
             fp8_train=True under policy("fp8"), llama_lora_train's
             weights and first 16 rows as 4 microbatches of 4 x 2048 a
             step: the first two losses (empty rings, then filled ones,
             both on the initial weights) within 0.08 of the bf16 loss of
             the same weights and rows, at seeds 0, 1 and 2; the frozen
             base unchanged, every ring advanced, eager and captured bit
             for bit;
26. llama1b_full_train (after llama_train_parity) — Llama-3.2-1B with
             every parameter trained against f32 masters under
             policy("bf16", bf16_moments=True), 2 microbatches of 4 x
             2048, eager and captured bit for bit, every tensor moved,
             the losses on the initial weights held to the eval step's;
             then llama1b_cut_parity: the step at 2 layers through the
             kernel path, the plain bf16 path and an f32 oracle (first
             gradients, and losses after updates at a constant 1e-4).

The quantized tiers and the MoE MLP (tpudl_torch.quant,
tpudl_torch.ops.quant_dot, tpudl_torch.ops.moe) add:

27. quant_dot (after kernels) — the weight-only product
             (csrc/quant_dot.cu) against its plain twin at the decode
             (4, 8 and 16 rows), prefill and BERT-base shapes, int8 and
             e4m3, bitwise repeatable, with the unaligned scalar path and
             f32 x once; timed beside bf16 torch.matmul, dequantize +
             torch.matmul and torch._weight_int8pack_mm, the decode GEMV
             and bf16 torch.matmul also L2-cold (cold_ms); the
             dependent-launch chain check ends each round with the GEMV;
28. quant_slice (after export_llama_serving) — the slice's session with
             weight_dtype="int8", then "fp8_e4m3", eager then captured:
             the slice's requests, 224 quant_dot launches a prefill and
             decode step, weight_bytes_report; the kernel path's
             teacher-forced logit error against an f32 oracle on the
             dequantized weights no larger than the plain twin's; a
             profiled window of decode steps for each weight dtype
             ("profile: quant_dot device ms a step");
29. quant_kv8_slice — int8 weights over int8 KV pages (paged, page 16),
             eager then captured, without tenants (the logit rule through
             the paged int8 path; the pool's bytes 0.5156x a bf16 pool's)
             and with tenant_slice's six tenants on the quantized base
             (the pool evicts and reloads);
30. export_quant — the dense int8 and paged int8-over-int8-pages
             serving programs as artifacts, each product a
             tpudl::quant_dot node, served with the model sessions'
             tokens;
31. bert_quant_eval (after export_bert) — BERT-base's fused eval
             forward at 256 x 128 with int8 weights against bf16: 72
             quant_dot launches, the logit difference, ms a forward;
32. moe_train (after llama1b_full_train) — llama3-1b-moe at full width
             (8 experts, top-2, capacity 1.25) cut to 4 of 16 layers,
             every parameter against f32 masters under policy("bf16",
             bf16_moments=True), 2 x 4 x 2048, moe_aux_weight 0.01,
             loss_impl="auto": eager then captured bit for bit, exact
             launches, the aux loss, the router gradients, the expert
             load; moe_cut_parity: 1 layer, 4 x 2048, losses within 0.03
             of an f32 oracle.

The data layer (tpudl_torch.data: the converter, tokenizers, dataset
helpers and ingest) and the run's logs, goodput and profile
(tpudl_torch.train.logging, tpudl_torch.obs.goodput,
tpudl_torch.train.profiling), after resnet_parity:

33. data_bert_large — configs[3] (bert_large_v4_32) as train_sst2.py
             --text-data runs it: 8192 raw sentences as Parquet, a
             4096-token WordPiece vocab trained on them, the ids at seq
             128, split_train_eval, the converter shuffled with the
             config's seed through prefetch_to_device(normalize_sst2_batch,
             2 assembly workers); BERT-large fused at 256 = 4 x 64 with
             bf16 first moments, eager then captured bit for bit, exact
             launches (4 x 49 LayerNorm and norm backward, 4 x 24
             bias+GeLU and softmax_dropout each way, 4 cross-entropy each
             way a step), under fit with a MetricLogger (one JSONL line
             per logged step) and, captured, a span recorder whose
             goodput categories sum to the wall clock within 1 %; then
             evaluate on the holdout, eager against captured. The train
             kernels and fused kernels phases time BERT-large's shapes
             too ([8192, 1024] norms, [8192, 4096] bias+GeLU, [64, 16,
             128, 128] softmax_dropout);
34. data_cifar_resnet18 — configs[0] (cifar10_resnet18) as
             train_cifar10.py --materialize runs it: 50,000 rows as
             Parquet, a 10,000-row test_batch tarball through
             ingest_cifar10, the converter through prefetch_to_device
             (seeded crop and flip, wire_cifar_batch), device_normalize_cifar
             in the step; ResNet-18 at 256 x 32², SGD, eager then
             captured bit for bit, exact launches; fit(profile_dir=) over
             two captured steps read back by summarize_trace; evaluate
             over the ingested batch.

Each phase's seconds are printed ("phase ...:" lines).

The compiled step (tpudl_torch.graphs) makes every path run twice, from
the same seeded weights over the same batches or requests: eagerly,
then captured as CUDA graphs (train and eval steps through
compile_step, whose first call is eager and second the capture; prefill
and decode calls through ServeSession.from_model's CapturedCall). Phases 5, 6b, 9,
11, 15, 17 and llama_lora_train print both ways (step ms or TTFT/TPOT,
launches per step, peak memory, capture time; the captured run's device
busy share from a profiled window: an eager run launches the same
kernels, and reading back its profile cost 10-30 s a window) and fail
unless the captured run's losses,
parameters, optimizer state, BatchNorm statistics, eval metrics and
tokens equal the eager run's bit for bit and its launch counts are the
exact per-step counts. resnet50_train feeds both runs through
prefetch_to_device (assembly workers running a seeded native crop and
flip per step) and prints the data wait of each step; its evaluate runs
through one captured eval graph too.

The last three lines are the ``{"kernels": [...]}`` record (``launches``
is each kernel's count over its main-path run, ``launches_per_step`` per
decode or train step), the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

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

#: The BERT-base fine-tune step of bench.py:_bench_bert.
BERT_BATCH = 256
BERT_SEQ = 128
TRAIN_WARMUP_STEPS = 3
TRAIN_STEPS = 20
PROFILE_STEPS = 3
PARITY_BATCHES = 4
#: The fused slice at seq 512 (train_512): sst2_bert_base's own global
#: batch, BERT-base's max_position_embeddings; attend("fused") runs the
#: whole-row attention kernels there.
BERT_512_BATCH = 32
BERT_512_SEQ = 512


def attention_kernels(seq):
    """The kernels attend("fused") launches at ``seq``: softmax_dropout at
    S <= 256, the whole-row attention up to 512."""
    return ("softmax_dropout_fwd", "softmax_dropout_bwd") if seq <= 256 \
        else ("fused_attn_fwd", "fused_attn_bwd")


def launches_per_step(num_layers, fused_slice=False, seq=BERT_SEQ):
    """Kernel launches per BERT train step: the embeddings' LayerNorm and
    two per layer, forward and backward; one bias+GeLU per layer each
    way; on the fused slice (attention_impl="fused", loss_impl="auto")
    also one attention kernel per layer each way (softmax_dropout at S
    <= 256, the whole-row attention above) and one cross-entropy each
    way."""
    out = {"layer_norm_fwd": 1 + 2 * num_layers,
           "norm_bwd": 1 + 2 * num_layers,
           "bias_gelu_fwd": num_layers, "bias_gelu_bwd": num_layers}
    if fused_slice:
        fwd, bwd = attention_kernels(seq)
        out.update({fwd: num_layers, bwd: num_layers, "xent_fwd": 1,
                    "xent_bwd": 1})
    return out


def eval_launches(num_layers, seq=BERT_SEQ):
    """Kernel launches of one eval batch on the fused slice: the forward
    kernels only."""
    out = launches_per_step(num_layers, True, seq)
    return {k: v if k.endswith("_fwd") else 0 for k, v in out.items()}


#: BERT-base: 25, 25, 12, 12.
TRAIN_LAUNCHES = launches_per_step(12)
#: The fused slice at BERT-base: those, and 12, 12, 1, 1.
TRAIN_FUSED_LAUNCHES = launches_per_step(12, fused_slice=True)
#: The fused slice at seq 512: 25, 25, 12, 12, 12 whole-row attention
#: forward and 12 backward, 1, 1.
TRAIN_512_LAUNCHES = launches_per_step(12, True, BERT_512_SEQ)
#: BERT-large's microbatch (bert_large_v4_32: 256 = 4 x 64 at seq 128).
BERT_LARGE_ROWS = 64 * BERT_SEQ
#: softmax_dropout and cross-entropy kernels vs plain (rtol, atol): one
#: bf16 step (2^-7 relative), or 1e-5 in f32. The keep masks are held
#: bit for bit.
FUSED_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-7, 1e-6)}
#: BERT-base attention: 12 heads.
BERT_HEADS = 12
#: Kernel vs plain tolerance for the bias+GeLU forward (rtol, atol): bf16
#: is tpudl's band (tests/test_fused_mlp.py:98-108; the kernel adds the
#: bias in f32, the plain version in bf16).
BG_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.05, 0.02)}
#: The backward kernels' dx (rtol = atol): f32 1e-4
#: (tests/test_fused_norms.py:35-139), bf16 one bf16 step. Their f32 sums
#: over rows (dscale, dbias, db) are held by sum_errors.
BWD_TOL = {"float32": 1e-4, "bfloat16": 0.05}


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


#: Bytes that cold timing rotates over: more than twice the H100's 50 MB
#: L2, so no call finds its weights there (as a decode step streams them).
COLD_BYTES = 120 * 2**20


def cold_ms(make, nbytes: int, calls: int = 60, reps: int = 5) -> float:
    """Device time of one call with its operands L2-cold: ``make(i)``
    returns a call on its own copy i of the operands (``nbytes`` each);
    enough copies to exceed ``COLD_BYTES`` are made and ``calls`` calls
    (a whole number of turns over the copies) are captured in turn in one
    CUDA graph, timed as ``graph_ms`` does."""
    copies = max(2, -(-COLD_BYTES // nbytes))
    fns = [make(i) for i in range(copies)]
    turn = iter(range(10**9))
    calls = -(-calls // copies) * copies
    return graph_ms(lambda: fns[next(turn) % copies](), calls=calls, reps=reps)


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


def library_ms(fn, **kw):
    """``graph_ms`` of one PyTorch call, or None where that call does not
    take these inputs (printed, not fatal: it is a yardstick only)."""
    try:
        return graph_ms(fn, **kw)
    except (RuntimeError, TypeError) as e:
        print(f"library call not timed: {type(e).__name__}: {e}")
        return None


def library_bwd_ms(torch, F, q, k, v, do, lib_kw):
    """SDPA's backward alone on these [B, H, S, D] leaves: one forward
    outside the timed region, then ``eager_ms`` of torch.autograd.grad
    with the graph retained. Not captured in a CUDA graph like the other
    rows: the autograd engine runs a backward on its forward's stream,
    and a backward captured on the forward's side stream faulted (illegal
    address) at [32, 512, 12, 64] with dropout. Eager, the host's cost
    per call shows where the backward is short."""
    try:
        out = F.scaled_dot_product_attention(q, k, v, **lib_kw)
        return eager_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do, retain_graph=True), calls=10, reps=5)
    except RuntimeError as e:
        print(f"library backward not timed: {e}")
        return None


def bound(nbytes: float, ops: float, peak: float = F32_OPS_PER_S):
    """(least ms, "bytes" or "operations"): the bytes over the memory rate
    or the operations over ``peak`` (f32 CUDA cores by default; the bf16
    tensor cores for products of bf16 operands), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(out, ref, tol, atol=None):
    """(max abs error, max relative error, within tolerance): |out - ref|
    <= atol + tol * |ref|, atol defaulting to tol."""
    import torch

    atol = tol if atol is None else atol
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool(torch.all(d <= atol + tol * r))
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
    report_cases(cases)
    return cases


def launch_floor_phase(torch):
    """The launch floor the short kernels are held against: ``graph_ms``
    of an empty one-block kernel (csrc/norms.cu launch_floor_kernel)
    launched plain and as a programmatic dependent
    launch, as every norm and SwiGLU forward launches. Back to back in one
    graph, the dependent launches overlap one another's launch."""
    import ctypes

    from tpudl_torch.ops import _build

    lib = _build.load("norms")
    lib.tpudl_launch_floor.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.tpudl_launch_floor.restype = ctypes.c_int

    def launch(pdl):
        _build.check(lib, "launch_floor", lib.tpudl_launch_floor(
            pdl, torch.cuda.current_stream().cuda_stream))

    out = {"plain_ms": graph_ms(lambda: launch(0)),
           "pdl_ms": graph_ms(lambda: launch(1))}
    print("launch floor (empty one-block kernel, CUDA-graph replay, ms): "
          f"plain {out['plain_ms']:.5f}, dependent launch "
          f"{out['pdl_ms']:.5f}")
    return out


def pdl_chain_check(torch):
    """norm -> SwiGLU -> residual norm -> norm -> the int8 GEMV (quant_dot
    [4, 4096] -> 4096), each kernel fed the one before's output, 8 rounds
    (each round's input the last one's output) at the decode step's 4 rows
    of 4096 in bf16, the SwiGLU on the flattened rows. Run three ways: with a synchronize after every launch
    (no launch can overlap another), eagerly back to back (each
    dependent launch may start while the one before runs), and replayed
    from a CUDA graph of the same launches. A kernel that read device
    memory before griddepcontrol.wait would see its input half written:
    the three must agree bit for bit, and each stage of the last round
    must be within KERNEL_TOL (the GEMV QUANT_TOL) of its plain version
    on the same inputs."""
    from tpudl_torch.ops import quant_dot as qd
    from tpudl_torch.ops.mlp_fused import swiglu, swiglu_ref
    from tpudl_torch.ops.norms import rms_norm, rms_norm_ref
    from tpudl_torch.quant.quantize import quantize_leaf

    g = torch.Generator(device="cuda").manual_seed(97)
    n, h, rounds = NUM_SLOTS, 4096, 8
    x0 = torch.randn(n, h, generator=g, device="cuda").bfloat16()
    up = torch.randn(n * h, generator=g, device="cuda").bfloat16()
    s1, s2, s3 = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")
                  for _ in range(3))
    leaf = quantize_leaf(torch.randn(h, h, generator=g, device="cuda") * 0.02,
                         "int8")
    q, qs = leaf["qvalues"], leaf["qscale"]

    def chain(x, sync):
        out = []
        for _ in range(rounds):
            y1 = rms_norm(x, s1, impl="fused")
            sync()
            a = swiglu(y1.view(-1), up, impl="fused").view(n, h)
            sync()
            y2, summed = rms_norm(a, s2, y1, impl="fused")
            sync()
            y3 = rms_norm(summed, s3, impl="fused")
            sync()
            out.append((x, y1, a, y2, summed, y3))
            x = qd._quant_dot_cuda(y3, q, qs)
            sync()
        return out, x

    serial, x_serial = chain(x0, torch.cuda.synchronize)
    eager, x_eager = chain(x0, lambda: None)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(x0, lambda: None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed, x_graph = chain(x0, lambda: None)
    graph.replay()
    torch.cuda.synchronize()
    def flat(out, x):
        return [t for stage in out for t in stage[1:]] + [x]

    equal = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
        flat(serial, x_serial), flat(eager, x_eager),
        flat(replayed, x_graph)))
    x, y1, a, y2, summed, y3 = replayed[-1]
    tol = KERNEL_TOL["bfloat16"]
    want = rms_norm_ref(a, s2, y1)
    ref = qd.quant_matmul_ref(y3, q, qs)
    rtol, share = QUANT_TOL["bfloat16"]
    err = merged(errors(y1, rms_norm_ref(x, s1), tol),
                 errors(a.view(-1), swiglu_ref(y1.view(-1), up), tol),
                 errors(y2, want[0], tol), errors(summed, want[1], tol),
                 errors(y3, rms_norm_ref(summed, s3), tol),
                 errors(x_graph, ref, rtol, share * float(ref.float().abs().max())))
    print(f"pdl chain (norm -> SwiGLU -> residual norm -> norm -> int8 GEMV, {rounds} "
          f"rounds at [{n}, {h}] bf16): serialized, eager and graph "
          f"{'equal bit for bit' if equal else 'DIFFER'}; last round "
          f"against the plain versions max_abs_err={err[0]:.3e} "
          f"{'ok' if err[2] else 'OUTSIDE TOLERANCE'}")
    if not (equal and err[2]):
        fail("the dependent-launch chain is not bitwise stable or not "
             "within tolerance of the plain versions")
    return {"bitwise_equal": equal, "max_abs_err": err[0]}


def report_cases(cases):
    """Print one line per kernel case; fail if any is outside tolerance."""
    bad = []
    for name, rows in cases.items():
        for c in rows:
            eager = (f"eager: kernel {c['eager_ms']:.5f} plain "
                     f"{c['plain_eager_ms']:.5f} " if "eager_ms" in c else "")
            lib = c["library_ms"]
            print(
                f"kernel {name} {c['variant']} {c['shape']} {c['dtype']}: "
                f"max_abs_err={c['max_abs_err']:.3e} "
                f"max_rel_err={c['max_rel_err']:.3e} tol={c['tol']} "
                f"{'ok' if c['ok'] else 'OUTSIDE TOLERANCE'} "
                f"kernel_ms={c['ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                f"{eager}"
                f"library_ms={lib if lib is None else round(lib, 5)}"
                f"{' (' + c['library'] + ')' if c.get('library') else ''} "
                f"{'library_bwd_ms=' + format(c['library_bwd_ms'], '.5f') + ' (its backward alone) ' if c.get('library_bwd_ms') else ''}"
                f"{'library_pregathered_ms=' + format(c['library_pregathered_ms'], '.5f') + ' (the products on pages gathered beforehand) ' if c.get('library_pregathered_ms') else ''}"
                f"{'library_f32_ms=' + format(c['library_f32_ms'], '.5f') + ' (' + c['library_f32'] + ') ' if c.get('library_f32_ms') else ''}"
                f"bound_us={c['bound'][0] * 1e3:.3f} ({c['bound'][1]})"
                f"{'; beyond the bound: ' + c['beyond_bound'] if c.get('beyond_bound') else ''}"
            )
            if not c["ok"]:
                bad.append(f"{name} {c['variant']} {c['shape']} {c['dtype']}")
    if bad:
        fail(f"kernel outside tolerance: {bad}")


def seg_lora_kernel_phase(torch):
    """The segmented-LoRA kernel against its plain version at the serving
    path's shapes, each adding onto a base output as the path calls it:
    the decode step's [4, 4096] -> 4096 (q_proj, its headline call), ->
    14336 (gate/up) and [4, 14336] -> 4096 (down), and the prefill's [1,
    128, 4096] -> 4096, rank 16 on every slot, f32 pages, bf16 x; then
    int8 pages, f32 x with ragged ranks (16 and 8) and an empty slot, and
    3-D x with int8 pages, without a base. Bound: the pages this run's
    table names (page 0 skipped), x (and the base) in, the result out.
    Library: the page gather and two torch.bmm (f32), and beside it the
    two torch.bmm on the pages gathered beforehand."""
    from tpudl_torch.ops import segmented_lora as sl
    from tpudl_torch.serve.lora import _quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"seg_lora": []}
    r_max, pages = 16, 4 * 16 + 1
    # The main path adds onto the projection in the same call (base).
    for x_shape, fout, dtype, quantized, ragged, with_base, variant in (
        ((NUM_SLOTS, 4096), 4096, bf16, False, False, True,
         "decode q_proj + base, 4 slots at rank 16 (the main path's 32 "
         "q_proj calls)"),
        ((NUM_SLOTS, 4096), 14336, bf16, False, False, True,
         "decode gate/up_proj + base"),
        ((NUM_SLOTS, 14336), 4096, bf16, False, False, True,
         "decode down_proj + base"),
        ((1, PROMPT_LEN, 4096), 4096, bf16, False, False, True,
         "prefill q_proj + base"),
        ((NUM_SLOTS, 4096), 4096, bf16, True, False, False,
         "decode q_proj, int8 pages"),
        ((NUM_SLOTS, 4096), 4096, f32, False, True, False,
         "f32 x, ranks 16 and 8, an empty slot"),
        ((3, 7, 1000), 1500, bf16, True, True, False,
         "3-D x, int8 pages, ragged"),
    ):
        b, fin = x_shape[0], x_shape[-1]
        a = torch.randn(pages, fin, generator=gen, device="cuda") / 16
        bp = torch.randn(pages, fout, generator=gen, device="cuda") / 16
        a[0] = bp[0] = 0.0
        if quantized:
            (qa, sa), (qb, sb) = (_quantize_rows(m.cpu().numpy()) for m in (a, bp))
            pools = {k: torch.from_numpy(v).cuda() for k, v in (
                ("a", qa), ("b", qb), ("a_scale", sa), ("b_scale", sb))}
        else:
            pools = {"a": a, "b": bp}
        table = torch.randperm(pages - 1, generator=gen, device="cuda")[
            :b * r_max].reshape(b, r_max).int() + 1
        if ragged:
            table[b // 2:, 8:] = 0
            table[-1] = 0
        scale = torch.full((b,), 1.0, device="cuda")
        x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
        y = (torch.randn(x_shape[:-1] + (fout,), generator=gen, device="cuda")
             .to(dtype) if with_base else None)
        out = sl.segmented_lora(x, pools, table, scale, base=y, impl="fused")
        want = sl.segmented_lora_ref(x, pools, table, scale, y)
        tol = 2e-5 if dtype == f32 else 2.0**-7
        err = errors(out, want, tol, tol * float(want.float().abs().max()))
        if not torch.equal(out, sl.segmented_lora(x, pools, table, scale,
                                                  base=y, impl="fused")):
            err = (err[0], err[1], False)
            print(f"seg_lora {variant}: not bitwise repeatable")
        used = int((table != 0).sum())
        e_pool = 1 if quantized else 4
        s = x.numel() // (b * fin)
        e = torch.finfo(dtype).bits // 8
        nbytes = (used * (fin + fout) * e_pool + (8 * used if quantized else 0)
                  + x.numel() * e + b * s * fout * e * (2 if with_base else 1)
                  + table.numel() * 4 + b * 4)
        ops = 2.0 * s * used * (fin + fout)
        x3 = x.reshape(b, s, fin).float()

        def gather():
            t = table.long()
            ga = (pools["a"][t].float()
                  * (pools["a_scale"][t][..., None] if quantized else 1))
            gb = (pools["b"][t].float()
                  * (pools["b_scale"][t][..., None] if quantized else 1))
            return ga, gb

        ga, gb = gather()

        def bmm():
            return torch.bmm(torch.bmm(x3, ga.transpose(1, 2)), gb)

        def gather_bmm():
            a_, b_ = gather()
            return torch.bmm(torch.bmm(x3, a_.transpose(1, 2)), b_)

        if not cases["seg_lora"]:
            # The serving path's 224 calls a step are host-bound: each
            # entry's wall time per eager call, the checked one and the
            # held-contract one the model's hot path takes.
            held = (sl.SitePools(pools).args, sl.batch_args(table, scale))
            host = {
                "checked segmented_lora": eager_us(torch, lambda: sl.segmented_lora(
                    x, pools, table, scale, base=y, impl="fused")),
                "held-contract launch": eager_us(torch, lambda: sl.launch(
                    x, *held, y))}
            print(f"seg_lora {variant}: wall us per eager call "
                  + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

        row = timed_case(
            case_row(x_shape + (fout,), dtype, variant, err, tol, nbytes, ops),
            lambda: sl.segmented_lora(x, pools, table, scale, base=y,
                                      impl="fused"),
            lambda: sl.segmented_lora_ref(x, pools, table, scale, y),
            gather_bmm, "the page gather (pools[table], f32) and two "
            "torch.bmm, no base")
        # The same two bmm on pages gathered beforehand: the products
        # alone, without the gather the kernel does itself.
        row["library_pregathered_ms"] = library_ms(bmm, calls=20, reps=5)
        cases["seg_lora"].append(row)
        del a, bp, pools, ga, gb, x3, x, y, out, want
    torch.cuda.empty_cache()
    report_cases(cases)
    return cases


def tenant_adapters(torch, cfg, ranks, seed, b_std, device="cuda"):
    """Flat-form adapters for every projection site of ``cfg``, one per
    rank in ``ranks`` (tenants "t0", "t1", ...): lora_a drawn as the
    port's init draws it (normal, std 1 / r) and lora_b nonzero (normal,
    std ``b_std``, draw_lora_b's rule), from one seeded generator."""
    from tpudl_torch.serve.lora import _site_shapes

    g = torch.Generator(device=device).manual_seed(seed)
    sites = {"q_proj": "attention.q_proj", "k_proj": "attention.k_proj",
             "v_proj": "attention.v_proj", "o_proj": "attention.o_proj",
             "gate_proj": "gate_proj", "up_proj": "up_proj",
             "down_proj": "down_proj"}
    out = {}
    for t, r in enumerate(ranks):
        out[f"t{t}"] = {
            f"model.layer_{i}.{path}": {
                "lora_a": torch.randn(fin, r, generator=g, device=device) / r,
                "lora_b": b_std * torch.randn(r, fout, generator=g,
                                              device=device)}
            for i in range(cfg.num_layers)
            for site, path in sites.items()
            for fin, fout in [_site_shapes(cfg)[site]]}
    return out


def tenant_tiny_phase(torch):
    """LLAMA_TINY in f32 on the card with the kernels and three tenants
    (ranks 4, 2, 4; a pool of 9 pages, so it evicts and reloads):
    assert_tenant_parity exact against the merged-adapter reference for
    f32 pages, and the same tokens as the CPU plain path; then int8 pages
    under the margin (tpudl's alpha 4, atol 0.1). On the card the
    segmented LoRA launches its kernel 7 times per layer per prefill and
    decode step, on the CPU never."""
    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, init_params
    from tpudl_torch.ops import segmented_lora as sl
    from tpudl_torch.serve import Request, ServeSession, assert_tenant_parity

    import numpy as np

    cfg = LLAMA_TINY(dtype=torch.float32, max_seq_len=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = LlamaForCausalLM(cfg, device="meta")
    adapters = tenant_adapters(torch, cfg, (4, 2, 4), 3, 0.05, "cpu")
    rng = np.random.default_rng(2)
    tenants = [None] + sorted(adapters)
    reqs = [Request(f"t{i}", rng.integers(1, cfg.vocab_size, size=int(
        rng.integers(2, 9))).tolist(), max_new_tokens=int(rng.integers(3, 16)),
        tenant=tenants[i % len(tenants)]) for i in range(10)]
    tokens = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        session = ServeSession.from_model(model, p, prompt_len=8, num_slots=3,
                                          adapters=adapters, adapter_pages=9,
                                          page_size=4)
        before = sl.segmented_lora.launches
        assert_tenant_parity(session, model, p, adapters,
                             [Request(**r.__dict__) for r in reqs])
        eng = session.engine
        want = (7 * cfg.num_layers * (eng.num_prefills + eng.num_decode_steps)
                if device == "cuda" else 0)
        if sl.segmented_lora.launches - before != want:
            fail(f"tenant_tiny: {sl.segmented_lora.launches - before} "
                 f"segmented-LoRA launches on {device}, expected {want}")
        stats = eng.adapter_pool.stats()
        tokens[device] = {rid: r.tokens for rid, r in session.serve(
            [Request(**r.__dict__) for r in reqs]).items()}
    if tokens["cuda"] != tokens["cpu"]:
        fail("tenant_tiny: the card's tokens differ from the CPU plain path's")
    p = {k: v.cuda() for k, v in params.items()}
    session = ServeSession.from_model(model, p, prompt_len=8, num_slots=3,
                                      adapters=adapters, adapter_dtype="int8",
                                      adapter_alpha=4.0)
    assert_tenant_parity(session, model, p, adapters,
                         [Request(**r.__dict__) for r in reqs], atol=0.1,
                         alpha=4.0)
    print(f"tenant_tiny: f32 LLAMA_TINY, 3 tenants + the base, kernels on the "
          f"card: exact tokens against the merged-adapter reference with f32 "
          f"pages ({stats['evictions']} evictions, {stats['reloads']} "
          f"reloads), equal to the CPU plain path's; int8 pages within the "
          f"0.1 margin")


#: The multi-tenant slice: 6 tenants, 5 of rank 16 and one of rank 8, in a
#: pool of 4 rank-16 adapters and the zero page.
TENANT_RANKS = (16, 16, 16, 16, 16, 8)
TENANT_PAGES = 4 * 16 + 1
TENANT_B_STD = 0.01


def tenant_requests(Request, vocab, tenants):
    """12 ragged greedy requests over the tenants and the plain base, and
    one sampled one."""
    import numpy as np

    rng = np.random.default_rng(5)
    cycle = list(tenants) + [None]
    greedy = [Request(f"m{i}", rng.integers(1, vocab, size=int(rng.integers(
        16, PROMPT_LEN + 1))).tolist(), max_new_tokens=int(rng.integers(16, 49)),
        tenant=cycle[i % len(cycle)]) for i in range(12)]
    sampled = Request("ms", rng.integers(1, vocab, size=40).tolist(),
                      max_new_tokens=24, temperature=0.8, seed=9,
                      tenant=cycle[1])
    return greedy + [sampled]


def tenant_slice_phase(torch, model, params, card, dense):
    """Llama-3-8B (phase 5's resident weights) served with six LoRA
    tenants through ServeSession.from_model(adapters=...): every result
    ok, the pool evicts and reloads, exactly 224 segmented-LoRA, 65
    RMSNorm and 32 SwiGLU launches per prefill and per decode step;
    TTFT, TPOT and tokens/s beside the dense slice's, then a profiled
    window of adapter decode steps. Returns (adapters, requests,
    results, launches, metrics)."""
    from tpudl_torch.ops import segmented_lora as sl
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.serve import Request, ServeSession

    t0 = time.perf_counter()
    adapters = tenant_adapters(torch, model.cfg, TENANT_RANKS, 17,
                               TENANT_B_STD)
    kw = dict(prompt_len=PROMPT_LEN, num_slots=NUM_SLOTS, adapters=adapters,
              adapter_pages=TENANT_PAGES, adapter_rank_max=16)
    session = ServeSession.from_model(model, params, **kw)
    pool = session.engine.adapter_pool
    print(f"tenant_slice: {len(adapters)} tenants (ranks {TENANT_RANKS}), a "
          f"pool of {pool.num_pages} pages x {pool.bytes_per_page / 1e6:.3f} "
          f"MB = {pool.nbytes / 2**30:.3f} GiB, set-up "
          f"{time.perf_counter() - t0:.1f} s")
    session.serve([Request("warm", [1, 2, 3], max_new_tokens=2, tenant="t0")])
    requests = tenant_requests(Request, model.cfg.vocab_size, sorted(adapters))
    counted = {"seg_lora": sl.segmented_lora, "rms_norm_fwd": rms_norm,
               "swiglu_fwd": swiglu}
    runs = {capture: serve_run(
        torch, ServeSession.from_model(model, params, capture=capture, **kw),
        requests, counted) for capture in (False, True)}
    out = {}
    for capture, (session, results, wall, launches, peak) in runs.items():
        way = "captured" if capture else "eager"
        eng = session.engine
        calls = eng.num_prefills + eng.num_decode_steps
        stats = eng.adapter_pool.stats()
        print(f"tenant_slice ({way}): {len(results)} requests, "
              f"{eng.num_prefills} prefills, {eng.num_decode_steps} decode "
              f"steps, launches {launches}, pool {stats}")
        bad = [rid for rid, r in results.items() if not r.ok]
        if bad:
            fail(f"tenant_slice: requests not ok: {bad}")
        for req in requests:
            toks = results[req.request_id].tokens
            if len(toks) != req.max_new_tokens or not all(
                    0 <= x < model.cfg.vocab_size for x in toks):
                fail(f"tenant_slice: request {req.request_id}: {len(toks)} "
                     f"tokens")
        want = {"seg_lora": 224 * calls, "rms_norm_fwd": 65 * calls,
                "swiglu_fwd": 32 * calls}
        if launches != want:
            fail(f"tenant_slice ({way}): launches {launches} != expected "
                 f"{want} (224 segmented-LoRA, 65 RMSNorm, 32 SwiGLU per "
                 f"prefill and decode step)")
        if not (stats["evictions"] > 0 and stats["reloads"] > 0):
            fail(f"tenant_slice: the pool did not evict and reload: {stats}")
        ttft = [r.ttft_s * 1e3 for r in results.values()]
        tpot = [r.tpot_s * 1e3 for r in results.values()
                if r.tpot_s is not None]
        tokens = sum(len(r.tokens) for r in results.values())
        capture_s = getattr(eng.decode_call, "capture_s", None)
        prefill_capture_s = getattr(eng.prefill_call, "capture_s", None)
        prefill = prefill_ms(torch, session)
        m = {"prefill_capture_s": prefill_capture_s, "prefill_ms": prefill,
             "ttft_p50_ms": pct(ttft, 50), "ttft_p90_ms": pct(ttft, 90),
             "tpot_p50_ms": pct(tpot, 50), "tpot_p90_ms": pct(tpot, 90),
             "tokens_per_s": tokens / wall, "prefills": eng.num_prefills,
             "decode_steps": eng.num_decode_steps, "pool": stats,
             "pool_bytes": eng.adapter_pool.nbytes, "peak_memory_gib": peak,
             "launches": launches, "capture_s": capture_s}
        d = dense if capture else dense["eager"]
        print(f"tenant_slice metrics, {way} ({card}): TTFT p50 "
              f"{m['ttft_p50_ms']:.2f} ms, p90 {m['ttft_p90_ms']:.2f} ms "
              f"(dense slice {d['ttft_p50_ms']:.2f} / {d['ttft_p90_ms']:.2f});"
              f" TPOT p50 {m['tpot_p50_ms']:.3f} ms, p90 "
              f"{m['tpot_p90_ms']:.3f} ms (dense {d['tpot_p50_ms']:.3f} / "
              f"{d['tpot_p90_ms']:.3f}); {tokens} tokens in {wall:.3f} s = "
              f"{tokens / wall:.1f} tokens/s (dense {d['tokens_per_s']:.1f});"
              f" prefill {prefill:.3f} ms a request [1, {PROMPT_LEN}] (dense "
              f"{d['prefill_ms']:.3f}); peak memory {peak:.2f} GiB"
              + ("" if capture_s is None
                 else f"; decode graph captured in {capture_s * 1e3:.1f} ms, "
                      f"prefill graph (with the adapter view) in "
                      f"{prefill_capture_s * 1e3:.1f} ms"))
        out[capture] = m
    same_tokens(runs, requests, "tenant_slice")
    metrics = out[True]
    metrics["eager"] = out[False]
    metrics["eager"]["decode_device_busy_share"] = None  # see profile_decode
    metrics["decode_device_busy_share"] = profile_decode(
        torch, model, params, Request, kw, sorted(adapters))
    return adapters, requests, runs[True][1], runs[True][3], metrics


def tenant_parity_phase(torch, model, params, adapters, requests,
                        kernel_results):
    """Phase 6's gate on the multi-tenant slice. The same requests are
    served on the plain path (fused_ops=False, adapter_impl="reference",
    same weights and adapters, so the same schedule); where the kernel
    and plain token streams part, the prompt and the plain stream up to
    that step go through an f32 oracle (the plain f32 model with the
    tenant's adapter applied by the plain segmented LoRA on the same
    pages, TF32 off), which may prefer the plain token by at most
    ATOL_BANDS x the plain path's max logit error; over every
    teacher-forced prefix the kernel path's mean logit error against the
    oracle may not exceed KERNEL_ERR_RATIO x the plain path's."""
    import numpy as np

    from tpudl_torch.models.llama import LLAMA3_8B, LlamaForCausalLM, bind_params
    from tpudl_torch.models.lora import AdapterView
    from tpudl_torch.serve import Request, ServeSession

    kw = dict(prompt_len=PROMPT_LEN, num_slots=NUM_SLOTS, adapters=adapters,
              adapter_pages=TENANT_PAGES, adapter_rank_max=16)
    plain = LlamaForCausalLM(LLAMA3_8B(dtype=torch.bfloat16,
                                       max_seq_len=MAX_SEQ_LEN,
                                       fused_ops=False), device="meta")
    session = ServeSession.from_model(plain, params, adapter_impl="reference",
                                      **kw)
    plain_results = session.serve([Request(**r.__dict__) for r in requests])
    pool = session.engine.adapter_pool
    oracle = LlamaForCausalLM(LLAMA3_8B(dtype=torch.float32,
                                        max_seq_len=MAX_SEQ_LEN,
                                        fused_ops=False), device="meta")
    params32 = {k: v.float() for k, v in params.items()}

    def logits(m, p, ids, tenant, impl):
        row, scaling = pool.acquire(tenant)
        try:
            view = AdapterView(pool.pools, torch.as_tensor(
                row[None], device="cuda"), torch.tensor(
                [scaling], dtype=torch.float32, device="cuda"), impl)
            with torch.no_grad():
                bind_params(m, p)
                x = torch.as_tensor(ids, device="cuda")[None, :]
                out, _ = m(x, torch.ones_like(x), decode=True, adapters=view)
        finally:
            pool.release(tenant)
        if not bool(torch.isfinite(out).all()):
            fail("tenant_parity: non-finite logits")
        return out[0]

    same, count = 0, 0
    sums = {"kernel": 0.0, "plain": 0.0}
    greedy = [r for r in requests if r.temperature == 0.0]
    for req in greedy:
        got = np.asarray(kernel_results[req.request_id].tokens)
        want = np.asarray(plain_results[req.request_id].tokens)
        diff = np.nonzero(got != want)[0]
        t = int(diff[0]) if diff.size else len(want) - 1
        n0 = len(req.input_ids)
        ids = np.concatenate([np.asarray(req.input_ids), want[:t]])
        ref = logits(oracle, params32, ids, req.tenant, "reference")[n0 - 1:]
        err_k = (logits(model, params, ids, req.tenant, "auto")[n0 - 1:]
                 - ref).abs()
        err_p = (logits(plain, params, ids, req.tenant, "reference")[n0 - 1:]
                 - ref).abs()
        sums["kernel"] += float(err_k.sum())
        sums["plain"] += float(err_p.sum())
        count += err_k.numel()
        if diff.size == 0:
            same += 1
            continue
        atol = ATOL_BANDS * float(err_p.max())
        margin = float(ref[-1, int(want[t])] - ref[-1, int(got[t])])
        print(f"tenant_parity: {req.request_id} (tenant {req.tenant}) parts "
              f"from the plain path at step {t}/{len(want)}: oracle margin "
              f"{margin:.4f}, atol {atol:.4f}")
        if margin > atol:
            fail(f"tenant_parity: {req.request_id}: the oracle prefers the "
                 f"plain token by {margin:.4f} > {atol:.4f}")
    mean_k, mean_p = sums["kernel"] / count, sums["plain"] / count
    print(f"tenant_parity: {same}/{len(greedy)} greedy requests "
          f"token-identical to the plain path; mean |logit - f32 oracle| over "
          f"{count} logits: kernel path {mean_k:.5f}, plain path {mean_p:.5f}")
    if mean_k > KERNEL_ERR_RATIO * mean_p:
        fail(f"tenant_parity: kernel path mean logit error {mean_k:.5f} > "
             f"{KERNEL_ERR_RATIO} x the plain path's {mean_p:.5f}")
    del params32, session
    torch.cuda.empty_cache()
    return {"identical": same, "greedy": len(greedy), "mean_err_kernel": mean_k,
            "mean_err_plain": mean_p}


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
                            num_slots=NUM_SLOTS, capture=False).serve(
        [Request("warm", [1, 2, 3], max_new_tokens=2)]
    )
    greedy, sampled = requests_for(Request, cfg.vocab_size)
    requests = greedy + [sampled]
    runs = {}
    for capture in (False, True):
        runs[capture] = serve_run(
            torch, ServeSession.from_model(model, params,
                                          prompt_len=PROMPT_LEN,
                                          num_slots=NUM_SLOTS,
                                          capture=capture),
            requests, {"rms_norm_fwd": rms_norm, "swiglu_fwd": swiglu})
    out = {}
    for capture, run in runs.items():
        way = "captured" if capture else "eager"
        session, results, wall, launches, peak = run
        eng = session.engine
        calls = eng.num_prefills + eng.num_decode_steps
        print(f"slice ({way}): {len(results)} requests, {eng.num_prefills} "
              f"prefills, {eng.num_decode_steps} decode steps, launches "
              f"{launches}")
        bad = [rid for rid, r in results.items() if not r.ok]
        if bad:
            fail(f"requests not ok: {[(rid, results[rid].finish_reason) for rid in bad]}")
        for req in requests:
            toks = results[req.request_id].tokens
            if len(toks) != req.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks
            ):
                fail(f"request {req.request_id}: {len(toks)} tokens, expected "
                     f"{req.max_new_tokens} in [0, {cfg.vocab_size})")
        want = {"rms_norm_fwd": 65 * calls, "swiglu_fwd": 32 * calls}
        if launches != want:
            fail(f"slice ({way}): kernel launches {launches} != expected "
                 f"{want} (65 RMSNorm and 32 SwiGLU per prefill and decode "
                 f"step)")
        ttft = [r.ttft_s * 1e3 for r in results.values()]
        tpot = [r.tpot_s * 1e3 for r in results.values()
                if r.tpot_s is not None]
        tokens = sum(len(r.tokens) for r in results.values())
        capture_s = getattr(eng.decode_call, "capture_s", None)
        prefill_capture_s = getattr(eng.prefill_call, "capture_s", None)
        prefill = prefill_ms(torch, session)
        print(f"slice metrics, {way} ({card}): TTFT p50 {pct(ttft, 50):.2f} "
              f"ms, p90 {pct(ttft, 90):.2f} ms; TPOT p50 {pct(tpot, 50):.3f} "
              f"ms, p90 {pct(tpot, 90):.3f} ms (earlier, the prefill eager: "
              f"TTFT p50 {EAGER_PREFILL_TTFT_P50_MS}, TPOT p50 "
              f"{EAGER_PREFILL_TPOT_P50_MS}); "
              f"{tokens} tokens in "
              f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; "
              f"{eng.num_decode_steps} decode steps ({wall / max(1, eng.num_decode_steps) * 1e3:.3f} "
              f"ms per step incl. prefills); prefill {prefill:.3f} ms a "
              f"request [1, {PROMPT_LEN}]; peak memory {peak:.2f} GiB"
              + ("" if capture_s is None
                 else f"; decode graph captured in {capture_s * 1e3:.1f} ms, "
                      f"prefill graph in {prefill_capture_s * 1e3:.1f} ms"))
        out[capture] = {
            "ttft_p50_ms": pct(ttft, 50), "tpot_p50_ms": pct(tpot, 50),
            "ttft_p90_ms": pct(ttft, 90), "tpot_p90_ms": pct(tpot, 90),
            "tokens_per_s": tokens / wall,
            "decode_steps": eng.num_decode_steps,
            "prefills": eng.num_prefills, "peak_memory_gib": peak,
            "launches": launches, "capture_s": capture_s,
            "prefill_ms": prefill, "prefill_capture_s": prefill_capture_s,
        }
        # The same requests again on the same session: its graphs exist,
        # so no capture lands inside this window (the first serve's
        # captures do).
        _, again, _, _, _ = serve_run(torch, session, requests, {})
        if any(again[r.request_id].tokens != results[r.request_id].tokens
               for r in requests):
            fail(f"slice ({way}): a second serve on the session gave other "
                 f"tokens")
        s_ttft = [r.ttft_s * 1e3 for r in again.values()]
        s_tpot = [r.tpot_s * 1e3 for r in again.values()
                  if r.tpot_s is not None]
        print(f"slice metrics, {way}, the same requests served again on the "
              f"session ({card}): TTFT p50 {pct(s_ttft, 50):.2f} ms, p90 "
              f"{pct(s_ttft, 90):.2f} ms; TPOT p50 {pct(s_tpot, 50):.3f} ms, "
              f"p90 {pct(s_tpot, 90):.3f} ms")
        out[capture]["again"] = {
            "ttft_p50_ms": pct(s_ttft, 50), "ttft_p90_ms": pct(s_ttft, 90),
            "tpot_p50_ms": pct(s_tpot, 50), "tpot_p90_ms": pct(s_tpot, 90)}
    same_tokens(runs, requests, "slice")
    session, results, _, launches, _ = runs[True]
    metrics = out[True]
    metrics["eager"] = out[False]
    metrics["eager"]["decode_device_busy_share"] = None  # see profile_decode
    metrics["decode_device_busy_share"] = profile_decode(
        torch, model, params, Request)
    return model, params, requests, results, launches, metrics


def serve_run(torch, session, requests, counted):
    """Serve ``requests`` through ``session`` with the ``counted``
    wrappers' counts (name -> wrapper) set to 0 just before: (session,
    results, wall s, launches, peak GiB)."""
    from tpudl_torch.serve import Request

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = session.serve([Request(**r.__dict__) for r in requests])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (session, results, wall,
            {name: fn.launches for name, fn in counted.items()},
            torch.cuda.max_memory_allocated() / 2**30)


def same_tokens(runs, requests, what):
    """The captured session's tokens (prefill and decode captured),
    greedy and sampled, are the eager session's."""
    eager, captured = runs[False][1], runs[True][1]
    differ = [r.request_id for r in requests
              if eager[r.request_id].tokens != captured[r.request_id].tokens]
    if differ:
        fail(f"{what}: the captured session gave other tokens than eager "
             f"for {differ}")
    print(f"{what}: captured prefill and decode tokens equal the eager "
          f"session's for all "
          f"{len(requests)} requests ({sum(r.temperature > 0 for r in requests)} "
          f"sampled)")


# Only captured runs are profiled. Reading back a profile of an eager
# run (its host ops beside its kernels) took 10-30 s a window, 106 s of
# the script's run in all (NVIDIA H100 80GB HBM3, 700.00 W); the eager
# run launches the captured run's kernels, so its device time is the
# captured profile's, and its wall time is printed with its metrics.
def profile_decode(torch, model, params, Request, session_kw=None,
                   tenants=None, session=None):
    """Device busy share and the top kernels and host ops over a steady
    window of decode steps (4 slots busy): the window's wall time is
    taken without the profiler (which slows the host), the device time
    from a second, profiled window of as many steps. ``session_kw`` and
    ``tenants`` (one per slot, in turn) make it the multi-tenant
    session's; ``session``, an idle captured session built with
    ``session_kw``, is used in place of a new one. Returns the busy
    share, or None where the profiler saw no device time."""
    from tpudl_torch.serve import ServeSession

    if session is None:
        session = ServeSession.from_model(
            model, params,
            **(session_kw or dict(prompt_len=PROMPT_LEN, num_slots=NUM_SLOTS)))
    for i in range(NUM_SLOTS):
        session.submit(Request(f"p{i}", list(range(1 + i, 101 + i)),
                               max_new_tokens=40,
                               tenant=tenants[i % len(tenants)] if tenants
                               else None))
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

    def run():
        for _ in range(steps):
            eng.step()

    wd = (session_kw or {}).get("weight_dtype")
    busy = profile_steps(torch, run, steps,
                         f"decode (captured{', ' + wd if wd else ''})", wall_us)
    session.collect()
    return busy


def profile_steps(torch, run, steps, what, wall_us):
    """Profile ``run()`` (``steps`` steps of ``what``) with torch.profiler
    and print the device busy time per step against ``wall_us``, the
    same window's wall time taken without the profiler, and the top
    device kernels and host ops. Returns the busy share. Diagnostic: a
    profiler failure prints 'not measured', returns None and does not
    fail the run. Kernel kinds come from tpudl_torch.train.profiling
    (``KERNEL_KINDS``), the classifier fit's profile reader uses."""
    try:
        from torch.profiler import ProfilerActivity, profile

        from tpudl_torch.train.profiling import device_kind, kernel_stem

        t_all = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - t0) * 1e6
        averages = prof.key_averages()
        kernels = [
            k for k in averages
            if getattr(k, "device_type", None) == torch.autograd.DeviceType.CUDA
        ]
        busy_us = sum(k.self_device_time_total for k in kernels)
        if busy_us <= 0:
            raise RuntimeError("no device time in the trace")
        print(f"profile: {steps} {what} steps, wall {wall_us / steps:.1f} "
              f"us/step ({prof_wall_us / steps:.1f} under the profiler), "
              f"device busy {busy_us / steps:.1f} us/step "
              f"({100 * busy_us / wall_us:.1f}% of the unprofiled step, "
              f"idle {100 * (1 - busy_us / wall_us):.1f}%), "
              f"{sum(k.count for k in kernels) / steps:.0f} kernels/step")
        by_kind = {}
        for k in kernels:
            kind = device_kind(k.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + k.self_device_time_total
        print("profile: device us/step by kind: " + ", ".join(
            f"{kind} {t / steps:.1f} ({100 * t / busy_us:.1f}%)"
            for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1])))
        longest = {}
        for k in kernels:
            kind = device_kind(k.key)
            if (kind not in longest or k.self_device_time_total
                    > longest[kind].self_device_time_total):
                longest[kind] = k
        print("profile: each kind's longest kernel, device us/step: "
              + "; ".join(f"{kind}: {longest[kind].key[:70]} "
                          f"{longest[kind].self_device_time_total / steps:.1f}"
                          for kind in sorted(by_kind, key=lambda k: -by_kind[k])))
        # This repo's kernels by name stem (template arguments dropped):
        # each one's share of the step, which the top list may not reach.
        ours = {}
        for k in kernels:
            if device_kind(k.key) == "this repo's kernels":
                stem = kernel_stem(k.key)
                ours[stem] = ours.get(stem, 0.0) + k.self_device_time_total
        if ours:
            print("profile: this repo's kernels, device us/step: " + ", ".join(
                f"{stem} {t / steps:.1f}"
                for stem, t in sorted(ours.items(), key=lambda kv: -kv[1])))
        quant = sum(t for stem, t in ours.items() if stem.startswith("quant_"))
        if quant:
            # Self time: a dependent launch's wait for the kernel ahead
            # counts as its own, so this is indicative; the step's busy
            # time above is the sound measure.
            print(f"profile: quant_dot device ms a step ({what}; self time, "
                  f"dependent waits included): {quant / steps / 1e3:.4f}")
        for k in sorted(kernels, key=lambda k: -k.self_device_time_total)[:12]:
            print(f"profile:   device {k.self_device_time_total / steps:9.1f} "
                  f"us/step {k.count / steps:6.1f}x  {k.key[:90]}")
        host = [
            k for k in averages
            if getattr(k, "device_type", None) == torch.autograd.DeviceType.CPU
        ]
        for k in sorted(host, key=lambda k: -k.self_cpu_time_total)[:12]:
            print(f"profile:   host {k.self_cpu_time_total / steps:9.1f} "
                  f"us/step {k.count / steps:6.1f}x  {k.key[:90]}")
        print(f"profile: {what}: the window and its processing took "
              f"{time.perf_counter() - t_all:.1f} s")
    except Exception as e:  # diagnostic only
        print(f"profile: not measured ({type(e).__name__}: {e})")
        return None
    return busy_us / wall_us


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


def merged(*errs):
    """Combine ``errors`` results of several outputs of one call."""
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def sum_errors(out, ref, tol=1e-4):
    """``errors`` of an f32 sum over rows (dscale, dbias, db): tol relative
    to each element and to the largest one (the kernel and the plain
    version add the same f32 terms in another order)."""
    return errors(out, ref, tol, tol * float(ref.abs().max()))


def timed_case(row, kernel, plain, library=None, library_name=None,
               plain_calls=20):
    """Add the kernel's, the plain version's and the library call's
    times (``graph_ms``, 20 calls per graph, 5 replays) to a case row."""
    row["ms"] = graph_ms(kernel, calls=20, reps=5)
    row["plain_ms"] = graph_ms(plain, calls=plain_calls, reps=5)
    row["library_ms"] = (None if library is None
                         else library_ms(library, calls=20, reps=5))
    row["library"] = library_name or "none computes this function"
    return row


def eager_us(torch, fn, calls=500):
    """Wall microseconds per eager call of ``fn`` over ``calls`` calls,
    the card drained before and after: the host's cost per call where it
    exceeds the card's."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def beyond_bound(what, nbytes, ops, peak=F32_OPS_PER_S):
    """What a design moves or computes beyond its function (which the
    bound counts), with its least time at the card's rates."""
    return (f"{what} = {(nbytes / HBM_BYTES_PER_S + ops / peak) * 1e6:.3f} "
            f"us at the memory and operation rates")


def case_row(shape, dtype, variant, err, tol, nbytes, ops,
             peak=F32_OPS_PER_S):
    """One kernel case: its shape, dtype, ``errors`` result, tolerance
    and bound (from the bytes it must move and the operations it does at
    ``peak``)."""
    return {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "variant": variant, "max_abs_err": err[0],
            "max_rel_err": err[1], "tol": tol, "ok": err[2],
            "bound": bound(nbytes, ops, peak)}


def train_kernel_phase(torch, F):
    """The training kernels against their plain versions at the BERT-base
    step's shapes (N = 256 x 128 rows; hidden 768, MLP 3072), bf16 and f32,
    plus one unaligned shape (the scalar path), and the norm backward's
    RMS kind at the Llama LoRA step's shapes (frozen scales included).
    Every norm backward runs twice, bit for bit. Times as phase 3
    (CUDA-graph replay), fewer calls per graph at these sizes."""
    from tpudl_torch.ops.mlp_fused import (
        bias_gelu,
        bias_gelu_bwd,
        bias_gelu_bwd_ref,
        bias_gelu_ref,
    )
    from tpudl_torch.ops.norms import (
        _norm_bwd_cuda,
        _norm_fwd_cuda,
        layer_norm_ref,
        norm_bwd,
        norm_bwd_ref,
        norm_stats_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(4321)
    n, eps = BERT_BATCH * BERT_SEQ, 1e-12
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {k: [] for k in TRAIN_LAUNCHES}

    def rand(shape, dtype, scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=g, device="cuda")
        return (scale * t + shift).to(dtype)

    # LayerNorm forward, with the statistics autograd saves.
    for shape, dtype, residual, variant in (
        ((n, 768), bf16, True, "residual, stats (the encoder's 24 calls)"),
        ((n, 768), f32, False, "plain, stats (the embeddings' call)"),
        ((n, 768), bf16, False, "plain, stats"),
        ((4099, 766), bf16, True, "residual, stats, unaligned"),
        ((BERT_LARGE_ROWS, 1024), bf16, True,
         "residual, stats (BERT-large's microbatch of 64 x 128: 48 calls "
         "a microbatch)"),
        ((BERT_LARGE_ROWS, 1024), f32, False,
         "plain, stats (BERT-large's embeddings' call)"),
        ((BERT_LARGE_ROWS, 1024), bf16, False, "plain, stats (BERT-large)"),
    ):
        h, e = shape[1], torch.finfo(dtype).bits // 8
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        x = rand(shape, dtype, 2.0, 0.5)
        r = rand(shape, dtype) if residual else None
        scale = rand((h,), f32, 0.1, 1.0)
        bias = rand((h,), f32, 0.1)
        y, _, mean, rstd = _norm_fwd_cuda("layer", x, scale, bias, r, eps,
                                          False, stats=True)
        want = layer_norm_ref(x, scale, bias, r, eps=eps)
        mref, rref = norm_stats_ref(x, r, kind="layer", eps=eps)
        err = merged(errors(y, want[0] if residual else want, tol),
                     errors(mean, mref, 1e-5), errors(rstd, rref, 1e-5))
        c = case_row(shape, dtype, variant, err, tol,
                shape[0] * h * e * (3 if residual else 2) + 2 * h * 4
                + shape[0] * 8,
                shape[0] * h * (9 if residual else 8))
        # F.layer_norm takes no f32 weight with a bf16 input: its weights
        # are cast to the input's dtype outside the timed call.
        ls, lb = scale.to(dtype), bias.to(dtype)
        cases["layer_norm_fwd"].append(timed_case(
            c,
            lambda: _norm_fwd_cuda("layer", x, scale, bias, r, eps, False,
                                   stats=True),
            lambda: layer_norm_ref(x, scale, bias, r, eps=eps),
            None if residual else (
                lambda: F.layer_norm(x, (h,), ls, lb, eps)),
            None if residual else f"F.layer_norm, {c['dtype']} weights",
        ))

    # The norm backward (dx, dscale, dbias; dx alone with frozen scales).
    for kind, shape, dtype, residual, with_gs, variant in (
        ("layer", (n, 768), bf16, True, False,
         "LayerNorm, residual (the encoder's 24 calls)"),
        ("layer", (n, 768), f32, False, False,
         "LayerNorm, plain (the embeddings' call)"),
        ("layer", (n, 768), bf16, False, False, "LayerNorm, plain"),
        ("rms", (2048, 4096), bf16, True, True,
         "RMSNorm, residual and sum gradient (a Llama training shape)"),
        ("rms", (LLAMA_BATCH * LLAMA_SEQ, 4096), bf16, True, True,
         "RMSNorm, residual and sum gradient (the Llama LoRA step's "
         "microbatch of 4 x 2048)"),
        ("rms", (LLAMA_BATCH * LLAMA_SEQ, 4096), bf16, False, False,
         "RMSNorm, plain (the Llama LoRA microbatch's shape)"),
        ("layer", (4099, 766), bf16, True, False,
         "LayerNorm, residual, unaligned"),
        ("layer", (BERT_LARGE_ROWS, 1024), bf16, True, False,
         "LayerNorm, residual (BERT-large's microbatch: 48 calls)"),
        ("layer", (BERT_LARGE_ROWS, 1024), f32, False, False,
         "LayerNorm, plain (BERT-large's embeddings' call)"),
        ("layer", (BERT_LARGE_ROWS, 1024), bf16, False, False,
         "LayerNorm, plain (BERT-large)"),
        ("rms", (LLAMA_BATCH * LLAMA_SEQ, 4096), bf16, True, True,
         "RMSNorm, residual and sum gradient, frozen scales (the Llama LoRA "
         "step's call: dx alone)"),
    ):
        params = "frozen" not in variant
        h, e = shape[1], torch.finfo(dtype).bits // 8
        tol = BWD_TOL[str(dtype).split(".")[-1]]
        x = rand(shape, dtype, 2.0, 0.5)
        r = rand(shape, dtype) if residual else None
        scale = rand((h,), f32, 0.1, 1.0)
        bias = rand((h,), f32, 0.1)
        gy = rand(shape, dtype)
        gs = rand(shape, dtype) if with_gs else None
        mean, rstd = norm_stats_ref(x, r, kind=kind, eps=eps)

        def kernel():
            if params:
                return norm_bwd(x, scale, r, mean, rstd, gy, gs, kind=kind,
                                impl="fused")
            return _norm_bwd_cuda(kind, x, scale, r, mean, rstd, gy, gs,
                                  params=False)

        dx, dscale, dbias = kernel()
        again = kernel()
        want = norm_bwd_ref(x, scale, r, mean, rstd, gy, gs, kind=kind)
        errs = [errors(dx, want[0], tol)]
        if params:
            errs.append(sum_errors(dscale, want[1]))
        elif dscale is not None or dbias is not None:
            fail(f"norm_bwd {variant}: frozen scales returned their sums")
        if kind == "layer" and params:
            errs.append(sum_errors(dbias, want[2]))
        if not all(a is None or torch.equal(a, b)
                   for a, b in zip((dx, dscale, dbias), again)):
            fail(f"norm_bwd {variant} {tuple(shape)}: two runs differ")
        streams = 3 + int(residual) + int(with_gs)
        stats = 2 if kind == "layer" else 1
        sums = (1 + stats) if params else 1  # the scale in, the sums out
        c = case_row(shape, dtype, variant, merged(*errs), tol,
                shape[0] * h * e * streams + h * 4 * sums
                + shape[0] * 4 * stats,
                shape[0] * h * (14 if params else 11))
        library = library_name = None
        if kind == "layer" and not residual:
            m2, r2 = mean.view(-1, 1), rstd.view(-1, 1)
            ls, lb = scale.to(dtype), bias.to(dtype)
            library = (lambda: torch.ops.aten.native_layer_norm_backward(
                gy, x, [h], m2, r2, ls, lb, [True, True, True]))
            library_name = (f"aten.native_layer_norm_backward, "
                            f"{c['dtype']} weights")
        elif kind == "rms" and not residual and not with_gs:
            # dx and dscale from the saved f32 rstd, as the kernel does.
            r2, ls = rstd.view(-1, 1), scale.to(dtype)
            library = (lambda: torch.ops.aten._fused_rms_norm_backward(
                gy, x, [h], r2, ls, [True, True]))
            library_name = (f"aten._fused_rms_norm_backward, "
                            f"{c['dtype']} weights")
        cases["norm_bwd"].append(timed_case(
            c, kernel,
            lambda: norm_bwd_ref(x, scale, r, mean, rstd, gy, gs, kind=kind),
            library, library_name,
        ))

    # bias + GeLU, forward and backward.
    for shape, dtype, variant in (
        ((n, 3072), bf16, "the encoder's 12 calls"),
        ((n, 3072), f32, "f32"),
        ((4099, 3071), bf16, "unaligned"),
        ((BERT_LARGE_ROWS, 4096), bf16,
         "BERT-large's microbatch (24 calls)"),
    ):
        f, e = shape[1], torch.finfo(dtype).bits // 8
        dname = str(dtype).split(".")[-1]
        x = rand(shape, dtype, 2.0)
        b = rand((f,), f32, 0.5)
        gy = rand(shape, dtype)
        rtol, atol = BG_TOL[dname]
        err = errors(bias_gelu(x, b, impl="fused"), bias_gelu_ref(x, b), rtol,
                     atol)
        c = case_row(shape, dtype, variant, err, [rtol, atol],
                2 * shape[0] * f * e + f * 4, shape[0] * f * 25)
        cases["bias_gelu_fwd"].append(timed_case(
            c, lambda: bias_gelu(x, b, impl="fused"),
            lambda: bias_gelu_ref(x, b)))
        dx, db = bias_gelu_bwd(x, b, gy, impl="fused")
        rdx, rdb = bias_gelu_bwd_ref(x, b, gy)
        tol = BWD_TOL[dname]
        c = case_row(shape, dtype, variant,
                merged(errors(dx, rdx, tol), sum_errors(db, rdb)), tol,
                3 * shape[0] * f * e + 2 * f * 4, shape[0] * f * 40)
        cases["bias_gelu_bwd"].append(timed_case(
            c, lambda: bias_gelu_bwd(x, b, gy, impl="fused"),
            lambda: bias_gelu_bwd_ref(x, b, gy)))
    torch.cuda.empty_cache()
    report_cases(cases)
    return cases


def dropout_contract_checks(torch):
    """The Philox contract on the card: philox.cuh's rounds against
    cuRAND's curand_Philox4x32_10 and the plain twin on Random123's
    known-answer counters and 4096 random ones; then, with zero logits
    (p = 1/128) at [256, 12, 128, 128], the forward's kept entries are the
    plain keep mask bit for bit at a rate within 5 sigma of 0.9, the
    backward (g = 1) regenerates that mask, and it is bitwise
    repeatable."""
    from tpudl_torch.ops import keep_mask
    from tpudl_torch.ops import softmax_dropout as sd

    shape, rate = (BERT_BATCH, BERT_HEADS, BERT_SEQ, BERT_SEQ), 0.1
    n = BERT_BATCH * BERT_HEADS * BERT_SEQ * BERT_SEQ
    gen = torch.Generator(device="cuda").manual_seed(97)
    seed = keep_mask.draw_seed(gen)
    kat = [[0] * 6, [0xFFFFFFFF] * 6,
           [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
            0x299F31D0]]
    words = torch.cat([torch.tensor(kat, dtype=torch.int64),
                       torch.randint(0, 2**32, (4096, 6), dtype=torch.int64,
                                     generator=torch.Generator().manual_seed(1))])
    ours, theirs = sd.philox_pair_cuda(words)
    twin = torch.stack(keep_mask.philox4x32_10(
        *(words[:, j] for j in range(6))), 1)
    if not (torch.equal(ours, theirs) and torch.equal(ours, twin)):
        fail("dropout contract: philox.cuh disagrees with cuRAND's "
             "curand_Philox4x32_10 or the plain twin")
    x = torch.zeros(shape, device="cuda")
    out = sd._sd_fwd_cuda(x, None, seed, False, rate, torch.float32)
    keep = keep_mask.keep_mask(seed, shape, rate)
    bitwise = torch.equal(out != 0, keep)
    share = keep.float().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    g = torch.ones_like(x)
    dx = sd.softmax_dropout_bwd(x, None, seed, g, False, rate, impl="fused")
    # dx = p (g' - <g', p>) with p = 1/128, and <g', p> = sum(out) at g = 1.
    regen = torch.equal(dx * BERT_SEQ + out.sum(-1, keepdim=True)
                        > 0.5 / (1 - rate), keep)
    repeat = torch.equal(dx, sd.softmax_dropout_bwd(x, None, seed, g, False,
                                                    rate, impl="fused"))
    print(f"dropout contract: {len(words)} Philox blocks equal to cuRAND's "
          f"curand_Philox4x32_10 and the plain twin's; keep mask of {n} "
          f"elements bitwise equal to the plain version's: {bitwise}; keep "
          f"rate {share:.6f} (0.9 +- 5 sigma = {5 * sigma:.2e}); backward "
          f"regenerates the mask: {regen}; "
          f"backward bitwise repeatable: {repeat}")
    if not (bitwise and abs(share - (1 - rate)) < 5 * sigma and regen
            and repeat):
        fail("dropout contract: a keep-mask check failed")
    del x, out, keep, g, dx
    torch.cuda.empty_cache()


def fused_kernel_phase(torch, F):
    """The fused slice's four kernels against their plain versions:
    softmax_dropout forward and backward at the BERT-base attention shape
    [256, 12, 128, 128] (bf16 and f32, dropout 0 and 0.1, padding and
    causal masks, and Skv 127 for the scalar path), and the cross-entropy
    forward and backward at the classifier's [256, 2] f32 and at the
    vocab-sized [4096, 30522] (bf16 and f32, label smoothing 0 and 0.1).
    Within FUSED_TOL, the dropped entries equal, each backward bitwise
    repeatable. Times as train kernels (CUDA-graph replay). Library
    calls (no one call computes the masked softmax with dropout): the
    plain softmax in the logits' own dtype, torch.softmax(x, -1) and
    aten._softmax_backward_data(g, y, -1, x.dtype), and beside them
    ("library_f32_ms") the same two in f32; F.cross_entropy(reduction=
    "none", label_smoothing=s) forward, and its forward + backward."""
    from tpudl_torch.ops import keep_mask
    from tpudl_torch.ops import softmax_dropout as sd
    from tpudl_torch.ops.cross_entropy import (
        _xent_fwd_cuda,
        softmax_cross_entropy_ref,
        xent_bwd,
        xent_bwd_ref,
    )

    dropout_contract_checks(torch)
    gen = torch.Generator(device="cuda").manual_seed(8642)
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("softmax_dropout_fwd", "softmax_dropout_bwd", "xent_fwd",
             "xent_bwd")
    cases = {k: [] for k in names}

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def dname(dtype):
        return str(dtype).split(".")[-1]

    def timed(row, kernel, plain, library=None, library_name=None):
        # The plain softmax_dropout takes ~23 ms a call: 10 per graph.
        return timed_case(row, kernel, plain, library, library_name,
                          plain_calls=10)

    full = (BERT_BATCH, BERT_HEADS, BERT_SEQ, BERT_SEQ)
    for shape, dtype, masking, rate, variant in (
        (full, bf16, "padding", 0.1,
         "padding mask, dropout 0.1 (the encoder's 12 calls)"),
        (full, bf16, "causal", 0.0, "causal, no dropout"),
        (full, f32, "padding", 0.1, "f32, padding mask, dropout 0.1"),
        (full, f32, "none", 0.0, "f32, no mask, no dropout"),
        ((64, BERT_HEADS, 127, 127), bf16, "causal", 0.1,
         "Skv 127 (the scalar path), causal, dropout 0.1"),
        ((64, 16, BERT_SEQ, BERT_SEQ), bf16, "padding", 0.1,
         "BERT-large's microbatch, padding mask, dropout 0.1 (24 calls)"),
    ):
        b, skv = shape[0], shape[-1]
        x = rand(shape, dtype, 3.0)
        kvmask = None
        if masking == "padding":
            lengths = torch.randint(skv // 2, skv + 1, (b,), generator=gen,
                                    device="cuda")
            kvmask = (torch.arange(skv, device="cuda")[None, :]
                      < lengths[:, None]).contiguous()
        causal = masking == "causal"
        seed = keep_mask.draw_seed(gen)
        tol = FUSED_TOL[dname(dtype)]
        gy = rand(shape, dtype)
        e = torch.finfo(dtype).bits // 8
        elems = x.numel()
        mask_bytes = 0 if kvmask is None else kvmask.numel()

        def fwd():
            return sd._sd_fwd_cuda(x, kvmask, seed, causal, rate, dtype)

        def fwd_plain():
            return sd.softmax_dropout_ref(x, kvmask, seed, causal, rate, dtype)

        def bwd():
            return sd.softmax_dropout_bwd(x, kvmask, seed, gy, causal, rate,
                                          impl="fused")

        def bwd_plain():
            return sd.softmax_dropout_bwd_ref(x, kvmask, seed, gy, causal, rate)

        out, want = fwd(), fwd_plain()
        err = errors(out, want, *tol)
        if rate and not torch.equal(out == 0, want == 0):
            err = (err[0], err[1], False)
            print(f"softmax_dropout_fwd {variant}: dropped entries differ")
        # Per element: mask, max, exp, sum, divide (~8 f32 operations), and
        # with dropout a quarter of a Philox block (10 rounds of ~10
        # integer operations) plus the compare and the scale.
        ops_fwd = elems * (8 + (28 if rate else 0))
        c = case_row(shape, dtype, variant, err, tol,
                elems * 2 * e + mask_bytes + 16, ops_fwd)
        y = torch.softmax(x, -1)
        y32 = torch.softmax(x, -1, dtype=f32)
        cases["softmax_dropout_fwd"].append(timed(
            c, fwd, fwd_plain, lambda: torch.softmax(x, -1),
            f"torch.softmax(x, -1) in {dname(dtype)}, no mask or dropout"))
        c["library_f32_ms"] = library_ms(
            lambda: torch.softmax(x, -1, dtype=f32), calls=20, reps=5)
        c["library_f32"] = "torch.softmax(x, -1, dtype=float32)"
        dx, want_dx = bwd(), bwd_plain()
        err = errors(dx, want_dx, tol[0], max(tol[1], 1e-5))
        if not torch.equal(dx, bwd()):
            err = (err[0], err[1], False)
            print(f"softmax_dropout_bwd {variant}: not bitwise repeatable")
        g32 = gy.float()
        c = case_row(shape, dtype, variant, err, tol,
                elems * 3 * e + mask_bytes + 16, ops_fwd + elems * 4)
        cases["softmax_dropout_bwd"].append(timed(
            c, bwd, bwd_plain,
            lambda: torch.ops.aten._softmax_backward_data(gy, y, -1, dtype),
            f"aten._softmax_backward_data in {dname(dtype)}, no mask or "
            f"dropout"))
        # The f32 softmax's backward: aten takes a bf16 input dtype only
        # with bf16 gradients.
        c["library_f32_ms"] = library_ms(
            lambda: torch.ops.aten._softmax_backward_data(g32, y32, -1, f32),
            calls=20, reps=5)
        c["library_f32"] = "aten._softmax_backward_data of the f32 softmax"
        del x, gy, out, want, dx, want_dx, y, y32, g32
        torch.cuda.empty_cache()

    for (rows_, v), dtype, smoothing, variant in (
        ((BERT_BATCH, 2), f32, 0.0, "the classifier's loss (1 call each way "
                                    "per step)"),
        ((BERT_BATCH, 2), f32, 0.1, "label smoothing 0.1"),
        ((128, 1000), f32, 0.1, "ResNet-50's loss (imagenet_resnet50_dp: "
                                "label smoothing 0.1, 8 calls each way per "
                                "step)"),
        ((4096, 30522), bf16, 0.0, "vocab-sized head"),
        ((4096, 30522), bf16, 0.1, "vocab-sized head, label smoothing 0.1"),
        ((4096, 30522), f32, 0.0, "vocab-sized head, f32"),
        ((1000, 1003), bf16, 0.1, "V 1003, label smoothing 0.1"),
        ((64, 2), f32, 0.0, "BERT-large's microbatch (4 calls each way a "
                            "step)"),
        ((256, 10), f32, 0.0, "ResNet-18's loss (cifar10_resnet18)"),
    ):
        z = rand((rows_, v), dtype, 3.0)
        labels = torch.randint(0, v, (rows_,), generator=gen, device="cuda")
        g = torch.rand(rows_, generator=gen, device="cuda") * 2
        e = torch.finfo(dtype).bits // 8
        loss, lse = _xent_fwd_cuda(z, labels, smoothing)
        err = merged(
            errors(loss, softmax_cross_entropy_ref(z, labels, smoothing),
                   1e-5),
            errors(lse, torch.logsumexp(z.float(), -1), 1e-5))
        elems = rows_ * v
        c = case_row((rows_, v), dtype, variant, err, (1e-5, 1e-5),
                elems * e + rows_ * (8 + 4 + 4), elems * (6 if smoothing else 5))
        zl = z.detach().requires_grad_(True)
        cases["xent_fwd"].append(timed(
            c, lambda: _xent_fwd_cuda(z, labels, smoothing),
            lambda: softmax_cross_entropy_ref(z, labels, smoothing),
            lambda: F.cross_entropy(z, labels, reduction="none",
                                    label_smoothing=smoothing),
            "F.cross_entropy(reduction='none', label_smoothing=s), forward"))
        tol = FUSED_TOL[dname(dtype)]
        dz = xent_bwd(z, labels, lse, g, smoothing, impl="fused")
        err = errors(dz, xent_bwd_ref(z, labels, lse, g, smoothing), tol[0],
                     max(tol[1], 1e-6))
        if not torch.equal(dz, xent_bwd(z, labels, lse, g, smoothing,
                                        impl="fused")):
            err = (err[0], err[1], False)
            print(f"xent_bwd {variant}: not bitwise repeatable")
        c = case_row((rows_, v), dtype, variant, err, tol,
                2 * elems * e + rows_ * (8 + 4 + 4), elems * 6)

        def library_fwd_bwd():
            out = F.cross_entropy(zl, labels, reduction="none",
                                  label_smoothing=smoothing)
            return torch.autograd.grad(out, zl, g)

        cases["xent_bwd"].append(timed(
            c, lambda: xent_bwd(z, labels, lse, g, smoothing, impl="fused"),
            lambda: xent_bwd_ref(z, labels, lse, g, smoothing),
            library_fwd_bwd,
            "F.cross_entropy forward + backward (torch.autograd.grad)"))
        del z, zl, dz
        torch.cuda.empty_cache()
    report_cases(cases)
    return cases


def sst2_optimizer():
    """The sst2_bert_base optimizer stack at a constant learning rate, as
    bench.py:_bench_bert runs it (steady-state steps are alike)."""
    import dataclasses

    from tpudl_torch.config import get_config
    from tpudl_torch.train import make_optimizer

    return make_optimizer(dataclasses.replace(
        get_config("sst2_bert_base").optim, schedule="constant",
        warmup_steps=0))


def counted():
    """Kernel name -> (the wrapper that counts its launches, the counter's
    attribute)."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu
    from tpudl_torch.ops import softmax_dropout as sd
    from tpudl_torch.ops.cross_entropy import softmax_cross_entropy, xent_bwd
    from tpudl_torch.ops.mlp_fused import (
        bias_gelu,
        bias_gelu_bwd,
        swiglu,
        swiglu_bwd,
    )
    from tpudl_torch.ops.norms import layer_norm, norm_bwd, rms_norm
    from tpudl_torch.ops.quant_dot import quant_matmul

    out = {"layer_norm_fwd": layer_norm, "norm_bwd": norm_bwd,
           "bias_gelu_fwd": bias_gelu, "bias_gelu_bwd": bias_gelu_bwd,
           "rms_norm_fwd": rms_norm, "swiglu_fwd": swiglu,
           "swiglu_bwd": swiglu_bwd,
           "softmax_dropout_fwd": sd.softmax_dropout,
           "softmax_dropout_bwd": sd.softmax_dropout_bwd,
           "xent_fwd": softmax_cross_entropy, "xent_bwd": xent_bwd,
           "fused_attn_fwd": fu.fused_attention_fwd,
           "fused_attn_bwd": fu.fused_attention_bwd,
           "quant_dot": quant_matmul}
    out = {name: (fn, "launches") for name, fn in out.items()}
    for name in ("fwd", "dq", "dkv"):
        out[f"flash_{name}"] = (fa.flash_attention, f"launches_{name}")
    return out


def train_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in counted().items()}


def reset_counts():
    for fn, attr in counted().values():
        setattr(fn, attr, 0)


def bert_variant(fused_slice):
    """(model config kwargs, loss_impl) of the kernel path: the train
    phase's step (fused_ops=True), or the fused slice on top of it
    (attention_impl="fused", loss_impl="auto", as bench.py's fused
    variant runs it)."""
    if fused_slice:
        return {"fused_ops": True, "attention_impl": "fused"}, "auto"
    return {"fused_ops": True}, "reference"


def tiny_train_phase(torch, fused_slice=False):
    """One train step of a BERT_TINY-shaped model (hidden 128, 2 layers) in
    f32 with dropout off: the kernels on the card against the CPU plain
    path, same weights and batch (two rows padded). tpudl's bands
    (tests/test_fused_ops_integration.py:75-91): loss rtol 1e-4 / atol
    1e-5, every gradient 1e-4, the parameters after the update rtol
    2e-3 / atol 2e-5. With ``fused_slice`` the step runs the slice's
    attention and loss kernels too."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BERT_TINY, BertForSequenceClassification
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import create_train_state, make_classification_train_step

    name = "tiny_train_fused" if fused_slice else "tiny_train"
    model_kw, loss_impl = bert_variant(fused_slice)
    cfg = BERT_TINY(dtype=torch.float32, hidden_dropout=0.0,
                    attention_dropout=0.0, **model_kw)
    ref = BertForSequenceClassification(cfg, device="cpu")
    ref.init_weights(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    batch = next(synthetic_token_batches(8, 32, cfg.vocab_size, seed=5))
    batch["attention_mask"][1, 20:] = 0
    batch["attention_mask"][5, 9:] = 0
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), label_key="label",
        loss_impl=loss_impl)
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(
            0, BertForSequenceClassification(cfg, device="meta"),
            sst2_optimizer(),
            params={k: v.to(dev) for k, v in params.items()}, device=dev)
        before = train_counts()
        grads, metrics = step.grads_and_metrics(state, batch, fold_in(1, 0, dev))
        state, _ = step(state, batch, 1)
        after = train_counts()
        per_pass = launches_per_step(cfg.num_layers, fused_slice)
        launched = {k: after[k] - before[k] for k in per_pass}
        # Two forward and backward passes: grads_and_metrics, then the step.
        want = {k: 2 * v if dev == "cuda" else 0 for k, v in per_pass.items()}
        if launched != want:
            fail(f"{name}: kernel launches {launched} on {dev}, "
                 f"expected {want}")
        out[dev] = (float(metrics["loss"]),
                    {k: g.cpu() for k, g in grads.items()},
                    {k: v.detach().cpu() for k, v in state.model.state_dict().items()})
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    if not abs(lg - lc) <= 1e-5 + 1e-4 * abs(lc):
        fail(f"{name}: loss {lg} on the card vs {lc} on the CPU")
    worst_g = max(float((gg[k] - gc[k]).abs().max()) for k in gc)
    bad = [k for k in gc if not torch.allclose(gg[k], gc[k], rtol=1e-4,
                                                atol=1e-4)]
    bad += [k for k in pc if not torch.allclose(pg[k], pc[k], rtol=2e-3,
                                                 atol=2e-5)]
    if bad:
        fail(f"{name}: card vs CPU disagree in {bad[:5]}")
    worst_p = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    print(f"{name}: f32 BERT_TINY train step ({model_kw}, loss_impl="
          f"{loss_impl!r}), kernels on the card vs plain "
          f"on the CPU: loss {lg:.6f} vs {lc:.6f}, max |grad diff| "
          f"{worst_g:.3e} (tol 1e-4), max |param diff| after the update "
          f"{worst_p:.3e} (rtol 2e-3, atol 2e-5)")


def train_phase(torch, card, fused_slice=False, batch_size=BERT_BATCH,
                seq=BERT_SEQ, name=None):
    """BERT-base through the user's entry points, twice from the same
    seeded weights over the same batches: eagerly, then through
    compile_step (its first call eager, its second the capture, then
    replays). Each way W warm-up steps, then TRAIN_STEPS timed steps
    (counts reset just before; exact launches a step), then a profiled
    window, at ``batch_size`` x ``seq``, dropout 0.1; the captured run's
    losses, and its parameters, optimizer state and step count after the
    timed steps, equal the eager run's bit for bit. With ``fused_slice``
    (the train_fused and train_512 phases) the model runs
    attention_impl="fused" and the step loss_impl="auto", and one eval
    batch through make_classification_eval_step follows, eager and
    captured (counts reset just before each; equal bit for bit)."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        fit,
        make_classification_eval_step,
        make_classification_train_step,
    )
    from tpudl_torch.train.metrics import (
        Throughput,
        device_peak_flops,
        mfu,
        transformer_train_flops,
    )

    name = name or ("train_fused" if fused_slice else "train")
    model_kw, loss_impl = bert_variant(fused_slice)
    per_step = launches_per_step(12, fused_slice, seq)
    keys = ("input_ids", "attention_mask")
    step = make_classification_train_step(input_keys=keys, label_key="label",
                                          loss_impl=loss_impl)
    steps = TRAIN_WARMUP_STEPS + TRAIN_STEPS + PROFILE_STEPS
    w = TRAIN_WARMUP_STEPS
    batches = None
    runs = {}
    for capture in (False, True):
        way = "captured" if capture else "eager"
        t0 = time.perf_counter()
        model = build_model("bert-base", 2, **model_kw)
        state = create_train_state(0, model, sst2_optimizer())
        n_params = sum(p.numel() for p in model.parameters())
        if batches is None:
            batches = list(synthetic_token_batches(
                batch_size, seq, model.cfg.vocab_size, num_batches=steps))
        run_step = compile_step(step, state) if capture else step
        losses = []
        # The window opens once the last warm-up step has finished.
        meter = Throughput(batch_size, warmup=w)

        def recorded(state, batch, rng, run_step=run_step, losses=losses,
                     meter=meter):
            state, metrics = run_step(state, batch, rng)
            losses.append(metrics["loss"])
            meter.step(metrics["loss"])
            return state, metrics

        torch.cuda.synchronize()
        print(f"{name} ({way}): BERT-base ({model_kw}, loss_impl="
              f"{loss_impl!r}), {n_params / 1e6:.2f} M parameters, batch "
              f"{batch_size} x seq {seq}, set-up "
              f"{time.perf_counter() - t0:.1f} s")
        # Peak memory over the warm-up too: a captured step allocates its
        # activations once, in the capture, from the graph's own pool.
        torch.cuda.reset_peak_memory_stats()
        state, _, _ = fit(recorded, state, batches[:w], 1)
        reset_counts()
        state, last, _ = fit(recorded, state, batches[w:w + TRAIN_STEPS], 1)
        timed = meter.result(losses[-1])
        launches = train_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
        print(f"{name} ({way}): {TRAIN_STEPS} steps, launches {launches}")
        if launches != want:
            fail(f"{name} ({way}): kernel launches {launches} != expected "
                 f"{want} ({per_step} per step, none of the others)")
        loss_t = torch.stack(losses)
        if not bool(torch.isfinite(loss_t).all()):
            fail(f"{name}: non-finite loss in {loss_t.tolist()}")
        if timed["steps_measured"] != TRAIN_STEPS:
            fail(f"{name}: the meter timed {timed['steps_measured']} steps, "
                 f"not {TRAIN_STEPS}")
        step_s = timed["step_ms"] / 1e3
        flops = transformer_train_flops(n_params, batch_size * seq)
        peak_flops = device_peak_flops()
        util = mfu(flops, step_s, peak_per_chip=peak_flops)
        capture_s = getattr(run_step, "capture_s", None)
        print(f"{name} metrics, {way} ({card}): step {step_s * 1e3:.2f} ms, "
              f"{batch_size / step_s:.1f} samples/s, MFU {100 * util:.2f}% "
              f"(6ND = {flops:.3e} FLOP over {peak_flops / 1e12:.0f} TFLOP/s "
              f"dense bf16), peak memory {peak:.2f} GiB, losses "
              f"{loss_t[0].item():.4f} -> {last['loss']:.4f}"
              + ("" if capture_s is None
                 else f", step captured in {capture_s:.3f} s"))
        snapshot = (loss_t.clone(), {k: v.detach().clone() for k, v in
                                     state.model.state_dict().items()},
                    {k: {n: t.clone() for n, t in v.items()}
                     for k, v in state.opt_state.items()
                     if isinstance(v, dict)}, state.step)
        rest = batches[w + TRAIN_STEPS:]
        if capture:
            busy = profile_steps(
                torch, lambda: fit(run_step, state, rest, 1), PROFILE_STEPS,
                f"{name} ({way})", step_s * 1e6 * PROFILE_STEPS)
        else:
            # The eager run takes the same steps unprofiled (see
            # profile_decode).
            fit(run_step, state, rest, 1)
            busy = None
        metrics = {
            "step_ms": step_s * 1e3, "samples_per_s": batch_size / step_s,
            "mfu": util, "peak_memory_gib": peak, "device_busy_share": busy,
            "num_params": n_params, "steps": TRAIN_STEPS,
            "batch": batch_size, "seq": seq, "capture_s": capture_s,
        }
        if not capture:
            # The same batches without the optimizer update.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b, batch in enumerate(rest):
                step.grads_and_metrics(state, batch, fold_in(1, b, "cuda"))
            torch.cuda.synchronize()
            fwd_bwd_ms = (time.perf_counter() - t0) / len(rest) * 1e3
            print(f"{name}: forward and backward alone {fwd_bwd_ms:.2f} ms "
                  f"per step; the optimizer update (clip, AdamW) and the "
                  f"rest {step_s * 1e3 - fwd_bwd_ms:.2f} ms")
            metrics["forward_backward_ms"] = fwd_bwd_ms
        if fused_slice:
            evaluate = make_classification_eval_step(input_keys=keys,
                                                     loss_impl=loss_impl)
            if capture:
                evaluate = compile_step(evaluate, state, has_rng=False)
                evaluate(state, batches[1])  # the eager warm-up call
            evs = []
            for _ in range(2 if capture else 1):
                torch.cuda.synchronize()
                reset_counts()
                evs.append(evaluate(state, batches[0]))
                ev_launches = train_counts()
                want = {k: eval_launches(12, seq).get(k, 0)
                        for k in ev_launches}
                if ev_launches != want:
                    fail(f"{name} ({way}): the eval batch launched "
                         f"{ev_launches}, expected {want}")
            ev = {k: float(v) for k, v in evs[-1].items()}
            if not all(v == v and abs(v) != float("inf") for v in ev.values()):
                fail(f"{name}: non-finite eval metrics {ev}")
            print(f"{name} ({way}): one eval batch through "
                  f"make_classification_eval_step(loss_impl={loss_impl!r})"
                  f": loss {ev['loss']:.4f}, accuracy {ev['accuracy']:.4f}, "
                  f"launches {ev_launches}")
            metrics["eval"] = ev
            metrics["eval_tensors"] = evs[-1]
        runs[capture] = (state if capture else None, launches, metrics,
                         snapshot)
        if not capture:
            del state, model, run_step
            gc.collect()
            torch.cuda.empty_cache()
    state, launches, metrics, snapshot = runs[True]
    eager = runs[False][2]
    check_bitwise(name, runs[False][3], snapshot)
    if fused_slice:
        a, b = eager.pop("eval_tensors"), metrics.pop("eval_tensors")
        if not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"{name}: the captured eval step's metrics {b} are not the "
                 f"eager step's {a}")
    metrics["eager"] = eager
    return state, launches, metrics


def check_bitwise(name, eager, captured, names=("captured", "eager")):
    """Hold a captured run's (losses, state_dict, optimizer state, step)
    to the eager run's, bit for bit (``names``: what the two runs are)."""
    (l0, p0, o0, s0), (l1, p1, o1, s1) = eager, captured
    mine, theirs = names
    if not torch_equal(l0, l1):
        fail(f"{name}: {mine} losses {l1.tolist()} are not the {theirs} "
             f"run's {l0.tolist()}")
    bad = [k for k in p0 if not torch_equal(p0[k], p1[k])]
    bad += [f"{k}/{n}" for k in o0 for n in o0[k]
            if not torch_equal(o0[k][n], o1[k][n])]
    if bad or s0 != s1:
        fail(f"{name}: after the {mine} steps {len(bad)} tensors differ "
             f"from the {theirs} run's (e.g. {bad[:5]}), steps {s1} vs {s0}")
    print(f"{name}: {mine} equal to {theirs} bit for bit: {len(l0)} losses, "
          f"{len(p0)} parameters and statistics, "
          f"{sum(len(v) for v in o0.values())} optimizer tensors, step {s1}")


def torch_equal(a, b):
    """Bit for bit: the same shape, dtype and bytes (NaNs and signed zeros
    included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[
            a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return torch.equal(a, b)


#: Gradients the parity gate cannot judge (see train_parity_phase).
UNGATED = {
    "attention.key.bias": "zero in exact arithmetic (softmax is invariant "
                          "to a per-row shift), so the oracle's value is "
                          "f32 roundoff",
    "classifier.bias": "the batch mean of softmax - onehot: one free number "
                       "per batch, held instead by the per-example losses",
}


def train_parity_phase(torch, fused_slice=False, batch_size=BERT_BATCH,
                       seq=BERT_SEQ, num_layers=12, phase=None):
    """The kernel path, the plain bf16 path (fused_ops=False) and an f32
    oracle (plain, TF32 off), from the same fresh BERT-base weights
    (``num_layers`` of them; batches of ``batch_size`` x ``seq``), over
    PARITY_BATCHES batches, each with its own dropout seed shared by the
    three paths (the kernels draw no bits, so the masks are the same).
    With ``fused_slice`` (train_fused_parity) the kernel path also runs
    attention_impl="fused" and loss_impl="auto", against the plain path's
    "reference" for both; attention dropout is 0 and hidden dropout 0.1,
    so the fused attention draws no seed words and every path draws the
    same bits in the same order.
    Per path the errors against the oracle accumulate over the batches:
    relative L2 error of the per-example losses, of every gradient tensor
    and of all gradients together. The kernel path's may not exceed
    KERNEL_ERR_RATIO x the plain path's for the losses, the whole
    gradient and each tensor but those UNGATED names (printed, not
    judged). A batch-mean loss is one number per batch; its ratio is
    printed too."""
    import torch.nn.functional as F

    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BERT_BASE, BertForSequenceClassification
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import create_train_state, make_classification_train_step

    phase = phase or ("train_fused_parity" if fused_slice else "train_parity")
    init = BertForSequenceClassification(BERT_BASE(num_layers=num_layers),
                                         device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    params = {k: v.detach() for k, v in init.state_dict().items()}
    keys = ("input_ids", "attention_mask")
    kernel_kw, kernel_loss = bert_variant(fused_slice)
    common = {"num_layers": num_layers}
    if fused_slice:
        common["attention_dropout"] = 0.0
    paths = {"kernel": (torch.bfloat16, kernel_kw, kernel_loss),
             "plain": (torch.bfloat16, {"fused_ops": False}, "reference"),
             "oracle": (torch.float32, {"fused_ops": False}, "reference")}
    states, steps = {}, {}
    for name, (dtype, kw, loss_impl) in paths.items():
        states[name] = create_train_state(
            0, BertForSequenceClassification(
                BERT_BASE(dtype=dtype, **common, **kw), device="meta"),
            sst2_optimizer(), params=params)
        steps[name] = make_classification_train_step(
            input_keys=keys, label_key="label", loss_impl=loss_impl)
    counted_kernels = launches_per_step(num_layers, fused_slice, seq)
    del init, params
    sq = {name: {} for name in ("kernel", "plain", "oracle")}

    def acc(name, key, value):
        sq[name][key] = sq[name].get(key, 0.0) + value

    for b, batch in enumerate(synthetic_token_batches(
            batch_size, seq, 30522, seed=9, num_batches=PARITY_BATCHES)):
        out = {}
        for name, st in states.items():
            before = train_counts()
            grads, metrics = steps[name].grads_and_metrics(
                st, batch, fold_in(7, b, "cuda"))
            with torch.no_grad():
                t = {k: torch.as_tensor(batch[k], device="cuda") for k in batch}
                logits = st.model(t["input_ids"], t["attention_mask"],
                                  train=True, generator=fold_in(7, b, "cuda"))
                losses = F.cross_entropy(logits.float(), t["label"].long(),
                                         reduction="none")
            after = train_counts()
            launched = {k: after[k] - before[k] for k in counted_kernels}
            if name == "kernel" and not all(launched.values()):
                fail(f"{phase}: the kernel path launched {launched}")
            if name != "kernel" and any(launched.values()):
                fail(f"{phase}: the {name} path launched {launched}")
            out[name] = (losses.double(), metrics["loss"].double(),
                         {k: g.double() for k, g in grads.items()})
        lo, mo, go = out["oracle"]
        acc("oracle", "losses", float((lo * lo).sum()))
        acc("oracle", "mean_loss", float(mo * mo))
        for k, g in go.items():
            acc("oracle", k, float((g * g).sum()))
        for name in ("kernel", "plain"):
            losses, mean, grads = out[name]
            acc(name, "losses", float(((losses - lo) ** 2).sum()))
            acc(name, "mean_loss", float((mean - mo) ** 2))
            for k, g in grads.items():
                acc(name, k, float(((g - go[k]) ** 2).sum()))
        del out
    tensors = [k for k in sq["oracle"] if k not in ("losses", "mean_loss")]
    gated = [k for k in tensors if not any(k.endswith(u) for u in UNGATED)]
    for name in ("kernel", "plain", "oracle"):
        sq[name]["all gated gradients"] = sum(sq[name][k] for k in gated)
    err = {name: {k: (sq[name][k] / sq["oracle"][k]) ** 0.5
                  if sq["oracle"][k] > 0 else sq[name][k] ** 0.5
                  for k in sq["oracle"]}
           for name in ("kernel", "plain")}
    ratio = {k: err["kernel"][k] / max(err["plain"][k], 1e-300)
             for k in sq["oracle"]}
    judged = ["losses", "all gated gradients"] + gated
    worst = sorted(judged, key=lambda k: -ratio[k])[:5]
    shown = ", ".join(f"{k} {ratio[k]:.3f} ({err['kernel'][k]:.3e} vs "
                      f"{err['plain'][k]:.3e})" for k in worst)
    free = ", ".join(f"{k} {ratio[k]:.3f}" for k in tensors if k not in gated)
    print(f"{phase}: {PARITY_BATCHES} batches, rel L2 err vs the f32 "
          f"oracle, kernel vs plain path: per-example losses "
          f"{err['kernel']['losses']:.3e} vs {err['plain']['losses']:.3e}; "
          f"batch-mean loss {err['kernel']['mean_loss']:.3e} vs "
          f"{err['plain']['mean_loss']:.3e} (not judged); all gated "
          f"gradients ({len(gated)} tensors) "
          f"{err['kernel']['all gated gradients']:.4e} vs "
          f"{err['plain']['all gated gradients']:.4e}; worst judged ratios: "
          f"{shown}; ungated: {free}")
    bad = [k for k in judged if ratio[k] > KERNEL_ERR_RATIO]
    if bad:
        fail(f"{phase}: the kernel path's error exceeds "
             f"{KERNEL_ERR_RATIO} x the plain path's in {bad}")
    del states
    torch.cuda.empty_cache()
    return {"batches": PARITY_BATCHES,
            "losses_rel_err": {n: err[n]["losses"] for n in err},
            "mean_loss_rel_err": {n: err[n]["mean_loss"] for n in err},
            "gradients_rel_err": {n: err[n]["all gated gradients"]
                                  for n in err},
            "worst_ratio": [worst[0], ratio[worst[0]]]}


# ---------------------------------------------------------------------------
# the Llama LoRA slice
# ---------------------------------------------------------------------------

#: The Llama-3-8B LoRA fine-tune step (llama3_8b_lora): its global batch
#: 64 as 16 microbatches of 4 rows.
LLAMA_BATCH = 4
LLAMA_ACCUM = 16
LLAMA_SEQ = 2048
LLAMA_WARMUP_STEPS = 1
LLAMA_STEPS = 2
LLAMA_PROFILE_STEPS = 1
LLAMA_PARITY_BATCHES = 4
#: The Llama LoRA step's peak memory bound at 16 x 4 (PERF.md §2).
LLAMA_PEAK_GIB = 75.0
#: Flash kernels vs their plain versions, relative to each element plus
#: the size of its row (``flash_errors``): bf16 two bf16 steps (the
#: kernel rounds p and ds relative to its running max and sums in another
#: order), f32 the summation order only.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: The error planted on one 64-row tile to prove ``flash_errors`` sees it.
FLASH_PLANTED = 0.05


def llama_launches_per_step(num_layers, accum=1, remat=False):
    """Kernel launches per Llama LoRA train step of ``accum``
    microbatches: per microbatch and layer one flash forward, dQ and
    dK/dV, one SwiGLU each way and two RMSNorms forward; the final norm.
    Backward, every norm but the first layer's input norm: its input is
    the frozen embedding's output, which needs no gradient, so autograd
    runs no backward there (tpudl's jax.grad differentiates the frozen
    scales too). Under ``remat`` the backward recomputes each block's
    forward: its forward kernels launch twice."""
    n, f = num_layers, 2 if remat else 1
    per = {"flash_fwd": f * n, "flash_dq": n, "flash_dkv": n,
           "swiglu_fwd": f * n, "swiglu_bwd": n,
           "rms_norm_fwd": 2 * f * n + 1, "norm_bwd": 2 * n}
    return {k: accum * v for k, v in per.items()}



def flash_errors(out, ref, dtype):
    """(max abs error, worst ratio, within tolerance): the worst of two
    ratios, each at most FLASH_TOL — a row's L2 error over the row's L2
    norm (rows over the head dim), and an element's error over its
    |ref| plus its row's largest |ref|. Both scale with the row, not
    with the tensor's largest value: a causal row that averages over
    1000+ keys is ~100x smaller than the first rows, and a tile of such
    rows wrong by a few percent must fail. Rows below 1e-2 of the
    tensor's RMS are held to that: dQ's first row of each head is 0 up to
    f32 rounding (its one key's ds cancels), and that noise differs
    between any two summation orders."""
    tol = FLASH_TOL[str(dtype).split(".")[-1]]
    r = ref.float()
    d = (out.float() - r).abs()
    floor = 1e-2 * float(r.square().mean().sqrt())
    norm = r.square().sum(-1).sqrt().clamp_min(floor * r.shape[-1] ** 0.5)
    row_max = r.abs().amax(-1, keepdim=True).clamp_min(floor)
    worst = max(float((d.square().sum(-1).sqrt() / norm).max()),
                float((d / (r.abs() + row_max)).max()))
    return float(d.max()), worst, worst <= tol


def flash_check_sees(out, ref, dtype, rows):
    """Whether ``flash_errors`` rejects ``out`` with FLASH_PLANTED planted
    on the rows ``rows`` of the sequence axis (1) — one 64-row tile."""
    planted = out.float().clone()  # .float() of an f32 tensor is itself
    planted[:, rows] *= 1.0 + FLASH_PLANTED
    return not flash_errors(planted, ref, dtype)[2]


def dead_rows_zero(kvmask, *grads):
    """Whether the kv rows the padding mask drops (among them whole kv
    blocks, which the bf16 dK/dV kernel skips) got dK and dV of exactly
    0."""
    dead = ~kvmask
    return all(not bool(g[dead].any()) for g in grads)


def attended_pairs(torch, b, sq, skv, kvmask, causal):
    """(q, kv) pairs that attend, summed over the batch: the work the
    kernels do for these inputs (causal tiles that cannot contribute are
    skipped, masked entries inside a tile still cost)."""
    keep = kvmask[:, None, :].expand(b, sq, skv)
    if causal:
        qi = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
        keep = keep & (torch.arange(skv, device="cuda")[None, :] <= qi)
    return int(keep.sum())


def llama_kernel_phase(torch, F):
    """The slice's four kernels against their plain versions. The SwiGLU
    backward at the Llama step's [8192, 14336] (bf16, f32, and unaligned
    pointers for the scalar path). Flash forward, dQ and dK/dV at the
    step's [4, 2048, 32, 128] bf16 causal with the all-ones mask, then
    with a padding mask, Sq 1024 != Skv 2048, ragged 1000 / 1500, D 64
    and 32, f32, and dropout 0.1 at [8, 1024, 12, 64]; each backward run
    twice and compared bit for bit. Then the dropout contract: the keep
    mask at [8, 1024, 12, 64] bitwise equal to the plain one at a rate
    within 5 sigma of 0.9, and the dropout-on output equal to
    hybrid_attention's on the same seed words at S = 128. Times as the
    training kernels (CUDA-graph replay); the plain dQ and dK/dV rows time
    the whole plain backward. Library calls:
    F.scaled_dot_product_attention forward, and forward + backward (for
    the dQ and dK/dV rows), on [B, H, S, D] copies; none computes the
    SwiGLU backward."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import keep_mask
    from tpudl_torch.ops.mlp_fused import (
        swiglu,
        swiglu_bwd,
        swiglu_bwd_ref,
        swiglu_ref,
    )
    from tpudl_torch.ops.norms import _norm_fwd_cuda, norm_stats_ref, rms_norm_ref
    from tpudl_torch.ops.softmax_dropout import hybrid_attention

    gen = torch.Generator(device="cuda").manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {k: [] for k in ("rms_norm_fwd", "swiglu_fwd", "swiglu_bwd",
                             "flash_fwd", "flash_dq", "flash_dkv")}

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    n, f, hidden = LLAMA_BATCH * LLAMA_SEQ, 14336, 4096
    tol = KERNEL_TOL["bfloat16"]
    # The RMSNorm forward with the row statistics autograd saves.
    for residual, variant in (
        (False, "plain, stats (the step's 32 input norms and the final one)"),
        (True, "residual+sum, stats (the step's 32 post-attention norms)"),
    ):
        x = rand((n, hidden), bf16)
        r = rand((n, hidden), bf16) if residual else None
        scale = 1 + 0.1 * torch.randn(hidden, generator=gen, device="cuda")

        def kernel():
            return _norm_fwd_cuda("rms", x, scale, None, r, 1e-5, residual,
                                  stats=True)

        y, summed, _, rstd = kernel()
        want = rms_norm_ref(x, scale, r)
        errs = [errors(y, want[0] if residual else want, tol),
                errors(rstd, norm_stats_ref(x, r, kind="rms", eps=1e-5)[1],
                       1e-5)]
        if residual:
            errs.append(errors(summed, want[1], tol))
        err = merged(*errs)
        again = kernel()
        if not (torch.equal(y, again[0]) and torch.equal(rstd, again[3])):
            err = (err[0], err[1], False)
            print(f"rms_norm_fwd {variant}: not bitwise repeatable")
        # x (and r) in, y (and the sum) out, the scale and rstd.
        c = case_row((n, hidden), bf16, variant, err, tol,
                     n * hidden * 2 * (4 if residual else 2) + hidden * 4
                     + n * 4, n * hidden * (5 if residual else 4))
        cases["rms_norm_fwd"].append(timed_case(
            c, kernel, lambda: rms_norm_ref(x, scale, r),
            None if residual else (
                lambda: F.rms_norm(x, (hidden,), scale, 1e-5)),
            None if residual else "F.rms_norm, f32 weight"))
        del x, r, y, summed, rstd, want, again
        torch.cuda.empty_cache()
    gate, up = rand((n, f), bf16, 2.0), rand((n, f), bf16)
    y = swiglu(gate, up, impl="fused")
    err = errors(y, swiglu_ref(gate, up), tol)
    if not torch.equal(y, swiglu(gate, up, impl="fused")):
        err = (err[0], err[1], False)
        print("swiglu_fwd at the Llama step's shape: not bitwise repeatable")
    cases["swiglu_fwd"].append(timed_case(
        case_row((n, f), bf16, "the Llama step's 32 calls", err, tol,
                 3 * n * f * 2, 6 * n * f),
        lambda: swiglu(gate, up, impl="fused"), lambda: swiglu_ref(gate, up)))
    del gate, up, y
    torch.cuda.empty_cache()
    for shape, dtype, unaligned, variant in (
        ((n, f), bf16, False, "the Llama step's 32 calls"),
        ((n, f), f32, False, "f32"),
        ((4099, 14335), bf16, True, "unaligned pointers (the scalar path)"),
    ):
        elems = shape[0] * shape[1]

        def make(scale):
            if unaligned:
                return rand((elems + 1,), dtype, scale)[1:]
            return rand(shape, dtype, scale)

        gate, up, go = make(3.0), make(1.0), make(1.0)
        tol = KERNEL_TOL[str(dtype).split(".")[-1]]
        dg, du = swiglu_bwd(gate, up, go, impl="fused")
        rdg, rdu = swiglu_bwd_ref(gate, up, go)
        err = merged(errors(dg, rdg, tol), errors(du, rdu, tol))
        if not torch.equal(dg, swiglu_bwd(gate, up, go, impl="fused")[0]):
            err = (err[0], err[1], False)
            print(f"swiglu_bwd {variant}: not bitwise repeatable")
        e = torch.finfo(dtype).bits // 8
        # Three streams in, two out; per element a sigmoid (exp, divide)
        # and ~12 f32 operations.
        c = case_row(shape, dtype, variant, err, tol, 5 * elems * e,
                     elems * 16)
        cases["swiglu_bwd"].append(timed_case(
            c, lambda: swiglu_bwd(gate, up, go, impl="fused"),
            lambda: swiglu_bwd_ref(gate, up, go)))
        del gate, up, go, dg, du, rdg, rdu
        torch.cuda.empty_cache()

    for b, sq, skv, h, d, dtype, causal, masking, rate, variant in (
        (4, 2048, 2048, 32, 128, bf16, True, "ones", 0.0,
         "causal, all-ones mask (the Llama step's 32 calls)"),
        (4, 2048, 2048, 32, 128, bf16, True, "padding", 0.0,
         "causal, padding mask"),
        (4, 1024, 2048, 32, 128, bf16, True, "ones", 0.0,
         "causal, Sq 1024 != Skv 2048 (bottom-right aligned)"),
        (2, 1000, 1500, 16, 128, bf16, True, "padding", 0.0,
         "ragged Sq 1000 / Skv 1500, causal, padding mask"),
        (4, 2048, 2048, 32, 64, bf16, True, "ones", 0.0, "D 64, causal"),
        (4, 2048, 2048, 32, 32, bf16, True, "ones", 0.0, "D 32, causal"),
        (1, 1024, 1024, 8, 128, f32, True, "ones", 0.0,
         "f32 (CUDA cores), causal"),
        (8, 1024, 1024, 12, 64, bf16, False, "padding", 0.1,
         "dropout 0.1, padding mask (BERT-base heads)"),
    ):
        q, k, v = (rand((b, s_, h, d), dtype) for s_ in (sq, skv, skv))
        do = rand((b, sq, h, d), dtype)
        kvmask = torch.ones(b, skv, dtype=torch.bool, device="cuda")
        if masking == "padding":
            lengths = torch.randint(skv // 2, skv + 1, (b,), generator=gen,
                                    device="cuda")
            kvmask = torch.arange(skv, device="cuda")[None, :] < lengths[:, None]
        seed = (keep_mask.draw_seed(gen) if rate
                else keep_mask.zero_seed("cuda"))
        scale = d ** -0.5
        args = (kvmask, seed, causal, scale, rate)
        o, lse = fa.flash_attention_fwd(q, k, v, *args, impl="fused")
        wo, wlse = fa.flash_attention_ref(q, k, v, *args)
        err_f = merged(flash_errors(o, wo, dtype),
                       errors(lse, wlse, 1e-5, 1e-4))
        delta = fa.backward_delta(do, o)
        ops = fa.bwd_operands(q, k, v, kvmask, seed, do, lse, delta)
        # bf16 with dropout: the dQ launch's keep bits feed the dK/dV
        # launch (every dK/dV call below follows a dQ call on them).
        bits = fa.keep_scratch(q, k, rate)
        dq = fa.launch_dq(ops, *args, bits)
        dk, dv = fa.launch_dkv(ops, *args, bits)
        wdq, wdk, wdv = fa.flash_attention_bwd_ref(q, k, v, kvmask, seed, do,
                                                   lse, delta, causal, scale,
                                                   rate)
        err_q = flash_errors(dq, wdq, dtype)
        err_kv = merged(flash_errors(dk, wdk, dtype),
                        flash_errors(dv, wdv, dtype))
        if not dead_rows_zero(kvmask, dk, dv):
            err_kv = (err_kv[0], err_kv[1], False)
            print(f"flash_dkv {variant}: padded kv rows not exactly 0")
        # The gate must see a planted error on one tile: the last 64 q
        # rows (the smallest causal rows), kv rows below Skv / 2 (never
        # padded, every one attended).
        qt_rows, kt_rows = slice(sq - 64, sq), slice(skv // 2 - 64, skv // 2)
        for name, out_, ref_, rows in (("o", o, wo, qt_rows),
                                       ("dq", dq, wdq, qt_rows),
                                       ("dk", dk, wdk, kt_rows),
                                       ("dv", dv, wdv, kt_rows)):
            if not flash_check_sees(out_, ref_, dtype, rows):
                fail(f"flash {variant}: the {name} check passes a "
                     f"{FLASH_PLANTED:.0%} error planted on one tile")
        if not torch.equal(dq, fa.launch_dq(ops, *args, bits)):
            err_q = (err_q[0], err_q[1], False)
            print(f"flash_dq {variant}: not bitwise repeatable")
        dk2, dv2 = fa.launch_dkv(ops, *args, bits)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            err_kv = (err_kv[0], err_kv[1], False)
            print(f"flash_dkv {variant}: not bitwise repeatable")
        del wo, wlse, wdq, wdk, wdv, dk2, dv2
        pairs = attended_pairs(torch, b, sq, skv, kvmask, causal) * h
        product = 2.0 * pairs * d
        e = torch.finfo(dtype).bits // 8
        peak = BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S
        qb, kb, rows = b * sq * h * d * e, b * skv * h * d * e, b * h * sq * 4
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        shape = [b, sq, skv, h, d]
        # The library yardstick on [B, H, S, D] copies; its causal flag is
        # top-left aligned, so Sq != Skv passes the mask instead.
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
        keep = kvmask[:, None, None, :]
        if causal:
            qi = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
            keep = keep & (torch.arange(skv, device="cuda")[None, :] <= qi)
        lib_kw = ({"is_causal": True} if masking == "ones" and causal
                  and sq == skv else {"attn_mask": keep})
        lib_kw["dropout_p"] = rate
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(ql, kl, vl, **lib_kw)
            return torch.autograd.grad(out, (ql, kl, vl), dot)

        def timed(row, kernel, plain, library, library_name):
            return timed_case(row, kernel, plain, library, library_name,
                              plain_calls=2)

        lib_bwd = library_bwd_ms(torch, F, ql, kl, vl, dot, lib_kw)

        cases["flash_fwd"].append(timed(
            case_row(shape, dtype, variant, err_f, tol,
                     2 * qb + 2 * kb + rows + b * skv, 2 * product, peak),
            lambda: fa.flash_attention_fwd(q, k, v, *args, impl="fused"),
            lambda: fa.flash_attention_ref(q, k, v, *args),
            sdpa, "F.scaled_dot_product_attention forward"))
        bwd_plain = (lambda: fa.flash_attention_bwd_ref(
            q, k, v, kvmask, seed, do, lse, delta, causal, scale, rate))
        lib_name = ("F.scaled_dot_product_attention forward + backward "
                    "(torch.autograd.grad); plain: the whole backward")
        # bf16 with dropout: the keep bits the dQ launch writes and the
        # dK/dV launch reads (a bit a pair), beside the bound.
        bits_b = 0 if bits is None else bits.numel() * 4
        beyond = ({"beyond_bound": beyond_bound(
            f"keep bits write {bits_b} B", bits_b, 0)} if bits_b else {})
        cases["flash_dq"].append(timed(
            case_row(shape, dtype, variant, err_q, tol,
                     3 * qb + 2 * kb + 2 * rows + b * skv, 3 * product, peak),
            lambda: fa.launch_dq(ops, *args, bits), bwd_plain, sdpa_fwd_bwd,
            lib_name) | {"library_bwd_ms": lib_bwd} | beyond)
        if bits_b:
            beyond = {"beyond_bound": beyond_bound(
                f"keep bits read {bits_b} B", bits_b, 0)}
        cases["flash_dkv"].append(timed(
            case_row(shape, dtype, variant, err_kv, tol,
                     2 * qb + 4 * kb + 2 * rows + b * skv, 4 * product, peak),
            lambda: fa.launch_dkv(ops, *args, bits), bwd_plain, sdpa_fwd_bwd,
            lib_name) | {"library_bwd_ms": lib_bwd} | beyond)
        del q, k, v, do, o, lse, delta, ops, bits, dq, dk, dv, qt, kt, vt, dot
        del ql, kl, vl, keep
        torch.cuda.empty_cache()
    flash_dropout_checks(torch, fa, keep_mask, hybrid_attention)
    report_cases(cases)
    return cases


def flash_dropout_checks(torch, fa, keep_mask, hybrid_attention):
    """Flash's dropout against the contract at [8, 1024, 12, 64], rate
    0.1: with q = k = 0 (uniform probabilities), v one-hot over a window
    of 64 kv columns and the kv mask open on that window only, o is
    nonzero exactly where the forward kept the entry; over the 16 windows
    that is the plain keep mask bit for bit. Then the dropout-on output
    and its gradients against hybrid_attention's on the same seed words
    (f32, S = 128, 1e-4)."""
    b, s, h, d, rate = 8, 1024, 12, 64, 0.1
    seed = keep_mask.draw_seed(torch.Generator(device="cuda").manual_seed(31))
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16, device="cuda")
    eye = torch.eye(d, dtype=torch.bfloat16, device="cuda")
    v = eye.repeat(s // d, 1)[None, :, None, :].expand(b, s, h, d).contiguous()
    kept = torch.empty(b, h, s, s, dtype=torch.bool, device="cuda")
    for w in range(s // d):
        window = torch.zeros(b, s, dtype=torch.bool, device="cuda")
        window[:, w * d:(w + 1) * d] = True
        o, _ = fa.flash_attention_fwd(q, q, v, window, seed, False, None, rate,
                                      impl="fused")
        kept[..., w * d:(w + 1) * d] = (o != 0).permute(0, 2, 1, 3)
    bitwise = torch.equal(kept, keep_mask.keep_mask(seed, kept.shape, rate))
    share = kept.float().mean().item()
    sigma = (rate * (1 - rate) / kept.numel()) ** 0.5
    del q, v, kept, o
    g = torch.Generator(device="cuda").manual_seed(33)
    q, k, v = (torch.randn(8, 128, 12, 64, generator=g, device="cuda")
               for _ in range(3))
    am = torch.ones(8, 128, dtype=torch.int32, device="cuda")
    am[1, 90:] = 0
    outs = []
    for fn in (fa.flash_attention, hybrid_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, am, causal=True, dropout_rate=rate,
                 dropout_rng=torch.Generator(device="cuda").manual_seed(35))
        (out * out).sum().backward()
        outs.append([out] + [t.grad for t in leaves])
    diff = max(float((a - b_).abs().max()) for a, b_ in zip(*outs))
    same = all(torch.allclose(a, b_, rtol=1e-4, atol=1e-4)
               for a, b_ in zip(*outs))
    print(f"flash dropout contract: keep mask of {b * h * s * s} elements "
          f"bitwise equal to the plain version's: {bitwise}; keep rate "
          f"{share:.6f} (0.9 +- 5 sigma = {5 * sigma:.2e}); f32 output and "
          f"gradients vs hybrid_attention on the same seed words at S = "
          f"128: max |diff| {diff:.3e} (tol 1e-4)")
    if not (bitwise and abs(share - (1 - rate)) < 5 * sigma and same):
        fail("flash dropout contract: a check failed")
    torch.cuda.empty_cache()


def whole_attention_kernel_phase(torch, F):
    """The whole-row attention forward and two-launch backward against
    their plain versions at the seq-512 step's [32, 512, 12, 64] bf16
    with the padding mask and dropout 0.1 (its 12 calls), then without
    dropout, ragged S 300, 384 and 301 (S % 4 != 0, with dropout),
    causal, f32, and D 32 and 128; each backward run twice and compared
    bit for bit, its padded kv rows exactly 0, and each gate shown to
    reject a 5 % error planted on one 64-row tile (flash_errors). Then
    the dropout contract: the keep mask at [4, 512, 12, 64] bitwise equal
    to the plain one at a rate within 5 sigma of 0.9, and the dropout-on
    output and gradients equal to hybrid_attention's on the same seed
    words at S = 384. Times as phase 7c, beside
    F.scaled_dot_product_attention (forward, and forward + backward for
    the backward rows) with the same boolean padding mask and dropout_p
    on [B, H, S, D] copies."""
    from tpudl_torch.ops import fused_attention as fu
    from tpudl_torch.ops import keep_mask
    from tpudl_torch.ops.softmax_dropout import hybrid_attention

    gen = torch.Generator(device="cuda").manual_seed(97531)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"fused_attn_fwd": [], "fused_attn_bwd": []}
    b0, s0 = BERT_512_BATCH, BERT_512_SEQ

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for b, s, h, d, dtype, causal, masking, rate, variant in (
        (b0, s0, 12, 64, bf16, False, "padding", 0.1,
         "padding mask, dropout 0.1 (the seq-512 step's 12 calls)"),
        (b0, s0, 12, 64, bf16, False, "padding", 0.0,
         "padding mask, no dropout"),
        (b0, 300, 12, 64, bf16, False, "padding", 0.1,
         "ragged S 300, dropout 0.1"),
        (b0, 384, 12, 64, bf16, False, "padding", 0.0, "ragged S 384"),
        (b0, 301, 12, 64, bf16, False, "padding", 0.1,
         "ragged S 301 (S % 4 != 0), dropout 0.1"),
        (b0, s0, 12, 64, bf16, True, "ones", 0.0, "causal"),
        (8, s0, 12, 64, f32, False, "padding", 0.1,
         "f32 (CUDA cores), dropout 0.1"),
        (b0, s0, 24, 32, bf16, False, "padding", 0.0, "D 32"),
        (16, s0, 12, 128, bf16, False, "padding", 0.0, "D 128"),
    ):
        q, k, v, do = (rand((b, s, h, d), dtype) for _ in range(4))
        kvmask = torch.ones(b, s, dtype=torch.bool, device="cuda")
        if masking == "padding":
            lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                    device="cuda")
            kvmask = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
        seed = (keep_mask.draw_seed(gen) if rate
                else keep_mask.zero_seed("cuda"))
        scale = d ** -0.5
        args = (kvmask, seed, causal, scale, rate)
        o, lse = fu.fused_attention_fwd(q, k, v, *args, impl="fused")
        wo, wlse = fu.fused_attention_ref(q, k, v, *args)
        err_f = merged(flash_errors(o, wo, dtype),
                       errors(lse, wlse, 1e-5, 1e-4))
        bwd_args = (q, k, v, kvmask, seed, do, lse, causal, scale, rate)
        grads = fu.fused_attention_bwd(*bwd_args, impl="fused")
        want = fu.fused_attention_bwd_ref(*bwd_args)
        err_b = merged(*(flash_errors(g_, w_, dtype)
                         for g_, w_ in zip(grads, want)))
        if not dead_rows_zero(kvmask, *grads[1:]):
            err_b = (err_b[0], err_b[1], False)
            print(f"fused_attn_bwd {variant}: padded kv rows not exactly 0")
        # One 64-row tile below S / 2: attended under every mask here.
        rows = slice(s // 2 - 64, s // 2)
        for name, out_, ref_ in (("o", o, wo), ("dq", grads[0], want[0]),
                                 ("dk", grads[1], want[1]),
                                 ("dv", grads[2], want[2])):
            if not flash_check_sees(out_, ref_, dtype, rows):
                fail(f"whole attention {variant}: the {name} check passes a "
                     f"{FLASH_PLANTED:.0%} error planted on one tile")
        again = fu.fused_attention_bwd(*bwd_args, impl="fused")
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            err_b = (err_b[0], err_b[1], False)
            print(f"fused_attn_bwd {variant}: not bitwise repeatable")
        del wo, wlse, want, again
        pairs = attended_pairs(torch, b, s, s, kvmask, causal) * h
        product = 2.0 * pairs * d
        e = torch.finfo(dtype).bits // 8
        peak = BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S
        qb, rows_b = b * s * h * d * e, b * h * s * 4
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        shape = [b, s, h, d]
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        keep = kvmask[:, None, None, :]
        if causal:
            keep = keep & torch.ones(s, s, dtype=torch.bool,
                                     device="cuda").tril()
        lib_kw = ({"is_causal": True} if masking == "ones" and causal
                  else {"attn_mask": keep})
        lib_kw["dropout_p"] = rate
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(ql, kl, vl, **lib_kw)
            return torch.autograd.grad(out, (ql, kl, vl), dot)

        # Forward (tpudl's site 12): q, k, v and the mask in, o out; two
        # products. The lse row statistic it also writes for the backward
        # is this design's, not the function's: shown beside the bound.
        row = timed_case(
            case_row(shape, dtype, variant, err_f, tol, 4 * qb + b * s,
                     2 * product, peak),
            lambda: fu.fused_attention_fwd(q, k, v, *args, impl="fused"),
            lambda: fu.fused_attention_ref(q, k, v, *args),
            sdpa, "F.scaled_dot_product_attention forward", plain_calls=2)
        row["beyond_bound"] = beyond_bound(f"lse write {rows_b} B", rows_b, 0)
        cases["fused_attn_fwd"].append(row)
        # Backward (site 13): q, k, v, do, lse and the mask in, dq, dk, dv
        # out; five products (s, dp, dq, dk, dv). The design's delta
        # (written once, read by each dK/dV block), the dQ launch's second
        # sweep of s and dp and, bf16 with dropout, the keep bits the dQ
        # launch hands the dK/dV launch (a bit a pair, written and read)
        # are shown beside the bound.
        bits_b = (b * h * s * ((s + 31) // 32) * 4
                  if dtype == bf16 and rate > 0 else 0)
        row = timed_case(
            case_row(shape, dtype, variant, err_b, tol,
                     7 * qb + rows_b + b * s, 5 * product, peak),
            lambda: fu.fused_attention_bwd(*bwd_args, impl="fused"),
            lambda: fu.fused_attention_bwd_ref(*bwd_args), sdpa_fwd_bwd,
            "F.scaled_dot_product_attention forward + backward "
            "(torch.autograd.grad)", plain_calls=2)
        extra = f"delta write + read {2 * rows_b} B"
        if bits_b:
            extra += f", keep bits write + read {2 * bits_b} B"
        row["beyond_bound"] = beyond_bound(
            f"{extra}, 2 more products", 2 * rows_b + 2 * bits_b,
            2 * product, peak)
        row["library_bwd_ms"] = library_bwd_ms(torch, F, ql, kl, vl, dot,
                                               lib_kw)
        cases["fused_attn_bwd"].append(row)
        del q, k, v, do, o, lse, grads, qt, kt, vt, dot, ql, kl, vl
        torch.cuda.empty_cache()

    # The dropout contract: the window probe of flash_dropout_checks.
    b, s, h, d, rate = 4, s0, 12, 64, 0.1
    seed = keep_mask.draw_seed(torch.Generator(device="cuda").manual_seed(37))
    q = torch.zeros(b, s, h, d, dtype=bf16, device="cuda")
    eye = torch.eye(d, dtype=bf16, device="cuda")
    v = eye.repeat(s // d, 1)[None, :, None, :].expand(b, s, h, d).contiguous()
    kept = torch.empty(b, h, s, s, dtype=torch.bool, device="cuda")
    for w in range(s // d):
        window = torch.zeros(b, s, dtype=torch.bool, device="cuda")
        window[:, w * d:(w + 1) * d] = True
        o, _ = fu.fused_attention_fwd(q, q, v, window, seed, False, None,
                                      rate, impl="fused")
        kept[..., w * d:(w + 1) * d] = (o != 0).permute(0, 2, 1, 3)
    bitwise = torch.equal(kept, keep_mask.keep_mask(seed, kept.shape, rate))
    share = kept.float().mean().item()
    sigma = (rate * (1 - rate) / kept.numel()) ** 0.5
    del q, v, kept, o
    g = torch.Generator(device="cuda").manual_seed(39)
    q, k, v = (torch.randn(8, 384, 12, 64, generator=g, device="cuda")
               for _ in range(3))
    am = torch.ones(8, 384, dtype=torch.int32, device="cuda")
    am[1, 250:] = 0
    outs = []
    for fn in (fu.fused_attention, hybrid_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, am, causal=True, dropout_rate=rate,
                 dropout_rng=torch.Generator(device="cuda").manual_seed(41))
        (out * out).sum().backward()
        outs.append([out] + [x.grad for x in leaves])
    outs = [[x.detach() for x in o] for o in outs]
    diff = max(float((a - b_).abs().max()) for a, b_ in zip(*outs))
    same = all(torch.allclose(a, b_, rtol=1e-4, atol=1e-4)
               for a, b_ in zip(*outs))
    print(f"whole attention dropout contract: keep mask of {b * h * s * s} "
          f"elements bitwise equal to the plain version's: {bitwise}; keep "
          f"rate {share:.6f} (0.9 +- 5 sigma = {5 * sigma:.2e}); f32 output "
          f"and gradients vs hybrid_attention on the same seed words at S = "
          f"384: max |diff| {diff:.3e} (tol 1e-4)")
    if not (bitwise and abs(share - (1 - rate)) < 5 * sigma and same):
        fail("whole attention dropout contract: a check failed")
    del q, k, v, outs
    torch.cuda.empty_cache()
    report_cases(cases)
    return cases


def llama_optimizer(constant=False):
    """The llama3_8b_lora optimizer (AdamW 1e-4, warmup 100, weight decay
    0, clip 1.0); ``constant`` drops the warm-up (a nonzero first step)."""
    import dataclasses

    from tpudl_torch.config import get_config
    from tpudl_torch.train import make_optimizer

    cfg = get_config("llama3_8b_lora").optim
    if constant:
        cfg = dataclasses.replace(cfg, schedule="constant", warmup_steps=0)
    return make_optimizer(cfg)


def draw_lora_b(torch, model, generator, std):
    """Draw every lora_b nonzero (with tpudl's zero init every lora_a
    gradient is exactly 0 at the first step)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, std, generator=generator)


def tiny_llama_train_phase(torch):
    """One LoRA train step of an f32 LLAMA_TINY classifier (rank 4,
    attention_impl="flash", fused_ops=True, lora_b drawn nonzero) with the
    kernels on the card against the same step on the CPU plain path, same
    weights and batch (padded rows): tpudl's bands as tiny_train — loss
    rtol 1e-4 / atol 1e-5, every adapter and classifier gradient 1e-4,
    the parameters after the update rtol 2e-3 / atol 2e-5 — and the frozen
    base unchanged."""
    import numpy as np

    from tpudl_torch.models.llama import (
        LLAMA_TINY,
        LlamaForSequenceClassification,
    )
    from tpudl_torch.models.lora import lora_optimizer
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import create_train_state, make_classification_train_step

    cfg = LLAMA_TINY(dtype=torch.float32, num_labels=2, lora_rank=4,
                     attention_impl="flash", fused_ops=True)
    ref = LlamaForSequenceClassification(cfg, device="cpu")
    ref.init_weights(torch.Generator().manual_seed(0))
    draw_lora_b(torch, ref, torch.Generator().manual_seed(1), 0.05)
    params = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    rng = np.random.default_rng(5)
    mask = np.ones((8, 64), np.int32)
    mask[1, 40:] = 0
    mask[5, 9:] = 0
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (8, 64)),
             "attention_mask": mask, "label": rng.integers(0, 2, (8,))}
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), label_key="label")
    per_pass = llama_launches_per_step(cfg.num_layers)
    out = {}
    for dev in ("cuda", "cpu"):
        model = LlamaForSequenceClassification(cfg, device="meta")
        tx = lora_optimizer(llama_optimizer(constant=True), model,
                            ("classifier",))
        state = create_train_state(0, model, tx, params={
            k: v.to(dev) for k, v in params.items()}, device=dev)
        before = train_counts()
        grads, metrics = step.grads_and_metrics(state, batch, fold_in(1, 0, dev))
        state, _ = step(state, batch, 1)
        after = train_counts()
        launched = {k: after[k] - before[k] for k in after}
        want = {k: 2 * per_pass.get(k, 0) if dev == "cuda" else 0
                for k in after}
        if launched != want:
            fail(f"tiny_llama_train: kernel launches {launched} on {dev}, "
                 f"expected {want}")
        out[dev] = (float(metrics["loss"]),
                    {k: g.cpu() for k, g in grads.items()},
                    {k: v.detach().cpu() for k, v in state.model.state_dict().items()})
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    if not abs(lg - lc) <= 1e-5 + 1e-4 * abs(lc):
        fail(f"tiny_llama_train: loss {lg} on the card vs {lc} on the CPU")
    bad = [k for k in gc if not torch.allclose(gg[k], gc[k], rtol=1e-4,
                                                atol=1e-4)]
    bad += [k for k in pc if not torch.allclose(pg[k], pc[k], rtol=2e-3,
                                                 atol=2e-5)]
    bad += [k for k in pc if k not in gc and not torch.equal(pg[k], params[k])]
    if bad or set(gg) != set(gc) or not gc:
        fail(f"tiny_llama_train: card vs CPU disagree in {bad[:5]}")
    worst_g = max(float((gg[k] - gc[k]).abs().max()) for k in gc)
    worst_p = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    print(f"tiny_llama_train: f32 LLAMA_TINY LoRA classifier step "
          f"(attention_impl='flash', fused_ops=True), kernels on the card vs "
          f"plain on the CPU: loss {lg:.6f} vs {lc:.6f}, {len(gc)} trainable "
          f"tensors, max |grad diff| {worst_g:.3e} (tol 1e-4), max |param "
          f"diff| after the update {worst_p:.3e} (rtol 2e-3, atol 2e-5), "
          f"frozen base unchanged")


def llama_lora_train_phase(torch, card):
    """The slice at full size through the user's entry points:
    build_model("llama3-8b-lora", 2, fused_ops=True,
    attention_impl="flash") -> create_train_state(0, model,
    lora_optimizer(make_optimizer(llama3_8b_lora's optim), model,
    ("classifier",))) -> make_classification_train_step(accum_steps=16)
    -> fit over synthetic_token_batches(64, 2048, 128256): the config's
    global batch 64 as 16 microbatches of 4. W warm-up steps, then T
    timed steps (counts reset just before; exact launches per step),
    then one more step (profiled in the captured run only); losses
    finite, the frozen base bit-identical after the steps (compared on
    the host)."""
    from tpudl_torch.config import get_config
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.lora import lora_optimizer, trainable_param_count
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        fit,
        make_classification_train_step,
    )
    from tpudl_torch.train.metrics import Throughput

    cfg = get_config("llama3_8b_lora")
    batch_size = cfg.global_batch_size
    if batch_size != LLAMA_BATCH * LLAMA_ACCUM:
        fail(f"llama_lora_train: {LLAMA_ACCUM} x {LLAMA_BATCH} is not the "
             f"config's global batch {batch_size}")
    t0 = time.perf_counter()
    model = build_model(cfg.model, cfg.num_classes, fused_ops=True,
                        attention_impl="flash")
    tx = lora_optimizer(llama_optimizer(), model, ("classifier",))
    state = create_train_state(0, model, tx)
    mcfg = model.cfg
    named = dict(model.named_parameters())
    trainable, total = trainable_param_count(named, ("classifier",))
    n_proj = sum(p.numel() for n, p in named.items()
                 if n.endswith("_proj.weight"))
    frozen = {n: p.detach().cpu() for n, p in named.items()
              if not p.requires_grad}
    torch.cuda.synchronize()
    print(f"llama_lora_train: Llama-3-8B ({mcfg.num_layers} layers, hidden "
          f"{mcfg.hidden_size}, heads {mcfg.num_heads}/{mcfg.num_kv_heads}), "
          f"LoRA rank {mcfg.lora_rank} on the 7 projections, "
          f"attention_impl='flash', fused_ops=True: {total / 1e9:.3f} B "
          f"parameters, {trainable / 1e6:.3f} M trainable; global batch "
          f"{batch_size} = {LLAMA_ACCUM} microbatches x {LLAMA_BATCH} x seq "
          f"{LLAMA_SEQ}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"resident; set-up {time.perf_counter() - t0:.1f} s")
    keys = ("input_ids", "attention_mask")
    step = make_classification_train_step(input_keys=keys, label_key="label",
                                          accum_steps=LLAMA_ACCUM)
    n = LLAMA_STEPS
    # The captured run warms up one step longer (its second call is the
    # capture); both runs are compared after the same four steps.
    compared = LLAMA_WARMUP_STEPS + n + LLAMA_PROFILE_STEPS
    batches = list(synthetic_token_batches(
        batch_size, LLAMA_SEQ, mcfg.vocab_size, num_batches=compared + 1))
    tokens = batch_size * LLAMA_SEQ
    attn = 7.0 * batch_size * mcfg.hidden_size * LLAMA_SEQ ** 2 * mcfg.num_layers
    flops = 4.0 * n_proj * tokens + attn
    per_step = llama_launches_per_step(mcfg.num_layers, LLAMA_ACCUM)
    init = {k: p.detach().clone() for k, p in state.params.items()}
    # The bf16 loss llama_fp8_lora_train holds its first step to: the
    # initial weights on the first LLAMA_FP8_ACCUM microbatches of batch 0
    # (the mean of their means, as the accumulated step reports it).
    from tpudl_torch.train import make_classification_eval_step

    evaluate = make_classification_eval_step(input_keys=keys)
    ref_loss = microbatch_eval_loss(torch, evaluate, state, batches[0],
                                    LLAMA_FP8_ACCUM)
    runs = {}
    for capture in (False, True):
        way = "captured" if capture else "eager"
        w = LLAMA_WARMUP_STEPS + int(capture)
        if capture:
            # Back to the initial trainable weights and optimizer state
            # (the frozen base never moves).
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(init[k])
            state.opt_state = state.tx.init(state.params)
            state.step = 0
        run_step = compile_step(step, state) if capture else step
        losses = []
        meter = Throughput(tokens, warmup=w)

        def recorded(state, batch, rng, run_step=run_step, losses=losses,
                     meter=meter):
            state, metrics = run_step(state, batch, rng)
            losses.append(metrics["loss"])
            meter.step(metrics["loss"])
            return state, metrics

        torch.cuda.reset_peak_memory_stats()  # over the capture too
        state, _, _ = fit(recorded, state, batches[:w], 1)
        torch.cuda.synchronize()
        reset_counts()
        state, last, _ = fit(recorded, state, batches[w:w + n], 1)
        timed = meter.result(losses[-1])
        launches = train_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: per_step.get(k, 0) * n for k in launches}
        print(f"llama_lora_train ({way}): {n} steps, launches {launches}")
        if launches != want:
            fail(f"llama_lora_train ({way}): kernel launches {launches} != "
                 f"expected {want} ({per_step} per step, none of the others)")
        loss_t = torch.stack(losses)
        if not bool(torch.isfinite(loss_t).all()):
            fail(f"llama_lora_train: non-finite loss in {loss_t.tolist()}")
        if timed["steps_measured"] != n:
            fail(f"llama_lora_train: the meter timed "
                 f"{timed['steps_measured']} steps, not {n}")
        if peak > LLAMA_PEAK_GIB:
            fail(f"llama_lora_train ({way}): peak memory {peak:.2f} GiB over "
                 f"{LLAMA_PEAK_GIB}")
        step_s = timed["step_ms"] / 1e3
        util = flops / step_s / BF16_OPS_PER_S
        capture_s = getattr(run_step, "capture_s", None)
        print(f"llama_lora_train metrics, {way} ({card}): step "
              f"{step_s * 1e3:.2f} ms, {tokens / step_s:.1f} tokens/s, MFU "
              f"{100 * util:.2f}% (model FLOPs per step = 4 * N_proj * T + 7 "
              f"* B * H * S^2 * D * L = 4 * {n_proj} * {tokens} + 7 * "
              f"{batch_size} * {mcfg.num_heads} * {LLAMA_SEQ}^2 * "
              f"{mcfg.head_dim} * {mcfg.num_layers} = {flops:.4e} over "
              f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16: the frozen "
              f"base's forward and input-gradient products, and 2 forward "
              f"and 5 backward attention products, each causal-halved), peak "
              f"memory {peak:.2f} GiB, losses "
              f"{', '.join(f'{x:.4f}' for x in loss_t.tolist())}"
              + ("" if capture_s is None
                 else f", the whole step ({LLAMA_ACCUM} microbatches, one "
                      f"graph) captured in {capture_s:.3f} s"))
        rest = batches[w + n:]

        def snapshot():
            return (torch.stack(losses[:compared]),
                    {k: p.detach().clone() for k, p in state.params.items()},
                    {k: {name: t.clone() for name, t in v.items()}
                     for k, v in state.opt_state.items()
                     if isinstance(v, dict)}, state.step)

        if capture:  # four steps done
            after = snapshot()
            busy = profile_steps(
                torch, lambda: fit(recorded, state,
                                   rest[:LLAMA_PROFILE_STEPS], 1),
                LLAMA_PROFILE_STEPS, f"llama_lora_train ({way})",
                step_s * 1e6 * LLAMA_PROFILE_STEPS)
        else:
            # The eager run takes its fourth step unprofiled (see
            # profile_decode).
            fit(recorded, state, rest[:LLAMA_PROFILE_STEPS], 1)
            busy = None
            after = snapshot()  # four steps done
        runs[capture] = (launches, after, {
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "mfu": util, "model_flops_per_step": flops,
            "peak_memory_gib": peak, "device_busy_share": busy,
            "num_params": total, "trainable_params": trainable,
            "batch": batch_size, "microbatch": LLAMA_BATCH,
            "accum_steps": LLAMA_ACCUM, "seq": LLAMA_SEQ, "steps": n,
            "losses": loss_t.tolist(), "capture_s": capture_s})
    check_bitwise("llama_lora_train", runs[False][1], runs[True][1])
    changed = [k for k, p in model.named_parameters()
               if k in frozen and not torch.equal(p.detach().cpu(), frozen[k])]
    if changed or not frozen:
        fail(f"llama_lora_train: frozen base weights changed: {changed[:5]}")
    print(f"llama_lora_train: {len(frozen)} frozen base tensors bit-identical "
          f"after both runs")
    launches, _, metrics = runs[True]
    metrics["eager"] = runs[False][2]
    metrics["fp8_reference_loss"] = ref_loss
    del state, model, frozen, named
    return launches, metrics


def llama_train_parity_phase(torch):
    """The kernel path (bf16, fused_ops=True, attention_impl="flash"), the
    plain bf16 path (fused_ops=False, attention_impl="reference") and an
    f32 oracle (plain, TF32 off) from the same weights: Llama-3-8B at
    full width, cut to 2 layers, LoRA rank 16 with lora_b drawn nonzero,
    over LLAMA_PARITY_BATCHES batches of 1 x 2048. Errors against the
    oracle accumulate over the batches as train_parity's: the kernel
    path's relative L2 error of the per-example losses, of all gated
    gradients and of every adapter and classifier gradient tensor but the
    UNGATED classifier.bias may not exceed KERNEL_ERR_RATIO x the plain
    path's. The kernel path with ``remat=True`` must give the kernel
    path's loss and gradients bit for bit, its forward kernels launched
    twice (the recompute); the peak memory of both is printed."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.llama import LLAMA3_8B, LlamaForSequenceClassification
    from tpudl_torch.models.lora import lora_optimizer
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import create_train_state, make_classification_train_step

    layers = 2
    kw = dict(num_layers=layers, lora_rank=16, num_labels=2)
    init = LlamaForSequenceClassification(LLAMA3_8B(**kw), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    draw_lora_b(torch, init, torch.Generator(device="cuda").manual_seed(12),
                0.02)
    params = {k: v.detach() for k, v in init.state_dict().items()}
    paths = {
        "kernel": (torch.bfloat16, {"fused_ops": True,
                                    "attention_impl": "flash"}),
        "plain": (torch.bfloat16, {"fused_ops": False}),
        "oracle": (torch.float32, {"fused_ops": False}),
        "remat": (torch.bfloat16, {"fused_ops": True,
                                   "attention_impl": "flash", "remat": True}),
    }
    states = {}
    for name, (dtype, extra) in paths.items():
        model = LlamaForSequenceClassification(
            LLAMA3_8B(dtype=dtype, **kw, **extra), device="meta")
        tx = lora_optimizer(llama_optimizer(constant=True), model,
                            ("classifier",))
        states[name] = create_train_state(0, model, tx, params=params)
    del init, params
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), label_key="label")
    counted_kernels = llama_launches_per_step(layers)
    sq = {name: {} for name in ("kernel", "plain", "oracle")}
    peaks = {"kernel": 0.0, "remat": 0.0}

    def acc(name, key, value):
        sq[name][key] = sq[name].get(key, 0.0) + value

    for b, batch in enumerate(synthetic_token_batches(
            1, LLAMA_SEQ, 128256, seed=9, num_batches=LLAMA_PARITY_BATCHES)):
        out = {}
        for name, st in states.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = train_counts()
            grads, metrics = step.grads_and_metrics(st, batch,
                                                    fold_in(7, b, "cuda"))
            after = train_counts()
            if name in peaks:
                peaks[name] = max(peaks[name],
                                  torch.cuda.max_memory_allocated() / 2**30)
            launched = {k: after[k] - before[k] for k in counted_kernels}
            want = {"kernel": counted_kernels,
                    "remat": llama_launches_per_step(layers, remat=True)}.get(
                        name, {k: 0 for k in counted_kernels})
            if launched != want:
                fail(f"llama_train_parity: the {name} path launched "
                     f"{launched}, expected {want}")
            if name == "remat":
                loss0, grads0 = out["kernel"]
                same = torch.equal(metrics["loss"].double().reshape(1), loss0)
                bad = [k for k, g in grads.items()
                       if not torch.equal(g.double(), grads0[k])]
                if not same or bad or set(grads) != set(grads0):
                    fail(f"llama_train_parity: remat=True differs from the "
                         f"kernel path (loss equal: {same}; gradients "
                         f"{bad[:5]})")
                continue
            # Batch 1: the step's loss is the example's.
            out[name] = (metrics["loss"].double().reshape(1),
                         {k: g.double() for k, g in grads.items()})
        lo, go = out["oracle"]
        acc("oracle", "losses", float((lo * lo).sum()))
        for k, g in go.items():
            acc("oracle", k, float((g * g).sum()))
        for name in ("kernel", "plain"):
            losses, grads = out[name]
            acc(name, "losses", float(((losses - lo) ** 2).sum()))
            for k, g in grads.items():
                acc(name, k, float(((g - go[k]) ** 2).sum()))
        del out
    tensors = [k for k in sq["oracle"] if k != "losses"]
    gated = [k for k in tensors if k != "classifier.bias"]
    for name in sq:
        sq[name]["all gated gradients"] = sum(sq[name][k] for k in gated)
    err = {name: {k: (sq[name][k] / sq["oracle"][k]) ** 0.5
                  if sq["oracle"][k] > 0 else sq[name][k] ** 0.5
                  for k in sq["oracle"]}
           for name in ("kernel", "plain")}
    ratio = {k: err["kernel"][k] / max(err["plain"][k], 1e-300)
             for k in sq["oracle"]}
    judged = ["losses", "all gated gradients"] + gated
    worst = sorted(judged, key=lambda k: -ratio[k])[:5]
    shown = ", ".join(f"{k} {ratio[k]:.3f} ({err['kernel'][k]:.3e} vs "
                      f"{err['plain'][k]:.3e})" for k in worst)
    print(f"llama_train_parity: Llama-3-8B width, {layers} layers, LoRA "
          f"rank 16, {LLAMA_PARITY_BATCHES} batches of 1 x {LLAMA_SEQ}, rel "
          f"L2 err vs the f32 oracle, kernel vs plain path: per-example "
          f"losses {err['kernel']['losses']:.3e} vs "
          f"{err['plain']['losses']:.3e}; all gated gradients "
          f"({len(gated)} tensors) {err['kernel']['all gated gradients']:.4e}"
          f" vs {err['plain']['all gated gradients']:.4e}; worst judged "
          f"ratios: {shown}; ungated: classifier.bias "
          f"{ratio['classifier.bias']:.3f}")
    print(f"llama_train_parity: remat=True: the kernel path's loss and all "
          f"{len(tensors)} gradients bit for bit on {LLAMA_PARITY_BATCHES} "
          f"batches, forward kernels launched twice; peak memory "
          f"{peaks['kernel']:.2f} GiB without remat, {peaks['remat']:.2f} "
          f"GiB with")
    bad = [k for k in judged if ratio[k] > KERNEL_ERR_RATIO]
    if bad:
        fail(f"llama_train_parity: the kernel path's error exceeds "
             f"{KERNEL_ERR_RATIO} x the plain path's in {bad}")
    del states
    torch.cuda.empty_cache()
    return {"batches": LLAMA_PARITY_BATCHES, "layers": layers,
            "peak_memory_gib": peaks,
            "losses_rel_err": {n: err[n]["losses"] for n in err},
            "gradients_rel_err": {n: err[n]["all gated gradients"]
                                  for n in err},
            "worst_ratio": [worst[0], ratio[worst[0]]]}


# ---------------------------------------------------------------------------
# the CV path and the rest of the train loop
# ---------------------------------------------------------------------------

#: configs[2] (imagenet_resnet50_dp): global batch 1024 as 8 microbatches of
#: 128 uint8 224 x 224 images, padded by 8 and cropped back on the host.
RESNET_PAD = 8
RESNET_WARMUP_STEPS = 2
RESNET_STEPS = 5
RESNET_PROFILE_STEPS = 1
RESNET_EVAL_IMAGES = 1000
RESNET_EVAL_BATCH = 128
#: Assembly workers of the ResNet feed (at most the host's cores less two:
#: the main thread and the transfer thread).
RESNET_WORKERS = 4
#: Host augmentation, native against numpy, and device_normalize against
#: the host normalize: tests/test_augment.py's f32 band.
AUGMENT_TOL = 1e-6
#: evaluate with the ragged tail padded against the same images unpadded.
EVAL_PAD_TOL = 1e-5
#: resnet_parity: 2 microbatches of 16 images at full width. The bf16
#: path's relative L2 error of the train-mode logits and of the
#: per-example losses against the f32 oracle: 2^-5. A bf16 rounding is
#: 2^-9 relative; the logits carry one per convolution, BatchNorm and
#: residual add on the path (~60 at ResNet-50's depth, independent, so
#: ~sqrt(60) x 2^-9 = 1.5 %), which the gate clears by a factor of 2.
RESNET_PARITY_MICRO = 16
RESNET_PARITY_TOL = 2.0 ** -5
#: resnet_parity sets each block's zero-initialized last BatchNorm scale
#: to this, so every residual branch reaches the logits.
RESNET_LAST_SCALE = 0.25
#: train_fused's accumulation check: accum 8 against the monolithic step,
#: dropout off, relative L2 error of the loss and of all gradients
#: together: bf16 rounding (the microbatches' products round at other
#: places).
ACCUM_TOL = 1e-2
BERT_ACCUM = 8


def resnet_counts(accum):
    """Counted launches per ResNet-50 step of ``accum`` microbatches: the
    loss's cross-entropy kernels (loss_impl="auto"), once each way per
    microbatch; no other kernel of this repo."""
    return {"xent_fwd": accum, "xent_bwd": accum}


def resnet50_train_phase(torch, card):
    """configs[2] through the user's entry points: build_model("resnet50",
    1000) -> create_train_state -> make_optimizer(imagenet_resnet50_dp's
    optim) -> make_classification_train_step(0.1, accum_steps=8,
    input_transform=device_normalize(IMAGENET_MEAN, IMAGENET_STD),
    loss_impl="auto") -> fit, over uint8 [1024, 224, 224, 3] images made
    from a seed that BatchAugmenter(crop 224, pad 8, normalize=False,
    backend="native") augments afresh each step on the host. First the
    native augmenter against the numpy path, and device_normalize against
    the host normalize (AUGMENT_TOL). W warm-up steps, T timed steps
    (counts reset just before: exactly 8 cross-entropy launches each way
    a step, no other kernel of this repo), a profiled window; every loss
    finite; every running statistic finite and moved by the timed steps.
    Then evaluate over 1000 eval images at batch 128: the 104-row tail
    padded (one cross-entropy forward a batch) against the same images
    unpadded, within EVAL_PAD_TOL."""
    import numpy as np

    from tpudl_torch.config import get_config
    from tpudl_torch.data import native as native_lib
    from tpudl_torch.data.augment import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        BatchAugmenter,
        device_normalize,
    )
    from tpudl_torch.data.prefetch import prefetch_to_device
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        evaluate,
        fit,
        make_classification_eval_step,
        make_classification_train_step,
        make_optimizer,
    )
    from tpudl_torch.train.metrics import Throughput

    cfg = get_config("imagenet_resnet50_dp")
    b, size, accum = cfg.global_batch_size, cfg.image_size, cfg.accum_steps
    t0 = time.perf_counter()
    model = build_model(cfg.model, cfg.num_classes)
    state = create_train_state(cfg.seed, model, make_optimizer(cfg.optim))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(cfg.seed)
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, cfg.num_classes, b).astype(np.int32)
    norm = device_normalize(IMAGENET_MEAN, IMAGENET_STD)
    aug_kw = dict(crop=(size, size), pad=RESNET_PAD, mean=IMAGENET_MEAN,
                  std=IMAGENET_STD)
    # The native kernel (a failed build raises) against the numpy path,
    # and the uint8 path normalized on the card against the host's.
    sample = images[:64]
    native = BatchAugmenter(backend="native", seed=1, **aug_kw)(sample)
    plain = BatchAugmenter(backend="numpy", seed=1, **aug_kw)(sample)
    raw = BatchAugmenter(backend="native", seed=1, normalize=False,
                         **aug_kw)(sample)
    on_card = norm({"image": torch.as_tensor(raw, device="cuda")})["image"]
    aug_err = (float(np.abs(native - plain).max()),
               float(np.abs(on_card.cpu().numpy() - native).max()))
    if not max(aug_err) <= AUGMENT_TOL:
        fail(f"resnet50_train: augmentation native vs numpy {aug_err[0]}, "
             f"device_normalize vs host {aug_err[1]} (tol {AUGMENT_TOL})")
    aug = BatchAugmenter(backend="native", seed=cfg.seed, normalize=False,
                         **aug_kw)
    t1 = time.perf_counter()
    aug({"image": images, "label": labels})
    aug_ms = (time.perf_counter() - t1) * 1e3
    step = make_classification_train_step(
        cfg.label_smoothing, accum_steps=accum, input_transform=norm,
        loss_impl="auto")
    flops = 3.0 * model.forward_flops(size, size) * b
    workers = max(1, min(RESNET_WORKERS, (os.cpu_count() or 1) - 2))
    torch.cuda.synchronize()
    print(f"resnet50_train: ResNet-50 (bf16, channels_last), "
          f"{n_params / 1e6:.3f} M parameters, global batch {b} = {accum} "
          f"microbatches x {b // accum} at {size}x{size}, uint8 images padded "
          f"by {RESNET_PAD} and cropped back on the host ({aug.backend} "
          f"augmenter, OpenMP {native_lib.openmp()}; uint8 crop and flip "
          f"{aug_ms:.1f} ms a batch on one thread; native vs numpy "
          f"{aug_err[0]:.1e}, device_normalize vs host {aug_err[1]:.1e}); "
          f"fed by prefetch_to_device with {workers} assembly workers "
          f"(os.cpu_count() {os.cpu_count()}); set-up "
          f"{time.perf_counter() - t0:.1f} s")

    def augment(batch):
        # Each step's crops and flips from a seed of its own, so the
        # batches do not depend on which worker ran them.
        seed = int(batch.pop("seed"))
        return BatchAugmenter(backend="native", seed=seed, normalize=False,
                              **aug_kw)(batch)

    def feed(first, n):
        return prefetch_to_device(
            ({"image": images, "label": labels, "seed": first + i}
             for i in range(n)),
            transform=augment, assembly_workers=workers)

    def feed_ms(n_workers, n=2 * RESNET_WORKERS):
        """The feed alone, no step: wall ms a batch through the
        prefetcher (crop and flip, pinned copy, host-to-card copy)."""
        alone = prefetch_to_device(
            ({"image": images, "label": labels, "seed": 1000 + i}
             for i in range(n)), transform=augment,
            assembly_workers=n_workers)
        t = time.perf_counter()
        for _ in alone:
            pass
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n

    feed_ms(workers, RESNET_WORKERS)  # the pinned host blocks, allocated once
    one, many = feed_ms(1), feed_ms(workers)
    print(f"resnet50_train: the feed alone, no step: {one:.1f} ms a batch "
          f"with 1 assembly worker, {many:.1f} with {workers} ({one / many:.2f}"
          f"x; the crop and flip alone {aug_ms:.1f} ms a batch on one thread)")
    w = RESNET_WARMUP_STEPS
    runs = {}
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for capture in (False, True):
        way = "captured" if capture else "eager"
        if capture:
            model = build_model(cfg.model, cfg.num_classes)
            state = create_train_state(cfg.seed, model,
                                       make_optimizer(cfg.optim),
                                       params=init)
        run_step = compile_step(step, state) if capture else step
        losses = []
        meter = Throughput(b, warmup=w)

        def recorded(state, batch, rng, run_step=run_step, losses=losses,
                     meter=meter):
            state, metrics = run_step(state, batch, rng)
            losses.append(metrics["loss"])
            meter.step(metrics["loss"])
            return state, metrics

        # One feed for the warm-up and the timed steps: its fill (the
        # first batch's crop, flip and copy) falls in the warm-up.
        steps_feed = feed(0, w + RESNET_STEPS)
        torch.cuda.reset_peak_memory_stats()  # over the capture too
        state, _, _ = fit(recorded, state, steps_feed, 1, num_steps=w)
        torch.cuda.synchronize()
        stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
        reset_counts()
        state, last, _ = fit(recorded, state, steps_feed, 1,
                             num_steps=RESNET_STEPS)
        timed = meter.result(losses[-1])
        launches = train_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        waits = [x * 1e3 for x in steps_feed.waits[w:]]
        steps_feed.close()
        per_step = resnet_counts(accum)
        want = {k: per_step.get(k, 0) * RESNET_STEPS for k in launches}
        print(f"resnet50_train ({way}): {RESNET_STEPS} steps, launches "
              f"{launches}")
        if launches != want:
            fail(f"resnet50_train ({way}): kernel launches {launches} != "
                 f"expected {want} ({per_step} per step, none of the others)")
        loss_t = torch.stack(losses)
        if not bool(torch.isfinite(loss_t).all()):
            fail(f"resnet50_train: non-finite loss in {loss_t.tolist()}")
        stats = state.batch_stats
        still = [k for k in stats if torch.equal(stats[k], stats0[k])]
        bad = [k for k in stats if not bool(torch.isfinite(stats[k]).all())]
        if still or bad:
            fail(f"resnet50_train: running statistics that did not move "
                 f"{still[:5]} or are not finite {bad[:5]}")
        if timed["steps_measured"] != RESNET_STEPS:
            fail(f"resnet50_train: the meter timed {timed['steps_measured']} "
                 f"steps, not {RESNET_STEPS}")
        step_s = timed["step_ms"] / 1e3
        util = flops / step_s / BF16_OPS_PER_S
        capture_s = getattr(run_step, "capture_s", None)
        print(f"resnet50_train metrics, {way} ({card}): step "
              f"{step_s * 1e3:.2f} ms, {b / step_s:.1f} images/s, MFU "
              f"{100 * util:.2f}% (3 x the forward's convolution and dense "
              f"FLOPs x {b} = 3 x {flops / 3 / b:.4e} x {b} = {flops:.4e} "
              f"FLOP over {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16), "
              f"peak memory {peak:.2f} GiB, data wait a step "
              f"{', '.join(f'{x:.2f}' for x in waits)} ms (mean "
              f"{statistics.mean(waits):.2f}), {len(stats)} running "
              f"statistics moved and finite, losses "
              f"{', '.join(f'{x:.4f}' for x in loss_t.tolist())}"
              + ("" if capture_s is None
                 else f", step captured in {capture_s:.3f} s"))
        snapshot = (loss_t.clone(), {k: v.detach().clone() for k, v in
                                     state.model.state_dict().items()},
                    {"trace": {n: t.clone() for n, t in
                               state.opt_state["trace"].items()}}, state.step)
        busy = None  # the eager run is not profiled (see profile_decode)
        if capture:
            busy = profile_steps(
                torch, lambda: fit(run_step, state,
                                   feed(w + RESNET_STEPS,
                                        RESNET_PROFILE_STEPS), 1),
                RESNET_PROFILE_STEPS, f"resnet50_train ({way})",
                step_s * 1e6 * RESNET_PROFILE_STEPS)
        runs[capture] = (launches, snapshot, {
            "step_ms": step_s * 1e3, "images_per_s": b / step_s, "mfu": util,
            "model_flops_per_step": flops, "peak_memory_gib": peak,
            "device_busy_share": busy, "num_params": n_params, "batch": b,
            "accum_steps": accum, "image_size": size, "steps": RESNET_STEPS,
            "data_wait_ms": waits, "assembly_workers": workers,
            "cpu_count": os.cpu_count(), "host_augment_ms": aug_ms,
            "feed_alone_ms": {"1": one, str(workers): many},
            "losses": loss_t.tolist(), "capture_s": capture_s})
        if not capture:
            del state, model
            gc.collect()
            torch.cuda.empty_cache()
    check_bitwise("resnet50_train", runs[False][1], runs[True][1])
    launches = runs[True][0]
    metrics = runs[True][2]
    metrics["eager"] = runs[False][2]

    ev = rng.integers(0, 256, (RESNET_EVAL_IMAGES, size, size, 3),
                      dtype=np.uint8)
    ev_labels = rng.integers(0, cfg.num_classes,
                             RESNET_EVAL_IMAGES).astype(np.int32)
    center = BatchAugmenter(backend="native", train=False, normalize=False,
                            **aug_kw)

    def eval_batches():
        for i in range(0, RESNET_EVAL_IMAGES, RESNET_EVAL_BATCH):
            yield center({"image": ev[i:i + RESNET_EVAL_BATCH],
                          "label": ev_labels[i:i + RESNET_EVAL_BATCH]})

    eval_step = make_classification_eval_step(input_transform=norm,
                                              loss_impl="auto")
    sizes = []

    def unpadded(state, batch):  # no mask_aware marker: the tail runs at 104
        sizes.append(len(batch["label"]))
        return eval_step(state, batch)

    n_batches = -(-RESNET_EVAL_IMAGES // RESNET_EVAL_BATCH)
    compiled_eval = compile_step(eval_step, state, has_rng=False)
    for what, fn in (("eager", eval_step), ("captured", compiled_eval)):
        reset_counts()
        result = evaluate(fn, state, eval_batches())
        ev_launches = train_counts()
        want = {k: n_batches if k == "xent_fwd" else 0 for k in ev_launches}
        if ev_launches != want:
            fail(f"resnet50_train: evaluate ({what}) launched {ev_launches}, "
                 f"expected {want}")
        if fn is eval_step:
            padded = result
    if not compiled_eval.captured:
        fail("resnet50_train: the compiled eval step never captured")
    diff = {k: abs(padded[k] - result[k]) for k in padded}
    print(f"resnet50_train: evaluate through one captured eval graph (every "
          f"batch with a '_valid' column, the tail padded): loss "
          f"{result['loss']:.6f}, accuracy {result['accuracy']:.6f}; against "
          f"the eager step |diff| {diff} (tol {EVAL_PAD_TOL}), captured in "
          f"{compiled_eval.capture_s:.3f} s")
    if not all(d <= EVAL_PAD_TOL for d in diff.values()):
        fail(f"resnet50_train: captured evaluation {result} vs eager "
             f"{padded}")
    metrics["eval_captured"] = result
    whole = evaluate(unpadded, state, eval_batches())
    diff = {k: abs(padded[k] - whole[k]) for k in padded}
    tail = RESNET_EVAL_IMAGES % RESNET_EVAL_BATCH
    print(f"resnet50_train: evaluate over {RESNET_EVAL_IMAGES} images at "
          f"batch {RESNET_EVAL_BATCH} (a {tail}-row tail padded with a "
          f"'_valid' mask): loss {padded['loss']:.6f}, accuracy "
          f"{padded['accuracy']:.6f}; unpadded (batches {sizes}): loss "
          f"{whole['loss']:.6f}, accuracy {whole['accuracy']:.6f}; |diff| "
          f"{diff} (tol {EVAL_PAD_TOL})")
    if sizes[-1] != tail or not all(d <= EVAL_PAD_TOL for d in diff.values()):
        fail(f"resnet50_train: padded evaluation {padded} vs unpadded "
             f"{whole} (batches {sizes})")
    metrics["eval"] = padded
    metrics["eval_unpadded"] = whole
    del state, model, compiled_eval
    return launches, metrics


def rel_l2(a, b):
    """||a - b|| / ||b|| in f64 over tensors or lists of tensors."""
    if not isinstance(a, (list, tuple)):
        a, b = [a], [b]
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / den) ** 0.5 if den > 0 else num ** 0.5


def resnet_parity_phase(torch):
    """ResNet-50 at full width on the card from one set of seeded weights
    (each block's last BatchNorm scale set to RESNET_LAST_SCALE), one
    accumulated step of 2 microbatches of 16 uint8 224 x 224 images
    (device_normalize, label smoothing 0.1) on the bf16 path (channels_last,
    loss_impl="auto": 2 cross-entropy launches each way) and on an f32
    oracle (TF32 off in cuDNN and cuBLAS, loss_impl="reference", no
    launch). Relative L2 errors of the bf16 path against the oracle: the
    train-mode logits, the per-example losses, the step's loss, every
    gradient and the running statistics after the step; the logits and
    losses are gated at RESNET_PARITY_TOL."""
    import numpy as np
    import torch.nn.functional as F

    from tpudl_torch.config import get_config
    from tpudl_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD, device_normalize
    from tpudl_torch.models.resnet import BatchNorm, ResNet50
    from tpudl_torch.rng import fold_in, fold_seed
    from tpudl_torch.train import create_train_state, make_classification_train_step, make_optimizer

    cfg = get_config("imagenet_resnet50_dp")
    init = ResNet50(num_classes=cfg.num_classes, dtype=torch.float32,
                    device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    with torch.no_grad():
        for m in init.modules():
            if isinstance(m, BatchNorm) and m.zero_scale:
                m.scale.fill_(RESNET_LAST_SCALE)
    params = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    accum, micro = 2, RESNET_PARITY_MICRO
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (accum * micro, 224, 224, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, cfg.num_classes,
                                   accum * micro).astype(np.int32)}
    labels = torch.as_tensor(batch["label"], device="cuda").long()
    norm = device_normalize(IMAGENET_MEAN, IMAGENET_STD)
    x = norm({"image": torch.as_tensor(batch["image"], device="cuda")})["image"]
    seed = fold_seed(7, 0)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    for name, dtype, loss_impl in (("bf16", torch.bfloat16, "auto"),
                                   ("oracle", torch.float32, "reference")):
        torch.backends.cudnn.allow_tf32 = name != "oracle"
        st = create_train_state(0, ResNet50(num_classes=cfg.num_classes,
                                            dtype=dtype, device="meta"),
                                make_optimizer(cfg.optim), params=params)
        step = make_classification_train_step(
            cfg.label_smoothing, accum_steps=accum, input_transform=norm,
            loss_impl=loss_impl)
        stats0 = {k: v.clone() for k, v in st.batch_stats.items()}
        with torch.no_grad():
            logits = torch.cat([st.model(x[a * micro:(a + 1) * micro],
                                         train=True)
                                for a in range(accum)]).float()
        for k, v in stats0.items():  # the step moves them from the start
            st.batch_stats[k].copy_(v)
        before = train_counts()
        grads, metrics = step.grads_and_metrics(
            st, batch, [fold_in(seed, a, "cuda") for a in range(accum)])
        after = train_counts()
        launched = {k: after[k] - before[k] for k in after}
        want = {k: (resnet_counts(accum).get(k, 0) if name == "bf16" else 0)
                for k in after}
        if launched != want:
            fail(f"resnet_parity: the {name} path launched {launched}, "
                 f"expected {want}")
        out[name] = {
            "logits": logits,
            "losses": F.cross_entropy(logits, labels, reduction="none",
                                      label_smoothing=cfg.label_smoothing),
            "loss": metrics["loss"], "grads": grads,
            "stats": {k: v.clone() for k, v in st.batch_stats.items()}}
        del st
    torch.backends.cudnn.allow_tf32 = tf32
    k16, o = out["bf16"], out["oracle"]
    names = sorted(o["grads"])
    err = {"logits": rel_l2(k16["logits"], o["logits"]),
           "losses": rel_l2(k16["losses"], o["losses"]),
           "loss": rel_l2(k16["loss"], o["loss"]),
           "all gradients": rel_l2([k16["grads"][k] for k in names],
                                   [o["grads"][k] for k in names]),
           "running statistics": rel_l2(list(k16["stats"].values()),
                                        list(o["stats"].values()))}
    per = {k: rel_l2(k16["grads"][k], o["grads"][k]) for k in names}
    worst = sorted(per, key=lambda k: -per[k])[:4]
    print(f"resnet_parity: ResNet-50, {accum} microbatches x {micro} at "
          f"224x224, bf16 (channels_last, loss_impl='auto') vs the f32 oracle "
          f"(TF32 off), rel L2 err: logits {err['logits']:.3e}, per-example "
          f"losses {err['losses']:.3e} (gate {RESNET_PARITY_TOL:.4g} on "
          f"both), step loss {err['loss']:.3e}, all {len(names)} gradients "
          f"{err['all gradients']:.3e} (worst: "
          + ", ".join(f"{k} {per[k]:.3e}" for k in worst)
          + f"), running statistics {err['running statistics']:.3e}")
    bad = [k for k in ("logits", "losses")
           if not err[k] <= RESNET_PARITY_TOL]
    if bad:
        fail(f"resnet_parity: the bf16 path's {bad} exceed "
             f"{RESNET_PARITY_TOL} against the f32 oracle")
    del out, params
    torch.cuda.empty_cache()
    return {"rel_l2_err": err, "worst_gradients": {k: per[k] for k in worst},
            "tol": RESNET_PARITY_TOL, "microbatches": accum,
            "microbatch": micro}


def bert_remat_accum_phase(torch):
    """train_fused's two checks of the rest of the train loop, BERT-base at
    batch 256 x seq 128 with the fused slice (the same seeded weights):
    with dropout 0.1, remat="layer" gives the step's loss and every
    gradient bit for bit (the token-type table's too, since its lookup
    became a one-hot product), its encoder layers' forward kernels
    launched twice (the recompute); with dropout off, accum_steps=8 over
    the same
    256 rows gives the monolithic step's loss and gradients within
    ACCUM_TOL (relative L2, all gradients together)."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BERT_BASE, BertForSequenceClassification
    from tpudl_torch.rng import fold_in, fold_seed
    from tpudl_torch.train import create_train_state, make_classification_train_step

    init = BertForSequenceClassification(BERT_BASE(), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    params = {k: v.detach() for k, v in init.state_dict().items()}
    del init
    batch = next(synthetic_token_batches(BERT_BATCH, BERT_SEQ, 30522, seed=9))
    keys = ("input_ids", "attention_mask")
    model_kw, loss_impl = bert_variant(True)
    per_pass = launches_per_step(12, True)
    out, peaks = {}, {}
    for run, remat in (("none", False), ("layer", "layer")):
        st = create_train_state(0, BertForSequenceClassification(
            BERT_BASE(remat=remat, **model_kw), device="meta"),
            sst2_optimizer(), params=params)
        step = make_classification_train_step(input_keys=keys,
                                              loss_impl=loss_impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = train_counts()
        out[run] = step.grads_and_metrics(st, batch, fold_in(7, 0, "cuda"))
        after = train_counts()
        peaks[run] = torch.cuda.max_memory_allocated() / 2**30
        launched = {k: after[k] - before[k] for k in per_pass}
        want = dict(per_pass)
        if remat:  # the 12 layers' forwards run again in the backward
            for k in ("layer_norm_fwd", "bias_gelu_fwd",
                      "softmax_dropout_fwd"):
                want[k] += 24 if k == "layer_norm_fwd" else 12
        if launched != want:
            fail(f"train_fused: remat={remat!r} launched {launched}, "
                 f"expected {want}")
        del st
    (g0, m0), (g1, m1) = out["none"], out["layer"]
    bad = [k for k in g0 if not torch_equal(g0[k], g1[k])]
    if not torch_equal(m0["loss"], m1["loss"]) or bad:
        fail(f"train_fused: remat='layer' differs from no remat: loss "
             f"{float(m0['loss'])} vs {float(m1['loss'])}, gradients "
             f"{bad[:5]}")
    print(f"train_fused: remat='layer' with dropout 0.1: loss and all "
          f"{len(g0)} gradients bit for bit; peak memory "
          f"{peaks['none']:.2f} GiB without remat, {peaks['layer']:.2f} with")
    del out
    res = {}
    for accum in (1, BERT_ACCUM):
        st = create_train_state(0, BertForSequenceClassification(
            BERT_BASE(hidden_dropout=0.0, attention_dropout=0.0, **model_kw),
            device="meta"), sst2_optimizer(), params=params)
        step = make_classification_train_step(
            input_keys=keys, loss_impl=loss_impl, accum_steps=accum)
        gen = (fold_in(7, 0, "cuda") if accum == 1 else
               [fold_in(fold_seed(7, 0), a, "cuda") for a in range(accum)])
        before = train_counts()
        res[accum] = step.grads_and_metrics(st, batch, gen)
        after = train_counts()
        launched = {k: after[k] - before[k] for k in per_pass}
        want = {k: v * accum for k, v in per_pass.items()}
        if launched != want:
            fail(f"train_fused: accum_steps={accum} launched {launched}, "
                 f"expected {want}")
        del st
    (ga, ma), (gb, mb) = res[1], res[BERT_ACCUM]
    names = sorted(ga)
    err = {"loss": rel_l2(mb["loss"], ma["loss"]),
           "all gradients": rel_l2([gb[k] for k in names],
                                   [ga[k] for k in names])}
    per = {k: rel_l2(gb[k], ga[k]) for k in names}
    worst = sorted(per, key=lambda k: -per[k])[:4]
    print(f"train_fused: accum_steps={BERT_ACCUM} (microbatches of "
          f"{BERT_BATCH // BERT_ACCUM}) vs the monolithic step, dropout off, "
          f"rel L2: loss {err['loss']:.3e}, all {len(names)} gradients "
          f"{err['all gradients']:.3e} (tol {ACCUM_TOL}; worst tensors, not "
          f"judged: " + ", ".join(f"{k} {per[k]:.3e}" for k in worst) + ")")
    if not max(err.values()) <= ACCUM_TOL:
        fail(f"train_fused: accumulation differs from the monolithic step "
             f"by {err} (tol {ACCUM_TOL})")
    del res, params
    torch.cuda.empty_cache()
    return {"remat_bitwise_tensors": len(g0),
            "remat_peak_memory_gib": {"none": peaks["none"],
                                      "layer": peaks["layer"]},
        "accum_rel_l2_err": err, "accum_steps": BERT_ACCUM}


#: generate()'s chunked decode on the 8B slice (generate_chunked).
GEN_BATCH = 4
GEN_PROMPT = 128
GEN_NEW = 64
GEN_EVERY = 8
#: The captured dense slice with its prefill still eager, on this card
#: (NVIDIA H100 80GB HBM3, 700 W): TTFT p50 and TPOT p50, ms, printed
#: beside this run's.
EAGER_PREFILL_TTFT_P50_MS = 713.14
EAGER_PREFILL_TPOT_P50_MS = 14.249
#: ResNet-50 export: strict parity in f32 at this batch, deployed parity
#: and the latency at the other two (bf16, channels_last inside).
RESNET_STRICT_BATCH = 8
RESNET_DEPLOY_BATCH = 128
LATENCY_WARMUP = 5
LATENCY_ITERS = 30
#: BERT-base export: the eval batch exported and compared card vs CPU.
BERT_EXPORT_BATCH = 8
#: Captured remat steps (remat_captured): steps a way, the last timed.
REMAT_STEPS = 4
REMAT_TIMED = 2


def export_dir():
    """Artifacts go under the checkout's gitignored build/ directory."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "export")
    os.makedirs(path, exist_ok=True)
    return path


def prefill_ms(torch, session, reps=20):
    """Wall ms per call of ``session``'s prefill on a left-padded [1,
    PROMPT_LEN] prompt, the first token read back each call (what TTFT
    pays a request), after two calls (the eager one and, where captured,
    the capture)."""
    import numpy as np

    eng = session.engine
    ids = np.zeros((1, PROMPT_LEN), np.int32)
    ids[0, 28:] = np.arange(1, PROMPT_LEN - 27)
    mask = (ids != 0).astype(np.int32)
    args = (eng.params, ids, mask)
    pool = eng.adapter_pool
    if pool is not None:
        # A tenantless request: the zero table row, nothing pinned.
        row, scaling = pool.acquire(None)
        args += (pool.pools, row[None, :], np.float32([scaling]))
    call = eng.prefill_call
    for _ in range(2):
        call(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        logits, _ = call(*args)
        greedy = getattr(call, "greedy", None)
        int((logits.float().argmax(-1) if greedy is None else greedy)[0])
    return (time.perf_counter() - t0) / reps * 1e3


def generate_chunked_phase(torch, model, params, card):
    """generate() on the 8B slice at full width and depth, batch GEN_BATCH
    (ragged, left-padded) x prompt GEN_PROMPT, GEN_NEW new tokens, chunks
    of GEN_EVERY: the chunked loop (a CUDA graph a chunk, the first use of
    each chunk length eager) against the per-token loop, greedy and
    sampled (temperature 0.8, top-k 50, top-p 0.9, one generator seed):
    tokens bit for bit, 65 RMSNorm and 32 SwiGLU launches a token each
    way, tokens/s of each loop's last call."""
    import importlib

    import numpy as np

    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm

    gen = importlib.import_module("tpudl_torch.models.generate")
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(1, model.cfg.vocab_size,
                                       (GEN_BATCH, GEN_PROMPT)), device="cuda")
    mask = torch.ones_like(ids)
    mask[1, :40] = 0
    mask[3, :90] = 0
    ids = ids * mask
    out = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, top_p=0.9))):
        toks, rate = {}, {}
        for chunked in (False, True):
            for _ in range(3 if chunked else 2):
                rms_norm.launches = swiglu.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = gen.generate(
                    model, params, ids, mask, max_new_tokens=GEN_NEW,
                    eos_check_every=GEN_EVERY, chunked=chunked,
                    generator=torch.Generator(device="cuda").manual_seed(11),
                    **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if chunked in toks and not torch.equal(got, toks[chunked]):
                    fail(f"generate_chunked ({name}): two runs of the "
                         f"{'chunked' if chunked else 'per-token'} loop "
                         f"differ")
                toks[chunked] = got
                launches = {"rms_norm_fwd": rms_norm.launches,
                            "swiglu_fwd": swiglu.launches}
                want = {"rms_norm_fwd": 65 * GEN_NEW,
                        "swiglu_fwd": 32 * GEN_NEW}
                if launches != want:
                    fail(f"generate_chunked ({name}, chunked={chunked}): "
                         f"launches {launches}, expected {want}")
            rate[chunked] = GEN_BATCH * GEN_NEW / wall
        if not torch.equal(toks[False], toks[True]):
            fail(f"generate_chunked ({name}): the chunked loop's tokens are "
                 f"not the per-token loop's")
        if toks[True].shape != (GEN_BATCH, GEN_NEW):
            fail(f"generate_chunked: tokens of shape {tuple(toks[True].shape)}")
        print(f"generate_chunked ({name}, {card}): batch {GEN_BATCH} x prompt "
              f"{GEN_PROMPT}, {GEN_NEW} new tokens, chunks of {GEN_EVERY}: "
              f"tokens bit for bit the per-token loop's; per-token loop "
              f"{rate[False]:.1f} tokens/s, chunked {rate[True]:.1f} "
              f"tokens/s ({rate[True] / rate[False]:.2f}x)")
        out[name] = {"token_loop_tokens_per_s": rate[False],
                     "chunked_tokens_per_s": rate[True]}
    out["chunk_graphs"] = gen.chunk_graphs(model)
    print(f"generate_chunked: {out['chunk_graphs']} chunk graphs captured "
          f"(per switch set: the chunk of {GEN_EVERY} and the remainder of "
          f"{(GEN_NEW - 1) % GEN_EVERY})")
    return out


#: export_llama_serving: the 8B's width, its first layers (tracing and
#: loading the serving programs of all 32 layers took ~63 s of the run).
EXPORT_SERVING_LAYERS = 4


def cut_llama(model, params, num_layers):
    """The model and weights of ``model``'s first ``num_layers`` layers, at
    its width (the embedding, final norm and head kept)."""
    import dataclasses

    from tpudl_torch.models.llama import LlamaForCausalLM

    cut = LlamaForCausalLM(dataclasses.replace(model.cfg,
                                               num_layers=num_layers),
                           device="meta")
    return cut, {k: v for k, v in params.items()
                 if not k.startswith("model.layer_")
                 or int(k.split(".")[1].removeprefix("layer_")) < num_layers}


def export_llama_serving_phase(torch, model, params, card, requests):
    """The slice's serving artifacts (export_serving_decoder: a batch-1
    prefill at PROMPT_LEN and a NUM_SLOTS decode, the weights as inputs),
    dense and paged (page 16), at the 8B's width cut to
    EXPORT_SERVING_LAYERS layers (its first layers' weights): every norm
    and SwiGLU a tpudl:: node, export and load seconds, program bytes;
    ServeSession.from_artifacts (prefill and decode captured) reads the
    shapes back and serves the slice's requests with the tokens and
    launches of a model session of the same cut model; TPOT beside that
    session's."""
    from tpudl_torch.export.decode import export_serving_decoder
    from tpudl_torch.export.export import load_exported_obj
    from tpudl_torch.ops.library import graph_ops
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.serve import Request, ServeSession

    n = EXPORT_SERVING_LAYERS
    model, params = cut_llama(model, params, n)
    per_call = {"rms_norm": 2 * n + 1, "swiglu": n}
    counted = {"rms_norm_fwd": rms_norm, "swiglu_fwd": swiglu}
    out = {}
    for paged in (False, True):
        way = "paged" if paged else "dense"
        kw = dict(paged=True, page_size=16) if paged else {}
        ref = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                      num_slots=NUM_SLOTS, **kw)
        shape = (ref.num_slots, ref.prompt_len, ref.max_seq_len)
        if paged:
            shape += (ref.engine.cache.page_size, ref.engine.cache.num_pages)
        ref.serve([Request("warm", [1, 2, 3], max_new_tokens=2)])
        _, ref_results, ref_wall, _, _ = serve_run(torch, ref, requests,
                                                   counted)
        ref_tpot = pct([r.tpot_s * 1e3 for r in ref_results.values()
                        if r.tpot_s is not None], 50)
        del ref
        t0 = time.perf_counter()
        pre, dec = export_serving_decoder(model, params, NUM_SLOTS,
                                          PROMPT_LEN, **kw)
        export_s = time.perf_counter() - t0
        for what, blob in (("prefill", pre), ("decode", dec)):
            ops = graph_ops(load_exported_obj(blob).graph_module)
            if ops != per_call:
                fail(f"export_llama_serving ({way}): the {what} program "
                     f"holds tpudl:: nodes {ops}, expected {per_call}")
        t0 = time.perf_counter()
        session = ServeSession.from_artifacts(pre, dec, params, paged=paged)
        load_s = time.perf_counter() - t0
        got_shape = (session.num_slots, session.prompt_len,
                     session.max_seq_len)
        if paged:
            got_shape += (session.engine.cache.page_size,
                          session.engine.cache.num_pages)
        if got_shape != shape:
            fail(f"export_llama_serving ({way}): from_artifacts read back "
                 f"{got_shape}, the session has {shape}")
        session.serve([Request("warm", [1, 2, 3], max_new_tokens=2)])
        _, results, wall, launches, peak = serve_run(torch, session, requests,
                                                     counted)
        eng = session.engine
        calls = eng.num_prefills + eng.num_decode_steps
        # The warm-up request's prefill and decode steps come first.
        want = {"rms_norm_fwd": per_call["rms_norm"] * (calls - 2),
                "swiglu_fwd": per_call["swiglu"] * (calls - 2)}
        if launches != want:
            fail(f"export_llama_serving ({way}): launches {launches}, "
                 f"expected {want}")
        differ = [r.request_id for r in requests
                  if results[r.request_id].tokens
                  != ref_results[r.request_id].tokens]
        if differ:
            fail(f"export_llama_serving ({way}): the artifact session's "
                 f"tokens differ from the model session's for {differ}")
        tpot = pct([r.tpot_s * 1e3 for r in results.values()
                    if r.tpot_s is not None], 50)
        ttft = pct([r.ttft_s * 1e3 for r in results.values()], 50)
        print(f"export_llama_serving ({way}, {n} layers, {card}): export "
              f"{export_s:.2f} s (prefill {len(pre) / 1e6:.3f} MB, decode "
              f"{len(dec) / 1e6:.3f} MB, no weights), load {load_s:.2f} s; "
              f"from_artifacts read back slots, window, bound"
              + (", page size, pool pages" if paged else "") + f" {got_shape}"
              f"; {len(requests)} requests with the model session's tokens; "
              f"TPOT p50 {tpot:.3f} ms (model session {ref_tpot:.3f}), TTFT "
              f"p50 {ttft:.2f} ms; prefill graph captured in "
              f"{eng.prefill_call.capture_s * 1e3:.1f} ms, decode graph in "
              f"{eng.decode_call.capture_s * 1e3:.1f} ms; peak memory "
              f"{peak:.2f} GiB")
        out[way] = {"layers": n, "export_s": export_s, "load_s": load_s,
                    "prefill_bytes": len(pre), "decode_bytes": len(dec),
                    "tpot_p50_ms": tpot, "ttft_p50_ms": ttft,
                    "model_tpot_p50_ms": ref_tpot, "launches": launches}
        del session
        gc.collect()
    return out


def _cpu_parity_cases(torch, report, what, strict):
    if not report.ok:
        fail(f"{what}: {report}")
    print(f"{what}: {'strict' if strict else 'deployed'} parity card vs CPU "
          f"from one artifact: {report}")
    return {"ok": report.ok, "max_abs_err": report.max_abs_err,
            "max_rel_err": report.max_rel_err, "rtol": report.rtol,
            "atol": report.atol}


def export_resnet50_phase(torch, card):
    """imagenet_resnet50_dp's ResNet-50 (configs[2]) eval forward as an
    artifact, exported on the card from a model built on meta (the
    weights and BatchNorm statistics are inputs, saved apart with
    save_params): f32 at batch RESNET_STRICT_BATCH held card against CPU
    in strict mode (TF32 off in cuBLAS and cuDNN; rtol 1e-5, atol 1e-4),
    bf16 at RESNET_DEPLOY_BATCH in deployed mode (2e-2); artifact sizes;
    latency_benchmark (transfer and compute percentiles) of the loaded
    bf16 program at batch 1 and RESNET_DEPLOY_BATCH, alone and replayed
    from a CUDA graph."""
    from tpudl_torch.export import (
        artifact_sizes,
        check_parity,
        export_program,
        forward_fn,
        latency_benchmark,
        load_exported,
        load_params,
        save_params,
    )
    from tpudl_torch.models.registry import build_model

    out = {}
    d = export_dir()
    for dtype, batch, strict in ((torch.float32, RESNET_STRICT_BATCH, True),
                                 (torch.bfloat16, RESNET_DEPLOY_BATCH, False)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        model = build_model("resnet50", 1000, dtype=dtype)
        model.init_weights(torch.Generator(device="cuda").manual_seed(3))
        with torch.no_grad():
            # Statistics off their init, so that the artifact's use of them
            # shows in the output.
            g = torch.Generator(device="cuda").manual_seed(4)
            for name, t in model.named_buffers():
                t.add_(0.1 * torch.rand(t.shape, generator=g, device="cuda"))
        params = {k: v.detach() for k, v in model.state_dict().items()}
        del model
        meta = build_model("resnet50", 1000, dtype=dtype, device="meta")
        x = torch.randn(batch, 224, 224, 3,
                        generator=torch.Generator().manual_seed(5))
        path = os.path.join(d, f"resnet50_{tag}.pt2")
        ppath = os.path.join(d, f"resnet50_{tag}.safetensors")
        t0 = time.perf_counter()
        export_program(forward_fn(meta, train=False), (params, x.cuda()),
                       path=path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_params(ppath, params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_params(ppath, like=params)
        load_params_s = time.perf_counter() - t0
        bad = [k for k in params if not torch_equal(params[k], loaded[k])]
        if bad:
            fail(f"export_resnet50: load_params changed {bad[:5]}")
        t0 = time.perf_counter()
        program = load_exported(path)
        load_s = time.perf_counter() - t0
        sizes = artifact_sizes(path, ppath)
        t0 = time.perf_counter()
        report = check_parity(path, (loaded, x), strict=strict)
        parity_s = time.perf_counter() - t0
        m = {"export_s": export_s, "load_s": load_s, "save_params_s": save_s,
             "load_params_s": load_params_s, "parity_s": parity_s,
             "program_bytes": sizes[path], "params_bytes": sizes[ppath],
             "parity": _cpu_parity_cases(
                 torch, report, f"export_resnet50 ({tag}, batch {batch})",
                 strict)}
        print(f"export_resnet50 ({tag}, {card}): export {export_s:.2f} s, "
              f"program {sizes[path] / 1e6:.3f} MB, params "
              f"{sizes[ppath] / 1e6:.1f} MB (save {save_s:.2f} s, load "
              f"{load_params_s:.2f} s, bit for bit), program load "
              f"{load_s:.2f} s, parity check {parity_s:.1f} s")
        if not strict:
            # Shapes are static: batch 1 is an artifact of its own.
            programs = {RESNET_DEPLOY_BATCH: program}
            path1 = os.path.join(d, f"resnet50_{tag}_batch1.pt2")
            export_program(forward_fn(meta, train=False),
                           (params, x[:1].cuda()), path=path1)
            programs[1] = load_exported(path1)
            for b in (1, RESNET_DEPLOY_BATCH):
                def fn(images, program=programs[b], params=loaded):
                    return program(params, images)

                for graph in (False, True):
                    res = latency_benchmark(fn, (x[:b].numpy(),),
                                            warmup=LATENCY_WARMUP,
                                            iters=LATENCY_ITERS, graph=graph)
                    key = f"batch{b}_{'graph' if graph else 'program'}"
                    m[key] = {w: {q: res[w][q] for q in
                                  ("p50_ms", "p95_ms", "p99_ms")}
                              for w in ("transfer", "compute")}
                    print(f"export_resnet50 latency ({tag}, batch {b}, "
                          f"{'CUDA graph' if graph else 'loaded program'}, "
                          f"{card}): transfer p50/p95/p99 "
                          + "/".join(f"{res['transfer'][q]:.3f}" for q in
                                     ("p50_ms", "p95_ms", "p99_ms"))
                          + " ms, compute "
                          + "/".join(f"{res['compute'][q]:.3f}" for q in
                                     ("p50_ms", "p95_ms", "p99_ms"))
                          + f" ms ({LATENCY_ITERS} iterations after "
                          f"{LATENCY_WARMUP})")
        out[tag] = m
        del program, loaded, params, meta
        gc.collect()
        torch.cuda.empty_cache()
    return out


def export_bert_phase(torch, card):
    """BERT-base at seq 128 with the fused slice (train_fused's model),
    its eval forward exported on the card: the program holds 25
    tpudl::layer_norm, 12 bias_gelu and 12 softmax_dropout nodes (rate 0:
    no draw); one forward of the loaded program on the card launches each
    kernel that many times; deployed parity card against CPU at batch
    BERT_EXPORT_BATCH."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.export import check_parity, export_program, forward_fn
    from tpudl_torch.export.export import load_exported_obj
    from tpudl_torch.models.bert import BERT_BASE, BertForSequenceClassification
    from tpudl_torch.ops.library import graph_ops

    model_kw, _ = bert_variant(True)
    init = BertForSequenceClassification(BERT_BASE(**model_kw), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    params = {k: v.detach() for k, v in init.state_dict().items()}
    del init
    meta = BertForSequenceClassification(BERT_BASE(**model_kw), device="meta")
    batch = next(synthetic_token_batches(BERT_EXPORT_BATCH, BERT_SEQ, 30522,
                                         seed=9))
    ids = torch.as_tensor(batch["input_ids"])
    mask = torch.as_tensor(batch["attention_mask"])
    t0 = time.perf_counter()
    path = os.path.join(export_dir(), "bert_base.pt2")
    export_program(forward_fn(meta, train=False),
                   (params, ids.cuda(), mask.cuda()), path=path)
    export_s = time.perf_counter() - t0
    program = load_exported_obj(path)
    ops = graph_ops(program.graph_module)
    want = {"layer_norm": 25, "bias_gelu": 12, "softmax_dropout": 12}
    if ops != want:
        fail(f"export_bert: the program holds tpudl:: nodes {ops}, expected "
             f"{want}")
    drawn = [str(n.target) for n in program.graph.nodes
             if "rand" in str(n.target) or "bernoulli" in str(n.target)]
    if drawn:
        fail(f"export_bert: the eval program draws random bits: {drawn}")
    module = program.module()
    with torch.no_grad():
        module(params, ids.cuda(), mask.cuda())  # warm-up
        reset_counts()
        module(params, ids.cuda(), mask.cuda())
        torch.cuda.synchronize()
    counts = train_counts()
    launched = {"layer_norm": counts["layer_norm_fwd"],
                "bias_gelu": counts["bias_gelu_fwd"],
                "softmax_dropout": counts["softmax_dropout_fwd"]}
    if launched != want or sum(counts.values()) != sum(want.values()):
        fail(f"export_bert: one forward of the loaded program launched "
             f"{counts}, expected {want}")
    t0 = time.perf_counter()
    report = check_parity(path, (params, ids, mask), strict=False)
    parity_s = time.perf_counter() - t0
    print(f"export_bert ({card}): BERT-base seq {BERT_SEQ}, batch "
          f"{BERT_EXPORT_BATCH}, export {export_s:.2f} s, program "
          f"{os.path.getsize(path) / 1e6:.3f} MB; tpudl:: nodes {ops}, one "
          f"forward of the loaded program on the card launched {launched}; "
          f"parity check {parity_s:.1f} s")
    return {"export_s": export_s, "ops": ops, "launches": launched,
            "parity": _cpu_parity_cases(torch, report, "export_bert", False)}


def remat_captured_phase(torch, card, no_remat_peak_gib):
    """compile_step with remat: BERT-base at batch 256 x seq 128 with the
    fused slice, remat="layer", dropout 0.1 (the recomputes draw from the
    capture's twin generators), and llama_train_parity's 2-layer
    Llama-3-8B LoRA classifier with remat=True at 1 x 2048: REMAT_STEPS
    steps eagerly and REMAT_STEPS through compile_step from the same
    weights and batches, losses, parameters and optimizer state equal bit
    for bit; step ms of the last REMAT_TIMED steps each way, capture
    seconds and peak memory (BERT: against ``no_remat_peak_gib``, the
    train_fused step's)."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BERT_BASE, BertForSequenceClassification
    from tpudl_torch.models.llama import LLAMA3_8B, LlamaForSequenceClassification
    from tpudl_torch.models.lora import lora_optimizer
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        make_classification_train_step,
    )

    out = {}
    keys = ("input_ids", "attention_mask")
    model_kw, loss_impl = bert_variant(True)
    init = BertForSequenceClassification(BERT_BASE(**model_kw), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    bert_params = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    kw = dict(num_layers=2, lora_rank=16, num_labels=2)
    init = LlamaForSequenceClassification(LLAMA3_8B(**kw), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(11))
    draw_lora_b(torch, init, torch.Generator(device="cuda").manual_seed(12),
                0.02)
    llama_params = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    cases = {
        "bert": (lambda: BertForSequenceClassification(
            BERT_BASE(remat="layer", **model_kw), device="meta"),
            sst2_optimizer, bert_params, loss_impl,
            list(synthetic_token_batches(BERT_BATCH, BERT_SEQ, 30522, seed=3,
                                         num_batches=REMAT_STEPS))),
        "llama": (lambda: LlamaForSequenceClassification(
            LLAMA3_8B(fused_ops=True, attention_impl="flash", remat=True,
                      **kw), device="meta"),
            None, llama_params, "reference",
            list(synthetic_token_batches(1, LLAMA_SEQ, 128256, seed=9,
                                         num_batches=REMAT_STEPS))),
    }
    for name, (make, optim, params, impl, batches) in cases.items():
        step = make_classification_train_step(input_keys=keys,
                                              loss_impl=impl)
        runs = {}
        for capture in (False, True):
            model = make()
            tx = (optim() if optim is not None else lora_optimizer(
                llama_optimizer(constant=True), model, ("classifier",)))
            state = create_train_state(0, model, tx, params=params)
            run_step = compile_step(step, state) if capture else step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for i, batch in enumerate(batches):
                if i == REMAT_STEPS - REMAT_TIMED:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, metrics = run_step(state, batch, 5)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / REMAT_TIMED * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            snapshot = (torch.stack(losses),
                        {k: v.detach().clone() for k, v in
                         state.model.state_dict().items()},
                        {k: {n: t.clone() for n, t in v.items()}
                         for k, v in state.opt_state.items()
                         if isinstance(v, dict)}, state.step)
            runs[capture] = (snapshot, step_ms, peak,
                             getattr(run_step, "capture_s", None),
                             getattr(run_step, "twins", None))
            del state, model, run_step
            gc.collect()
            torch.cuda.empty_cache()
        check_bitwise(f"remat_captured ({name})", runs[False][0],
                      runs[True][0])
        twins = runs[True][4]
        n_twins = 0 if twins is None else len(twins.twins)
        (_, eager_ms, eager_peak, _, _), (_, ms, peak, capture_s, _) = (
            runs[False], runs[True])
        print(f"remat_captured ({name}, {card}): step {ms:.2f} ms captured, "
              f"{eager_ms:.2f} eager; captured in {capture_s:.3f} s with "
              f"{n_twins} recompute twin generators; peak memory "
              f"{peak:.2f} GiB captured, {eager_peak:.2f} eager"
              + (f" (train_fused without remat: {no_remat_peak_gib:.2f})"
                 if name == "bert" else ""))
        out[name] = {"step_ms": ms, "eager_step_ms": eager_ms,
                     "capture_s": capture_s, "peak_memory_gib": peak,
                     "eager_peak_memory_gib": eager_peak,
                     "recompute_twins": n_twins}
    return out


#: (kernel, kind, variant, vectors a thread) of the bf16 norm forwards
#: the main paths launch: BERT's LayerNorm at H 768 (3 vectors a lane),
#: Llama's RMSNorm at H 4096 (2 vectors a thread).
MAIN_PATH_NORM_KERNELS = {
    ("norm_fwd_rows_kernel", "LayerNorm", v, vpl) for v in ("plain", "residual")
    for vpl in ("3", "4")  # H 768 (BERT-base), 1024 (BERT-large)
} | {("norm_fwd_wide_kernel", "RMSNorm", v, "2") for v in ("plain", "residual+sum")}
#: The norm backward's instantiations on the main paths (kernel, dtype,
#: kind, vectors a lane or thread): the rows kernel at H 768 and 1024 in
#: bf16 and 768 in f32 (BERT-base's f32 policy), the wide kernel at the
#: f32 embeddings' H 1024 of BERT-large, Llama-3-8B's H 4096 and
#: Llama-3.2-1B's H 2048.
MAIN_PATH_NORM_BWD_KERNELS = {
    ("norm_bwd_rows_kernel", "bf16", "LayerNorm", "3"),
    ("norm_bwd_rows_kernel", "bf16", "LayerNorm", "4"),
    ("norm_bwd_rows_kernel", "f32", "LayerNorm", "6"),
    ("norm_bwd_wide_kernel", "f32", "LayerNorm", "1"),
    ("norm_bwd_wide_kernel", "bf16", "RMSNorm", "2"),
    ("norm_bwd_wide_kernel", "bf16", "RMSNorm", "1"),
}


#: Checkpointing and fault tolerance (ft_bert, ft_resnet50, ft_kill):
#: BERT-base steps of the uninterrupted run, the checkpoint cadence, the
#: step the logger sends SIGTERM at; ResNet-50 steps and the save step;
#: the supervised child's steps, cadence and chaos kill step.
FT_BERT_STEPS = 12
FT_BERT_EVERY = 4
FT_BERT_SIGTERM_AT = 6
FT_RESNET_STEPS = 6
FT_RESNET_SAVE_AT = 3
FT_KILL_STEPS = 8
FT_KILL_EVERY = 2
FT_KILL_AT = 5


def ft_snapshot(losses, state):
    """check_bitwise's (losses, state_dict, optimizer tensors, step), with
    the optimizer's device count and host count as one-element tensors."""
    import torch

    opt = {k: {n: t.clone() for n, t in v.items()}
           for k, v in state.opt_state.items() if isinstance(v, dict)}
    opt["counts"] = {
        "count": state.opt_state["count"].detach().clone().view(1).cpu(),
        "host_count": torch.tensor([state.opt_state["host_count"]])}
    return (torch.stack(losses).clone(),
            {k: v.detach().clone() for k, v in
             state.model.state_dict().items()}, opt, state.step)


def payload_digest(state):
    """sha256 over every leaf of the checkpoint payload (keys and bytes,
    in payload order): the state's parameters, statistics, optimizer
    tensors, counts and step."""
    import hashlib

    import torch

    from tpudl_torch.ft.manager import flatten_with_keys, state_payload

    h = hashlib.sha256()
    for key, t in flatten_with_keys(state_payload(state)):
        h.update(key.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def histogram_since(name, before):
    """The observations of a tpudl_torch.obs histogram after the first
    ``before`` (the count when a phase started)."""
    from tpudl_torch.obs import counters as obs_counters

    values = obs_counters.registry().histogram(name).values
    return values[before:]


def hist_counts(*names):
    from tpudl_torch.obs import counters as obs_counters

    reg = obs_counters.registry()
    return {n: reg.histogram(n).count for n in names}


def ft_bert_state(torch, seed, params=None):
    """BERT-base on the fused slice (bert_variant(True), dropout 0.1) from
    ``seed`` (or ``params``), the sst2_bert_base optimizer at a constant
    rate."""
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import create_train_state

    model_kw, _ = bert_variant(True)
    model = build_model("bert-base", 2, **model_kw)
    return create_train_state(seed, model, sst2_optimizer(), params=params)


def ft_bert_step():
    from tpudl_torch.train import make_classification_train_step

    _, loss_impl = bert_variant(True)
    return make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), label_key="label",
        loss_impl=loss_impl)


def ft_fit(torch, step, state, data, num_steps, mgr=None, every=0, rng=1,
           on_log=None):
    """fit through ``step`` (a compiled step) with a per-step logger: the
    losses as device tensors, the wall clock at each log (after the
    step's checkpoint, if any, and the loss's read-back), and ``on_log``.
    Returns (state, losses, log times, info)."""
    from tpudl_torch.train import fit

    losses, times = [], []

    def recorded(state, batch, rng):
        state, metrics = step(state, batch, rng)
        losses.append(metrics["loss"])
        return state, metrics

    def logger(i, metrics):
        times.append(time.perf_counter())
        if on_log is not None:
            on_log(i, metrics)

    state, _, info = fit(recorded, state, data, rng, num_steps=num_steps,
                         log_every=1, logger=logger, checkpoint_manager=mgr,
                         checkpoint_every=every)
    return state, losses, times, info


def ft_bert_phase(torch, card):
    """configs[1] BERT-base at full width and depth, fused as
    bert_variant(True) runs it (256 x 128, dropout 0.1, sst2_optimizer,
    compile_step), checkpointed through an AsyncCheckpointManager in a
    temporary directory (removed at the end):

    1. control: FT_BERT_STEPS uninterrupted steps;
    2. the same with checkpoint_every=FT_BERT_EVERY (the step time with
       and without the cadence, each save's stall and write);
    3. interrupted: checkpoint_every=FT_BERT_EVERY under a
       PreemptionGuard, the logger sending SIGTERM at step
       FT_BERT_SIGTERM_AT: a save at FT_BERT_EVERY, the emergency save at
       FT_BERT_SIGTERM_AT, info["preempted"], the flag cleared after;
    4. restore in place: the step-FT_BERT_EVERY checkpoint into the
       interrupted run's own state, which its compiled step captured at
       step 2: the same tensors (data_ptr), then that compiled step
       replays the rest of the schedule to the control's end;
    5. resumed: a state initialised from another seed, resume_run
       (start FT_BERT_SIGTERM_AT, the saved seed), a fresh compile_step,
       fit for the rest (counts reset just before: the fused slice's
       launches a step);
    6. the same save with async_save=False, and a restore's time.

    4 and 5 end bit for bit where 1 ends: the losses, every parameter,
    the optimizer's moments and counts, and the step."""
    import shutil
    import signal
    import tempfile

    from tpudl_torch.checkpoint import CheckpointManager
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.ft import (
        AsyncCheckpointManager,
        PreemptionGuard,
        ResumableIterator,
        resume_run,
    )
    from tpudl_torch.ft import preemption as ft_preemption
    from tpudl_torch.train import compile_step

    n, every, stop = FT_BERT_STEPS, FT_BERT_EVERY, FT_BERT_SIGTERM_AT
    step_fn = ft_bert_step()
    root = tempfile.mkdtemp(prefix="tpudl_ft_bert_")
    try:
        t0 = time.perf_counter()
        state = ft_bert_state(torch, 0)
        batches = list(synthetic_token_batches(
            BERT_BATCH, BERT_SEQ, state.model.cfg.vocab_size,
            num_batches=n, seed=11))
        init = {k: v.detach().clone()
                for k, v in state.model.state_dict().items()}

        def fresh_from_init():
            return ft_bert_state(torch, 0, init)

        print(f"ft_bert: BERT-base ({bert_variant(True)[0]}), batch "
              f"{BERT_BATCH} x seq {BERT_SEQ}, dropout 0.1, compile_step, "
              f"checkpoints under {root}; set-up "
              f"{time.perf_counter() - t0:.1f} s")

        # 1. control
        state, losses, times, _ = ft_fit(
            torch, compile_step(step_fn, state), state,
            ResumableIterator(batches), n)
        control = ft_snapshot(losses, state)
        plain_ms = (times[-1] - times[1]) / (n - 2) * 1e3
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # 2. the cadence's cost
        before = hist_counts("checkpoint_stall_s", "checkpoint_write_s",
                             "checkpoint_backpressure_s")
        state = fresh_from_init()
        with AsyncCheckpointManager(os.path.join(root, "cadence")) as mgr:
            state, losses, times, _ = ft_fit(
                torch, compile_step(step_fn, state), state,
                ResumableIterator(batches), n, mgr=mgr, every=every)
            cadence_ms = (times[-1] - times[1]) / (n - 2) * 1e3
            mgr.wait_until_finished()
            meta = mgr.store.read_meta(n)
        stalls = histogram_since("checkpoint_stall_s",
                                 before["checkpoint_stall_s"])
        writes = histogram_since("checkpoint_write_s",
                                 before["checkpoint_write_s"])
        waits = histogram_since("checkpoint_backpressure_s",
                                before["checkpoint_backpressure_s"])
        nbytes = sum(leaf["nbytes"] for leaf in meta["leaves"])
        dtypes = {}
        for leaf in meta["leaves"]:
            kind = leaf["key"].split("']")[0][2:]
            dtypes.setdefault(f"{kind} {leaf['dtype']}", 0)
            dtypes[f"{kind} {leaf['dtype']}"] += leaf["nbytes"]
        check_bitwise("ft_bert", control, ft_snapshot(losses, state),
                      ("checkpoint_every=4", "uninterrupted"))
        print(f"ft_bert ({card}): payload {nbytes} bytes in "
              f"{len(meta['leaves'])} leaves ({dtypes}); captured step "
              f"{plain_ms:.2f} ms without checkpoints, {cadence_ms:.2f} ms "
              f"with checkpoint_every={every} (wall from the log after step "
              f"2 to the log after step {n}, the loss read back each step); "
              f"async save stall (host copy + back-pressure) "
              f"{', '.join(f'{x:.3f}' for x in stalls)} s, back-pressure "
              f"{', '.join(f'{x:.3f}' for x in waits) or 'none'} s, "
              f"background write and commit "
              f"{', '.join(f'{x:.3f}' for x in writes)} s")
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # 3. interrupted by SIGTERM
        def sigterm(i, metrics):
            if i == stop:
                os.kill(os.getpid(), signal.SIGTERM)

        ft_preemption.reset()
        ck = os.path.join(root, "run")
        state_i = fresh_from_init()
        step_i = compile_step(step_fn, state_i)
        with AsyncCheckpointManager(ck) as mgr:
            with PreemptionGuard(grace_s=120.0):
                state_i, head, _, info = ft_fit(
                    torch, step_i, state_i, ResumableIterator(batches), n,
                    mgr=mgr, every=every, on_log=sigterm)
                flagged = ft_preemption.requested()
            steps_saved = mgr.all_steps()
        if not (info["preempted"] and info["steps"] == stop and flagged
                and steps_saved == [every, stop]
                and not ft_preemption.requested()):
            fail(f"ft_bert: SIGTERM at step {stop}: info {info}, flag "
                 f"{flagged} then {ft_preemption.requested()}, committed "
                 f"steps {steps_saved} (expected [{every}, {stop}])")
        if not step_i.captured:
            fail("ft_bert: the interrupted run's step never captured")

        # 4. restore in place into the captured state, replay the rest
        ptrs = {k: v.data_ptr() for k, v in state_i.model.state_dict().items()}
        ptrs.update({f"{k}/{m}": t.data_ptr()
                     for k, v in state_i.opt_state.items()
                     if isinstance(v, dict) for m, t in v.items()})
        with AsyncCheckpointManager(ck) as mgr:
            t1 = time.perf_counter()
            state_i, rng, data_state = mgr.restore_full(state_i, step=every)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
        now = {k: v.data_ptr() for k, v in state_i.model.state_dict().items()}
        now.update({f"{k}/{m}": t.data_ptr()
                    for k, v in state_i.opt_state.items()
                    if isinstance(v, dict) for m, t in v.items()})
        if now != ptrs or state_i.step != every or rng != 1 or \
                data_state != {"epoch": 0, "offset": every}:
            fail(f"ft_bert: restore in place moved "
                 f"{sum(now[k] != ptrs[k] for k in ptrs)} tensors, step "
                 f"{state_i.step}, rng {rng}, data {data_state}")
        data = ResumableIterator(batches).seek(data_state)
        state_i, replayed, _, _ = ft_fit(torch, step_i, state_i, data,
                                         n - every, rng=rng)
        check_bitwise("ft_bert", control,
                      ft_snapshot(control[0][:every].unbind() + tuple(
                          replayed), state_i),
                      ("restored in place and replayed", "uninterrupted"))
        del state_i, step_i
        gc.collect()
        torch.cuda.empty_cache()

        # 5. resumed in a fresh state
        state_r = ft_bert_state(torch, 1)
        with AsyncCheckpointManager(ck) as mgr:
            t1 = time.perf_counter()
            state_r, rng, data, start = resume_run(
                mgr, state_r, ResumableIterator(batches))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t1
            if start != stop or rng != 1 or \
                    data.state() != {"epoch": 0, "offset": stop}:
                fail(f"ft_bert: resume_run gave start {start}, rng {rng}, "
                     f"data {data.state()}")
            reset_counts()
            state_r, tail, _, _ = ft_fit(
                torch, compile_step(step_fn, state_r), state_r, data,
                n - start, mgr=mgr, every=every, rng=rng)
            launches = train_counts()
            saved_after = mgr.all_steps()
        want = {k: TRAIN_FUSED_LAUNCHES.get(k, 0) * (n - start)
                for k in launches}
        if launches != want:
            fail(f"ft_bert: the resumed run launched {launches}, expected "
                 f"{want}")
        check_bitwise("ft_bert", control, ft_snapshot(head + tail, state_r),
                      ("preempted and resumed in a fresh state",
                       "uninterrupted"))

        # 6. the synchronous save of the same state
        with CheckpointManager(os.path.join(root, "sync")) as sync_mgr:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sync_mgr.save(n, state_r)
            sync_s = time.perf_counter() - t1
        print(f"ft_bert ({card}): SIGTERM at step {stop}: emergency save, "
              f"committed {steps_saved}, info {info}; restore in place of "
              f"step {every} {restore_s:.3f} s (read, checksum, copy to the "
              f"card), the captured graph replayed to step {n}; resume_run "
              f"into a fresh state {resume_s:.3f} s, then steps {start + 1}-"
              f"{n} (launches {launches}, committed {saved_after}); the same "
              f"save with async_save=False {sync_s:.3f} s")
        metrics = {
            "payload_bytes": nbytes, "payload_leaves": len(meta["leaves"]),
            "payload_bytes_by_dtype": dtypes,
            "step_ms_no_checkpoint": plain_ms,
            "step_ms_checkpoint_every_4": cadence_ms,
            "async_save_stall_s": stalls, "backpressure_s": waits,
            "background_write_s": writes, "sync_save_s": sync_s,
            "restore_in_place_s": restore_s, "resume_run_s": resume_s,
            "launches_resumed": launches, "steps": n,
            "preempted_at": stop, "card": card,
        }
        del state_r
        gc.collect()
        torch.cuda.empty_cache()
        return metrics
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ft_resnet50_phase(torch, card):
    """configs[2] at 1024 = 8 x 128 at 224², captured, fed by
    prefetch_to_device (per-step seeded native crop and flip) with the
    ResumableIterator outside it: FT_RESNET_STEPS uninterrupted steps
    against a run checkpointed at step FT_RESNET_SAVE_AT and resumed in a
    state initialised from another seed (resume_run drains the saved
    offset through a new prefetcher); the losses, parameters, BatchNorm
    statistics, SGD traces, counts and step equal bit for bit, the
    resumed steps launch exactly 8 cross-entropy kernels each way."""
    import shutil
    import tempfile

    import numpy as np

    from tpudl_torch.config import get_config
    from tpudl_torch.data.augment import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        BatchAugmenter,
        device_normalize,
    )
    from tpudl_torch.data.prefetch import prefetch_to_device
    from tpudl_torch.ft import AsyncCheckpointManager, ResumableIterator
    from tpudl_torch.ft import resume_run
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    cfg = get_config("imagenet_resnet50_dp")
    b, size, accum = cfg.global_batch_size, cfg.image_size, cfg.accum_steps
    n, save_at = FT_RESNET_STEPS, FT_RESNET_SAVE_AT
    rng = np.random.default_rng(cfg.seed + 7)
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, cfg.num_classes, b).astype(np.int32)
    aug_kw = dict(crop=(size, size), pad=RESNET_PAD, mean=IMAGENET_MEAN,
                  std=IMAGENET_STD)
    workers = max(1, min(RESNET_WORKERS, (os.cpu_count() or 1) - 2))
    step_fn = make_classification_train_step(
        cfg.label_smoothing, accum_steps=accum,
        input_transform=device_normalize(IMAGENET_MEAN, IMAGENET_STD),
        loss_impl="auto")
    feeds = []

    def augment(batch):
        seed = int(batch.pop("seed"))
        return BatchAugmenter(backend="native", seed=seed, normalize=False,
                              **aug_kw)(batch)

    def feed(epoch):
        pf = prefetch_to_device(
            ({"image": images, "label": labels, "seed": 100 * epoch + i}
             for i in range(n)), transform=augment, assembly_workers=workers)
        feeds.append(pf)
        return pf

    def fresh(seed, params=None):
        return create_train_state(
            seed, build_model(cfg.model, cfg.num_classes),
            make_optimizer(cfg.optim), params=params)

    root = tempfile.mkdtemp(prefix="tpudl_ft_resnet50_")
    try:
        state = fresh(cfg.seed)
        init = {k: v.detach().clone()
                for k, v in state.model.state_dict().items()}
        state, losses, _, _ = ft_fit(torch, compile_step(step_fn, state),
                                     state, ResumableIterator(feed), n)
        control = ft_snapshot(losses, state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        with AsyncCheckpointManager(root) as mgr:
            state = fresh(cfg.seed, init)
            state, head, _, _ = ft_fit(
                torch, compile_step(step_fn, state), state,
                ResumableIterator(feed), save_at, mgr=mgr, every=save_at)
            meta = mgr.store.read_meta(save_at)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state = fresh(cfg.seed + 1)
        with AsyncCheckpointManager(root) as mgr:
            t1 = time.perf_counter()
            state, r_rng, data, start = resume_run(
                mgr, state, ResumableIterator(feed))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t1
            if start != save_at or r_rng != 1:
                fail(f"ft_resnet50: resume_run gave start {start}, rng "
                     f"{r_rng}")
            reset_counts()
            state, tail, _, _ = ft_fit(
                torch, compile_step(step_fn, state), state, data, n - start,
                rng=r_rng)
            launches = train_counts()
        want = {k: resnet_counts(accum).get(k, 0) * (n - start)
                for k in launches}
        if launches != want:
            fail(f"ft_resnet50: the resumed run launched {launches}, "
                 f"expected {want}")
        check_bitwise("ft_resnet50", control, ft_snapshot(head + tail, state),
                      ("saved at step 3 and resumed in a fresh state",
                       "uninterrupted"))
        nbytes = sum(leaf["nbytes"] for leaf in meta["leaves"])
        stats = len(state.batch_stats)
        print(f"ft_resnet50 ({card}): ResNet-50 at {b} = {accum} x "
              f"{b // accum}, {size}x{size}, prefetch_to_device with "
              f"{workers} workers under a ResumableIterator: payload "
              f"{nbytes} bytes in {len(meta['leaves'])} leaves ({stats} "
              f"running statistics); resume_run (restore, then {start} "
              f"batches drained through a new prefetcher) {resume_s:.3f} s; "
              f"resumed steps {start + 1}-{n} launched {launches}")
        del state
        return {"payload_bytes": nbytes, "payload_leaves": len(meta["leaves"]),
                "resume_run_s": resume_s, "launches_resumed": launches,
                "steps": n, "saved_at": save_at, "card": card}
    finally:
        for pf in feeds:
            pf.close()
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)


class OneProcessRunner:
    """The launcher's contract for one process (the port's launcher is
    ROADMAP queue A item 7): ``run(fn, *args)`` runs ``fn(*args)`` in a
    ``spawn`` child and returns ``[result]``, read from the JSON file that
    is ``fn``'s last argument; a non-zero exit raises RuntimeError."""

    def __init__(self, timeout_s=600.0):
        self.timeout_s = timeout_s
        self.exitcodes = []
        self.seconds = []

    def run(self, fn, *args):
        import multiprocessing

        t0 = time.perf_counter()
        proc = multiprocessing.get_context("spawn").Process(target=fn,
                                                            args=args)
        proc.start()
        try:
            proc.join(self.timeout_s)
        finally:
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.exitcodes.append(proc.exitcode)
        self.seconds.append(time.perf_counter() - t0)
        if proc.exitcode != 0:
            raise RuntimeError(f"worker exited with {proc.exitcode}")
        with open(args[-1]) as f:
            return [json.load(f)]


def ft_kill_child(ckpt_dir, env, out_path):
    """The resume-idempotent payload a supervised child runs: BERT-base
    as ft_bert runs it, resume_run from ``ckpt_dir``, FT_KILL_STEPS steps
    in all with a checkpoint every FT_KILL_EVERY, the environment's chaos
    kill (``env``: TPUDL_CHAOS_*) checked after each step once the
    writer has drained; writes the start step, the losses and the
    payload digest to ``out_path``."""
    os.environ.update(env)
    import torch

    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.ft import AsyncCheckpointManager, ResumableIterator
    from tpudl_torch.ft import chaos, resume_run
    from tpudl_torch.train import compile_step

    t0 = time.perf_counter()
    state = ft_bert_state(torch, 0)
    batches = list(synthetic_token_batches(
        BERT_BATCH, BERT_SEQ, state.model.cfg.vocab_size,
        num_batches=FT_KILL_STEPS, seed=13))
    with AsyncCheckpointManager(ckpt_dir) as mgr:
        state, rng, data, start = resume_run(mgr, state,
                                             ResumableIterator(batches))
        rng = 1 if rng is None else rng
        kill = chaos.step_kill_hook()

        def on_log(i, metrics):
            if kill is not None:
                mgr.wait_until_finished()
                kill(start + i)

        state, losses, _, _ = ft_fit(
            torch, compile_step(ft_bert_step(), state), state, data,
            FT_KILL_STEPS - start, mgr=mgr, every=FT_KILL_EVERY, rng=rng,
            on_log=on_log)
    with open(out_path, "w") as f:
        json.dump({"start": start, "losses": [float(x) for x in losses],
                   "digest": payload_digest(state), "step": state.step,
                   "seconds": time.perf_counter() - t0}, f)


def ft_kill_phase(torch, card):
    """A kill and a restart by the supervisor: tpudl_torch.ft.Supervisor
    over a OneProcessRunner runs ft_kill_child with
    TPUDL_CHAOS_KILL_AT_STEP=FT_KILL_AT and TPUDL_CHAOS_ONCE_DIR set, so
    the child is SIGKILLed once, after its step-4 checkpoint committed;
    the restarted child resumes at step 4 through resume_run. Its final
    payload digest and losses must equal an uninterrupted run's in a
    child of its own, which runs beside the supervised children (all in
    fresh processes). Then
    chaos.truncate_checkpoint corrupts the newest step, and restore_full()
    falls back to the one before it, counting ft_corrupt_checkpoints
    once."""
    import concurrent.futures
    import shutil
    import tempfile
    import warnings

    from tpudl_torch.ft import (
        AsyncCheckpointManager,
        RestartPolicy,
        Supervisor,
        chaos,
    )
    from tpudl_torch.obs import counters as obs_counters

    root = tempfile.mkdtemp(prefix="tpudl_ft_kill_")
    try:
        once = os.path.join(root, "once")
        os.makedirs(once)
        ck = os.path.join(root, "ck")
        runner = OneProcessRunner()
        sup = Supervisor(runner, policy=RestartPolicy(
            max_restarts=2, backoff_s=1.0, backoff_factor=2.0,
            max_backoff_s=4.0))
        env = {chaos.ENV_KILL_AT_STEP: str(FT_KILL_AT),
               chaos.ENV_ONCE_DIR: once}
        control_runner = OneProcessRunner()
        t0 = time.perf_counter()
        # The uninterrupted child runs beside the supervised ones (a
        # process and a CUDA context of its own either way).
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            pending = pool.submit(control_runner.run, ft_kill_child,
                                  os.path.join(root, "control"), {},
                                  os.path.join(root, "control.json"))
            [resumed] = sup.run(ft_kill_child, ck, env,
                                os.path.join(root, "supervised.json"))
            supervised_s = time.perf_counter() - t0
            [control] = pending.result()
        killed_at = (FT_KILL_AT - 1) // FT_KILL_EVERY * FT_KILL_EVERY
        if runner.exitcodes != [-9, 0] or sup.restarts != 1 or \
                resumed["start"] != killed_at or control["start"] != 0:
            fail(f"ft_kill: exit codes {runner.exitcodes}, restarts "
                 f"{sup.restarts}, resumed at {resumed['start']} (expected "
                 f"{killed_at}), control from {control['start']}")
        if resumed["digest"] != control["digest"] or \
                resumed["losses"] != control["losses"][killed_at:] or \
                resumed["step"] != control["step"] != FT_KILL_STEPS:
            fail(f"ft_kill: the supervised run ended at step "
                 f"{resumed['step']} with digest {resumed['digest']} and "
                 f"losses {resumed['losses']}; the uninterrupted run at "
                 f"{control['step']} with {control['digest']} and "
                 f"{control['losses']}")
        counter = obs_counters.registry().counter("ft_corrupt_checkpoints")
        before = counter.value
        corrupted = chaos.truncate_checkpoint(ck)
        state = ft_bert_state(torch, 2)
        with AsyncCheckpointManager(ck) as mgr:
            steps = mgr.all_steps()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state, rng, data = mgr.restore_full(state)
        fallback = state.step
        if corrupted != FT_KILL_STEPS or fallback != steps[-2] or \
                counter.value != before + 1 or counter.value != 1 or \
                not any("corrupt" in str(w.message) for w in caught):
            fail(f"ft_kill: truncated step {corrupted} of {steps}: restored "
                 f"step {fallback}, ft_corrupt_checkpoints {before} -> "
                 f"{counter.value}")
        print(f"ft_kill ({card}): supervised child SIGKILLed at step "
              f"{FT_KILL_AT} (exit codes {runner.exitcodes}), restarted "
              f"after {sup.policy.backoff(1):.1f} s of backoff, resumed at "
              f"step {resumed['start']}: digest {resumed['digest'][:16]} "
              f"equal to the uninterrupted child's, losses "
              f"{resumed['losses']}; children {runner.seconds} s wall "
              f"(supervised run {supervised_s:.1f} s), control "
              f"{control_runner.seconds[0]:.1f} s; truncated step "
              f"{corrupted} -> restore_full() fell back to step {fallback} "
              f"(rng {rng}, data {data}), ft_corrupt_checkpoints "
              f"{counter.value:.0f}")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return {"exit_codes": runner.exitcodes, "restarts": sup.restarts,
                "resumed_at": resumed["start"], "digest": resumed["digest"],
                "supervised_s": supervised_s,
                "child_s": runner.seconds + control_runner.seconds,
                "fallback_step": fallback,
                "ft_corrupt_checkpoints": counter.value, "card": card}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Mixed precision and fp8 training (tpudl_torch.train.precision,
# tpudl_torch.ops.fp8_dot)
# ---------------------------------------------------------------------------

#: H100 SXM dense fp8 peak (NVIDIA data sheet, at the 700 W limit).
FP8_OPS_PER_S = 1979e12
#: fp8_matmul: (what, tokens, in, out) — BERT-base's projections at the
#: train step's 32768 tokens (768 -> 3072 is the composite path's
#: intermediate), Llama-3-8B's at a 4 x 2048 microbatch.
FP8_SHAPES = (
    ("BERT-base q/k/v/out", 32768, 768, 768),
    ("BERT-base output", 32768, 3072, 768),
    ("BERT-base intermediate (composite)", 32768, 768, 3072),
    ("Llama-3-8B q/o", 8192, 4096, 4096),
    ("Llama-3-8B k/v", 8192, 4096, 1024),
    ("Llama-3-8B gate/up", 8192, 4096, 14336),
    ("Llama-3-8B down", 8192, 14336, 4096),
)
#: train_precision: the cells (policy, fp8_train, bf16 moments), all from
#: one seed over one batch stream; the control computes in f32.
PRECISION_CELLS = (("f32", None, False), ("bf16", "bf16", False),
                   ("bf16_m8", "bf16", True), ("fp8", "fp8", True))
#: Each cell's final loss against the f32 control's
#: (benchmarks/train_precision.py:74, tpudl's PARITY_BANDS).
PRECISION_BANDS = {"bf16": 0.03, "bf16_m8": 0.03, "fp8": 0.08}
PRECISION_STEPS = 20
PRECISION_SAVE_AT = 10
#: fp8 sites a BERT-base fused step launches each way (5 a layer:
#: q/k/v/out/output; the fused intermediate stays a plain product).
BERT_FP8_SITES = 5 * 12
#: llama_fp8_lora_train: llama_lora_train's 4 x 2048 microbatch, 4 of
#: its 16 microbatches a step (cut to stay in time).
LLAMA_FP8_ACCUM = 4
LLAMA_FP8_STEPS = 2
#: llama_fp8_lora_train: the seeds of the weights whose first and second
#: fp8 losses are read beside the bf16 loss of the same weights on the
#: same rows (seed 0 is the phase's own run, and the one held to the
#: band; see the phase's docstring). Seeds 1-2 (read at PR 15, PERF.md)
#: were cut to keep the script within its time limit.
LLAMA_FP8_SEEDS = (0,)
#: llama_fp8_lora_train's site check: each Fp8Dense output against the
#: plain product of the same casts, as a share of the output's largest
#: magnitude (fp8_matmul's tolerance: the bf16 output's rounding, and
#: the f32 accumulation's order).
FP8_SITE_TOL = 2.0 ** -7
#: The bf16 reference of the fp8 model (its sites as bf16 products)
#: against llama_lora_train's bf16 LoRA model at seed 0: the same
#: weights and products, so only the classifier's bf16 rounding
#: (a step casts it, the eval step does not) may separate them.
LLAMA_FP8_REF_TOL = 1e-3
#: llama1b_full_train: 2 microbatches of 4 x 2048.
LLAMA1B_ACCUM = 2
LLAMA1B_STEPS = 2
#: llama1b_full_train: the step's loss on the initial weights against
#: the eval step's (batches 0 and 1: the warm-up's first step moves
#: nothing). The step casts the f32 classifier to bf16 under the policy,
#: the eval step does not: a 2^-9 relative rounding of each weight.
LLAMA1B_EVAL_TOL = 2e-3
#: llama1b_cut_parity: Llama-3.2-1B at full width cut to 2 layers,
#: batches of LLAMA_BATCH x LLAMA_SEQ: LLAMA1B_CUT_STEPS steps with the
#: phase's optimizer (warm-up from 0), then LLAMA1B_CONSTANT_STEPS from
#: the same weights at its constant 1e-4.
LLAMA1B_CUT_LAYERS = 2
LLAMA1B_CUT_STEPS = 4
LLAMA1B_CONSTANT_STEPS = 2


def fp8_counts():
    from tpudl_torch.ops.fp8_dot import fp8_dot

    return {k: getattr(fp8_dot, f"launches_{k}") for k in ("fwd", "dx", "dw")}


def reset_fp8_counts():
    from tpudl_torch.ops.fp8_dot import fp8_dot

    for k in ("fwd", "dx", "dw"):
        setattr(fp8_dot, f"launches_{k}", 0)


def precision_leaves(state):
    """The precision state's tensors by checkpoint key (clones)."""
    from tpudl_torch.ft.manager import flatten_with_keys

    if state.precision is None:
        return {}
    return {k: v.detach().clone()
            for k, v in flatten_with_keys(state.precision)}


def same_leaves(a, b):
    return a.keys() == b.keys() and all(torch_equal(a[k], b[k]) for k in a)


def fp8_matmul_phase(torch, card):
    """fp8_dot's products (``torch._scaled_mm``: e4m3 x e4m3 forward,
    e5m2 x e4m3 dx and dw) at BERT-base's and Llama-3-8B's projection
    shapes: forward, dx and dw against the plain version (the same fp8
    values dequantized to f32, an f32 product) within 2^-7 of the output's
    largest magnitude (both sum in f32 and round once; bf16's step), then
    each product's time (CUDA-graph replay) beside bf16 ``torch.matmul``
    at the same shape, the bound at the fp8 peak, the plain version's
    time, and per site the quantization (cast and amax of x, w and g) and
    the transposed copies dx and dw need."""
    from tpudl_torch.ops.fp8_dot import (
        E4M3_MAX,
        E5M2_MAX,
        _cast_fp8,
        _product,
        amax,
        amax_history_init,
        fp8_dot,
        update_amax_history,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for what, t, k, n in FP8_SHAPES:
        x = torch.randn(t, k, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(n, k, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        g = (torch.randn(t, n, device=dev, generator=gen) * 1e-3).to(
            torch.bfloat16)

        def ring(a):
            return update_amax_history(amax_history_init(16, dev),
                                       torch.tensor(a, device=dev))

        hx, hw, hg = ring(float(amax(x))), ring(float(amax(w))), \
            ring(float(amax(g)) * 1.5)
        outs = {}
        for impl in ("auto", "reference"):
            xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
            g_amax = torch.zeros((), device=dev)
            out = fp8_dot(xi, wi, hx, hw, hg, g_amax, impl=impl)
            out.backward(g)
            outs[impl] = (out.detach(), xi.grad, wi.grad)
        errs = {}
        for name, got, want in zip(("fwd", "dx", "dw"), outs["auto"],
                                   outs["reference"]):
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            if not err <= 2.0**-7 * scale:
                fail(f"fp8_matmul {what} {name}: max abs err {err:.4e} vs "
                     f"2^-7 x {scale:.4e}")
            errs[name] = err
        del outs
        sx = torch.tensor(float(amax(x)) / E4M3_MAX, device=dev)
        sw = torch.tensor(float(amax(w)) / E4M3_MAX, device=dev)
        sg = torch.tensor(float(amax(g)) * 1.5 / E5M2_MAX, device=dev)
        qx = _cast_fp8(x, sx, torch.float8_e4m3fn, E4M3_MAX)
        qw = _cast_fp8(w, sw, torch.float8_e4m3fn, E4M3_MAX)
        qg = _cast_fp8(g, sg, torch.float8_e5m2, E5M2_MAX)
        qw_col = qw.t().contiguous().t()        # [N, K] column-major (dx)
        qg_t = qg.t().contiguous()              # [N, T] row-major (dw)
        qx_col = qx.t().contiguous().t()        # [T, K] column-major (dw)
        mm = torch._scaled_mm
        f32 = torch.float32
        kw = dict(calls=10, reps=5)
        row = {
            "what": what, "tokens": t, "in": k, "out": n,
            "fwd_ms": graph_ms(lambda: mm(qx, qw.t(), scale_a=sx, scale_b=sw,
                                          out_dtype=torch.bfloat16), **kw),
            "dx_ms": graph_ms(lambda: mm(qg, qw_col, scale_a=sg, scale_b=sw,
                                         out_dtype=torch.bfloat16), **kw),
            "dw_ms": graph_ms(lambda: mm(qg_t, qx_col, scale_a=sg,
                                         scale_b=sx, out_dtype=f32), **kw),
            "bf16_fwd_ms": graph_ms(lambda: x @ w.t(), **kw),
            "bf16_dx_ms": graph_ms(lambda: g @ w, **kw),
            "bf16_dw_ms": graph_ms(lambda: g.t() @ x, **kw),
            "plain_fwd_ms": graph_ms(lambda: _product(
                qx, qw.t(), sx, sw, torch.bfloat16, False, "fwd"),
                calls=2, reps=3),
            "quantize_ms": graph_ms(lambda: (
                amax(x), _cast_fp8(x, sx, torch.float8_e4m3fn, E4M3_MAX),
                amax(w), _cast_fp8(w, sw, torch.float8_e4m3fn, E4M3_MAX),
                amax(g), _cast_fp8(g, sg, torch.float8_e5m2, E5M2_MAX)), **kw),
            "transposes_ms": graph_ms(lambda: (
                qw.t().contiguous(), qg.t().contiguous(),
                qx.t().contiguous()), **kw),
            "max_abs_err": errs,
        }
        ops = 2.0 * t * k * n
        for name, (a_elems, b_elems, out_bytes) in {
                "fwd": (t * k, n * k, 2 * t * n),
                "dx": (t * n, n * k, 2 * t * k),
                "dw": (t * n, t * k, 4 * n * k)}.items():
            nbytes = a_elems + b_elems + out_bytes
            row[f"{name}_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                          ops / FP8_OPS_PER_S) * 1e3
        row["bound_by"] = ("operations" if ops / FP8_OPS_PER_S
                           > (t * k + n * k + 2 * t * n) / HBM_BYTES_PER_S
                           else "bytes")
        # Per site a step: casts and amaxes of x, w, g (bytes: each read
        # once, the fp8 copies written once).
        q_bytes = 2 * (t * k + n * k + t * n) * 2 + (t * k + n * k + t * n)
        row["quantize_bound_ms"] = q_bytes / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        print(f"fp8_matmul {what} [{t}, {k}] -> {n} ({card}): _scaled_mm "
              f"fwd {row['fwd_ms'] * 1e3:.2f} us, dx {row['dx_ms'] * 1e3:.2f},"
              f" dw {row['dw_ms'] * 1e3:.2f} (bounds at the fp8 peak "
              f"{row['fwd_bound_ms'] * 1e3:.2f} / {row['dx_bound_ms'] * 1e3:.2f}"
              f" / {row['dw_bound_ms'] * 1e3:.2f}, {row['bound_by']}); bf16 "
              f"torch.matmul {row['bf16_fwd_ms'] * 1e3:.2f} / "
              f"{row['bf16_dx_ms'] * 1e3:.2f} / {row['bf16_dw_ms'] * 1e3:.2f};"
              f" plain forward {row['plain_fwd_ms'] * 1e3:.2f}; quantize "
              f"(cast + amax of x, w, g) {row['quantize_ms'] * 1e3:.2f} "
              f"(bound {row['quantize_bound_ms'] * 1e3:.2f}), transposed "
              f"copies {row['transposes_ms'] * 1e3:.2f}; max abs err vs plain "
              f"{errs['fwd']:.3e} / {errs['dx']:.3e} / {errs['dw']:.3e}")
        del x, w, g, qx, qw, qg, qw_col, qg_t, qx_col
        torch.cuda.empty_cache()
    return rows


def bert_precision_state(torch, pol, fp8_train, bf16_moments):
    """BERT-base as train_fused builds it (fused_ops=True,
    attention_impl="fused", dropout 0.1), configured by the policy (f32
    without one), seed 0."""
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import create_train_state, policy

    precision = None if pol is None else policy(pol, bf16_moments=bf16_moments)
    dtype = torch.float32 if precision is None else precision.compute_dtype
    model = build_model("bert-base", 2, dtype=dtype, fused_ops=True,
                        attention_impl="fused", fp8_train=fp8_train)
    return create_train_state(0, model, sst2_optimizer(),
                              precision=precision), precision


def run_precision_cell(torch, card, name, pol, fp8_train, bf16_moments,
                       batches, capture):
    """One cell one way: PRECISION_STEPS steps (the first three outside
    the timed window; a captured run's second call is its capture), the
    launches of the timed steps, peak memory; returns (state, step,
    metrics, snapshot)."""
    from tpudl_torch.train import compile_step, make_classification_train_step
    from tpudl_torch.train.metrics import Throughput, transformer_train_flops

    state, precision = bert_precision_state(torch, pol, fp8_train,
                                            bf16_moments)
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), loss_impl="auto",
        precision=precision)
    run = compile_step(step, state, precision=precision) if capture else step
    n_params = sum(p.numel() for p in state.model.parameters())
    w = TRAIN_WARMUP_STEPS
    meter = Throughput(BERT_BATCH, warmup=w)
    losses, metrics = [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches[:PRECISION_STEPS]):
        if i == w:
            torch.cuda.synchronize()
            reset_counts()
            reset_fp8_counts()
        state, metrics = run(state, batch, 1)
        losses.append(metrics["loss"])
        meter.step(metrics["loss"])
        if i == 0 and fp8_train:
            bad = [k for k, v in precision_leaves(state).items()
                   if k.endswith("_hist']") and not float(v[0]) > 0]
            if bad:
                fail(f"train_precision {name}: rings not positive after "
                     f"step 1: {bad[:5]}")
    timed = meter.result(losses[-1])
    launches, fp8 = train_counts(), fp8_counts()
    n = PRECISION_STEPS - w
    want = {k: TRAIN_FUSED_LAUNCHES.get(k, 0) * n for k in launches}
    want_fp8 = {k: BERT_FP8_SITES * n if fp8_train else 0 for k in fp8}
    way = "captured" if capture else "eager"
    if launches != want or fp8 != want_fp8:
        fail(f"train_precision {name} ({way}): launches {launches} / fp8 "
             f"{fp8}, expected {want} / {want_fp8}")
    loss_t = torch.stack(losses)
    if not bool(torch.isfinite(loss_t).all()):
        fail(f"train_precision {name}: non-finite loss in {loss_t.tolist()}")
    step_s = timed["step_ms"] / 1e3
    flops = transformer_train_flops(n_params, BERT_BATCH * BERT_SEQ)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"step_ms": step_s * 1e3, "samples_per_s": BERT_BATCH / step_s,
           "mfu": flops / step_s / BF16_OPS_PER_S, "peak_memory_gib": peak,
           "final_loss": float(loss_t[-1]), "launches": launches,
           "fp8_launches": fp8, "capture_s": getattr(run, "capture_s", None)}
    if fp8_train:
        out["mfu_fp8_peak"] = flops / step_s / FP8_OPS_PER_S
        out["loss_scale"] = float(metrics["loss_scale"])
        out["skipped"] = int(state.precision["loss_scale"]["skipped"])
    print(f"train_precision {name} ({way}, {card}): step "
          f"{out['step_ms']:.2f} ms, {out['samples_per_s']:.1f} samples/s, "
          f"MFU {100 * out['mfu']:.2f}% of the bf16 peak"
          + (f" ({100 * out['mfu_fp8_peak']:.2f}% of the fp8 peak)"
             if fp8_train else "")
          + f", peak memory {peak:.2f} GiB, losses {loss_t[0].item():.4f} -> "
          f"{loss_t[-1].item():.4f}, launches {launches}, fp8 products {fp8}")
    snapshot = (loss_t.clone(),
                {k: v.detach().clone()
                 for k, v in state.model.state_dict().items()},
                {k: {m: t.clone() for m, t in v.items()}
                 for k, v in state.opt_state.items() if isinstance(v, dict)},
                state.step)
    return state, run, out, snapshot


def train_precision_phase(torch, card):
    """BERT-base SST-2 (configs[1], 256 x 128, fused_ops=True, dropout
    0.1) under four cells from one seed and one batch stream:
    PRECISION_STEPS steps eager, then captured, held bit for bit (losses,
    parameters, optimizer state, and the precision state). Each cell's
    final loss within its band of the f32 control's. The fp8 cell: rings
    positive after step 1, no skip and the scale at 2^15 after 20 steps;
    a sync save after step 20, 10 more steps, a restore in place and the
    same 10 steps again equal the first pass bit for bit (losses,
    parameters, optimizer state, rings, loss-scale state); a step
    repeated with the position table poisoned is skipped (everything but
    the loss scale bitwise as before) and, the table put back, the retried
    step's loss is the clean step's bit for bit; and the cost of the
    ``ok`` read back
    after each captured step (the graph replayed without it)."""
    import tempfile

    from tpudl_torch.checkpoint import CheckpointManager
    from tpudl_torch.data.synthetic import synthetic_token_batches

    batches = list(synthetic_token_batches(BERT_BATCH, BERT_SEQ, 30522,
                                           num_batches=PRECISION_STEPS + 1))
    cells = {}
    for name, pol, bf16_moments in PRECISION_CELLS:
        fp8_train = pol == "fp8"
        runs = {}
        for capture in (False, True):
            state, run, metrics, snap = run_precision_cell(
                torch, card, name, pol, fp8_train, bf16_moments, batches,
                capture)
            runs[capture] = (metrics, snap, precision_leaves(state))
            if not capture:
                del state, run
                gc.collect()
                torch.cuda.empty_cache()
        check_bitwise(f"train_precision {name}", runs[False][1], runs[True][1])
        if not same_leaves(runs[False][2], runs[True][2]):
            fail(f"train_precision {name}: the captured precision state is "
                 f"not the eager one's")
        metrics = runs[True][0]
        metrics["eager"] = runs[False][0]
        if fp8_train:
            if metrics["skipped"] or metrics["loss_scale"] != 2.0**15:
                fail(f"train_precision fp8: skipped {metrics['skipped']}, "
                     f"scale {metrics['loss_scale']}")
            metrics.update(fp8_resume_and_skip(torch, state, run, batches))
        cells[name] = metrics
        del state, run
        gc.collect()
        torch.cuda.empty_cache()
    control = cells["f32"]["final_loss"]
    for name, band in PRECISION_BANDS.items():
        diff = abs(cells[name]["final_loss"] - control)
        cells[name]["loss_gap_to_f32"] = diff
        if not diff <= band:
            fail(f"train_precision {name}: final loss "
                 f"{cells[name]['final_loss']:.5f} is {diff:.5f} from the f32 "
                 f"control's {control:.5f} (band {band})")
        print(f"train_precision {name}: final loss {cells[name]['final_loss']:.5f}"
              f", {diff:.5f} from f32's {control:.5f} (band {band})")
    return cells


def state_tensors(state):
    """Every tensor of a train state by name (parameters, BatchNorm
    statistics, optimizer tensors, precision leaves): the live tensors,
    which a caller clones to keep a snapshot."""
    from tpudl_torch.ft.manager import flatten_with_keys

    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = {k: v for k, v in state.opt_state.items()
           if k not in ("scalars", "host_count")}
    out.update({f"opt{k}": v for k, v in flatten_with_keys(opt)})
    out.update({f"precision{k}": v for k, v in
                flatten_with_keys(state.precision or {})})
    return out


def snapshot(state):
    """Clones of ``state_tensors`` and the host counts."""
    return ({k: v.detach().clone() for k, v in state_tensors(state).items()},
            (state.step, state.opt_state["host_count"]))


def fp8_resume_and_skip(torch, state, run, batches):
    """The fp8 cell's captured state after its PRECISION_STEPS steps (see
    train_precision_phase): the resume and skip checks, and the readback
    cost. Returns their numbers."""
    import tempfile

    from tpudl_torch.checkpoint import CheckpointManager

    out = {}
    extra = batches[:PRECISION_SAVE_AT]
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, async_save=False)
        t0 = time.perf_counter()
        mgr.save(state.step, state)
        out["save_s"] = time.perf_counter() - t0
        saved_step = state.step
        passes = []
        for again in (False, True):
            if again:
                t0 = time.perf_counter()
                mgr.restore(state, saved_step)
                out["restore_s"] = time.perf_counter() - t0
            losses = []
            for batch in extra:
                state, m = run(state, batch, 2)
                losses.append(m["loss"])
            passes.append((torch.stack(losses), snapshot(state)))
        mgr.close()
    (l0, (t0_, c0)), (l1, (t1_, c1)) = passes
    bad = [k for k in t0_ if not torch_equal(t0_[k], t1_[k])]
    if not torch_equal(l0, l1) or bad or c0 != c1:
        fail(f"train_precision fp8: the restored pass differs from the first "
             f"(losses {l1.tolist()} vs {l0.tolist()}, {bad[:5]}, counts "
             f"{c1} vs {c0})")
    print(f"train_precision fp8: a sync save after step {saved_step} "
          f"({out['save_s']:.3f} s), {len(extra)} more steps, a restore in "
          f"place ({out['restore_s']:.3f} s) and the same steps again: "
          f"losses, {len(t0_)} tensors (rings and loss-scale state among "
          f"them) and counts equal bit for bit")
    # The skip: a clean step from a snapshot, then the same step from the
    # same snapshot with the position table poisoned, then the retry.
    params = dict(state.model.named_parameters())
    pos = params["bert.embeddings.position_embeddings.weight"]
    before, counts = snapshot(state)
    live = state_tensors(state)
    batch = batches[PRECISION_STEPS]
    state, clean = run(state, batch, 3)
    clean_loss = clean["loss"].clone()
    with torch.no_grad():
        for k, v in before.items():
            live[k].copy_(v)
    state.step, state.opt_state["host_count"] = counts
    old = pos.detach().clone()
    with torch.no_grad():
        pos[0, 0] = float("inf")
    state, m = run(state, batch, 3)
    if float(m["grad_skipped"]) != 1.0:
        fail("train_precision fp8: the poisoned step was not skipped")
    with torch.no_grad():
        pos.copy_(old)
    after, counts_after = snapshot(state)
    moved = [k for k in before if "loss_scale" not in k
             and not torch_equal(before[k], after[k])]
    if moved or counts_after != counts:
        fail(f"train_precision fp8: the skipped step moved {moved[:5]} "
             f"(counts {counts} -> {counts_after})")
    ls = state.precision["loss_scale"]
    if float(ls["scale"]) != 2.0**14 or int(ls["skipped"]) != 1:
        fail(f"train_precision fp8: after the skip the scale is "
             f"{float(ls['scale'])}, skipped {int(ls['skipped'])}")
    state, retry = run(state, batch, 3)
    if not torch_equal(retry["loss"], clean_loss):
        fail(f"train_precision fp8: the retried step's loss "
             f"{float(retry['loss'])} is not the clean step's "
             f"{float(clean_loss)}")
    print(f"train_precision fp8: a poisoned step skipped ({len(before)} "
          f"tensors but the loss scale, and the counts, bit for bit; scale "
          f"2^15 -> 2^14, skipped 1); the retried step drew the clean step's "
          f"masks (its loss bit for bit)")
    # The readback: K captured steps as fit calls them (ok read back after
    # each) against K replays of the same graph alone.
    k = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        state, m = run(state, batch, 3)
    torch.cuda.synchronize()
    with_read = (time.perf_counter() - t0) / k * 1e3
    t0 = time.perf_counter()
    for _ in range(k):
        run.graph.replay()
    torch.cuda.synchronize()
    replay_only = (time.perf_counter() - t0) / k * 1e3
    out.update({"step_ms_with_ok_readback": with_read,
                "step_ms_replay_only": replay_only,
                "ok_readback_ms": with_read - replay_only})
    print(f"train_precision fp8: captured step {with_read:.2f} ms called as "
          f"fit calls it (ok read back), {replay_only:.2f} ms as bare replays "
          f"of its graph: the readback and the host's bookkeeping cost "
          f"{with_read - replay_only:.2f} ms a step")

    def profiled():
        for _ in range(PROFILE_STEPS):
            run(state, batch, 3)

    out["device_busy_share"] = profile_steps(
        torch, profiled, PROFILE_STEPS, "train_precision fp8 (captured)",
        with_read * 1e3 * PROFILE_STEPS)
    return out


def bits_digest(torch, tensors):
    """name -> (sum, sum of squares) of each tensor's 16- or 32-bit words
    as int64, on the card: a change of any bit moves them (used where a
    host copy of the 8B base would cost more than the check)."""
    out = {}
    for name, t in tensors.items():
        words = t.detach().contiguous().view(
            {2: torch.int16, 4: torch.int32}[t.element_size()]).long()
        out[name] = (int(words.sum()), int((words * words).sum()))
    return out


def restart(torch, state, init=None):
    """A Llama phase's state back to step 0: the trainable weights from
    ``init`` (None: as they are), a fresh optimizer state with the same
    first-moment dtypes, empty rings and the initial loss scale."""
    from tpudl_torch.ops.fp8_dot import reset_fp8_state

    if init is not None:
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(init[k])
    mu_dtypes = {k: v.dtype for k, v in state.opt_state.get("mu", {}).items()}
    state.opt_state = state.tx.init(state.params, mu_dtypes=mu_dtypes)
    state.step = 0
    reset_fp8_state(state.model)
    if state.precision and "loss_scale" in state.precision:
        ls = state.precision["loss_scale"]
        ls["scale"].fill_(2.0**15)
        ls["growth_count"].zero_()
        ls["skipped"].zero_()


@contextlib.contextmanager
def fp8_sites_as_plain(model):
    """Every Fp8Dense of ``model`` computes its product in its compute
    dtype (``x @ W^T``, then the adapters and the bias as Fp8Dense adds
    them): the bf16 model of the same weights, the reference its fp8
    losses are held to."""
    import torch.nn.functional as F

    from tpudl_torch.ops.fp8_dot import fp8_sites

    def plain(site):
        def forward(x):
            x = x.to(site.dtype)
            out = F.linear(x, site.weight.to(site.dtype))
            if site.rank > 0:
                delta = (x @ site.lora_a.to(site.dtype)) @ site.lora_b.to(
                    site.dtype)
                out = out + delta * (site.alpha / site.rank)
            if site.bias is not None:
                out = out + site.bias.to(site.dtype)
            return out
        return forward

    sites = [site for _, site in fp8_sites(model)]
    for site in sites:
        site.forward = plain(site)
    try:
        yield
    finally:
        for site in sites:
            del site.forward


def microbatch_eval_loss(torch, evaluate, state, batch, accum):
    """The eval step's loss over ``accum`` microbatches of LLAMA_BATCH rows
    of ``batch``, as the accumulated train step reports it (the mean of
    the microbatches' means)."""
    return float(torch.stack([
        evaluate(state, {k: v[a * LLAMA_BATCH:(a + 1) * LLAMA_BATCH]
                         for k, v in batch.items()})["loss"]
        for a in range(accum)]).mean())


def llama_train_run(torch, card, name, state, step, batches, tokens, flops,
                    want_launches, want_fp8, warmup, steps, init):
    """The Llama phases' runs: eager, then captured (the state put back to
    ``init`` between), ``warmup`` + ``steps`` + 1 steps each: the captured
    run's warm-up is one longer (its second call is the capture), the
    eager run's extra step comes after its timed ones. Counts are reset
    before the timed steps. Returns the captured run's metrics (the eager
    run's under "eager") after check_bitwise."""
    from tpudl_torch.train import compile_step
    from tpudl_torch.train.metrics import Throughput

    runs = {}
    for capture in (False, True):
        way = "captured" if capture else "eager"
        if capture:
            restart(torch, state, init)
        policy = getattr(step, "precision", None)
        run = compile_step(step, state, precision=policy) if capture else step
        w = warmup + int(capture)
        meter = Throughput(tokens, warmup=w)
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches[:w + steps]):
            if i == w:
                torch.cuda.synchronize()
                reset_counts()
                reset_fp8_counts()
            state, metrics = run(state, batch, 1)
            losses.append(metrics["loss"])
            meter.step(metrics["loss"])
        timed = meter.result(losses[-1])
        launches, fp8 = train_counts(), fp8_counts()
        if not capture:
            state, metrics = run(state, batches[w + steps], 1)
            losses.append(metrics["loss"])
        want = {k: want_launches.get(k, 0) * steps for k in launches}
        want8 = {k: want_fp8.get(k, 0) * steps for k in fp8}
        print(f"{name} ({way}): {steps} steps, launches {launches}, fp8 "
              f"products {fp8}")
        if launches != want or fp8 != want8:
            fail(f"{name} ({way}): launches {launches} / {fp8}, expected "
                 f"{want} / {want8}")
        loss_t = torch.stack(losses)
        if not bool(torch.isfinite(loss_t).all()):
            fail(f"{name}: non-finite loss in {loss_t.tolist()}")
        step_s = timed["step_ms"] / 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        metrics = {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                   "mfu": flops / step_s / BF16_OPS_PER_S,
                   "mfu_fp8_peak": flops / step_s / FP8_OPS_PER_S,
                   "model_flops_per_step": flops, "peak_memory_gib": peak,
                   "losses": loss_t.tolist(),
                   "capture_s": getattr(run, "capture_s", None)}
        print(f"{name} metrics, {way} ({card}): step {step_s * 1e3:.2f} ms, "
              f"{tokens / step_s:.1f} tokens/s, MFU {100 * metrics['mfu']:.2f}%"
              f" of the bf16 peak ({100 * metrics['mfu_fp8_peak']:.2f}% of the "
              f"fp8 peak; {flops:.4e} model FLOP a step), peak memory "
              f"{peak:.2f} GiB, losses "
              f"{', '.join(f'{x:.4f}' for x in loss_t.tolist())}")
        # The eager run's tensors are copied (the captured run restarts
        # from them); the captured run's are the live state, compared as
        # they stand (a copy of a 1.9 B-parameter state did not fit beside
        # its graph's pool).
        keep = (lambda t: t.detach()) if capture else (
            lambda t: t.detach().clone())
        runs[capture] = (metrics, (
            loss_t.clone(), {k: keep(p) for k, p in state.params.items()},
            {k: {n: keep(t) for n, t in v.items()}
             for k, v in state.opt_state.items() if isinstance(v, dict)},
            state.step), precision_leaves(state))
    check_bitwise(name, runs[False][1], runs[True][1])
    if not same_leaves(runs[False][2], runs[True][2]):
        fail(f"{name}: the captured precision state is not the eager one's")
    metrics = runs[True][0]
    metrics["eager"] = runs[False][0]
    return metrics


def fp8_site_check(torch, model, ids, mask):
    """One eval forward of ``model`` (its rings as they stand) with every
    Fp8Dense's output held to a plain version computed here from its
    inputs and rings alone: each scale the ring's max over E4M3_MAX (1.0
    for an all-zero ring), x and w divided by it in f32, clipped to the
    format's max and cast to e4m3, the f32 product of the casts times
    both scales, then the adapters and bias as Fp8Dense adds them, in
    the compute dtype. Returns site name -> the largest absolute
    difference over the reference's largest magnitude."""
    import torch.nn.functional as F

    from tpudl_torch.ops.fp8_dot import fp8_sites

    fmax = 448.0
    errs = {}

    def scale(hist):
        top = hist.max()
        return torch.where(top > 0, top / fmax, torch.ones_like(top))

    def cast(t, sc):
        return (t.float() / sc).clamp(-fmax, fmax).to(
            torch.float8_e4m3fn).float()

    def hook(name):
        def check(site, inputs, out):
            x = inputs[0].to(site.dtype)
            sx, sw = scale(site.x_hist), scale(site.w_hist)
            ref = (F.linear(cast(x, sx), cast(site.weight.to(site.dtype), sw))
                   * (sx * sw)).to(site.dtype)
            if site.rank > 0:
                delta = (x @ site.lora_a.to(site.dtype)) @ site.lora_b.to(
                    site.dtype)
                ref = ref + delta * (site.alpha / site.rank)
            if site.bias is not None:
                ref = ref + site.bias.to(site.dtype)
            ref = ref.float()
            errs[name] = float((out.float() - ref).abs().max()
                               / ref.abs().max())
        return check

    handles = [site.register_forward_hook(hook(name))
               for name, site in fp8_sites(model)]
    try:
        with torch.no_grad():
            model(ids, mask)
    finally:
        for h in handles:
            h.remove()
    return errs


def fp8_drift(torch, model, ids, mask, layers):
    """Readings, one microbatch: the relative L2 distance of the output of
    each block in ``layers`` (0-based) of the fp8 forward (rings as they
    stand) from the same block's output with the sites as bf16 products
    (fp8_sites_as_plain) and with the sites' plain fp8 version
    (impl="reference": the same casts, the products in f32)."""
    from tpudl_torch.ops.fp8_dot import fp8_sites

    sites = [site for _, site in fp8_sites(model)]
    runs = {}
    for way in ("fp8", "bf16", "fp8 plain"):
        held = {}
        handles = [getattr(model.model, f"layer_{i}").register_forward_hook(
            lambda mod, inp, out, i=i: held.__setitem__(i, out[0].float()))
            for i in layers]
        for site in sites:
            site.impl = "reference" if way == "fp8 plain" else "auto"
        try:
            with torch.no_grad(), (fp8_sites_as_plain(model) if way == "bf16"
                                   else contextlib.nullcontext()):
                model(ids, mask)
        finally:
            for h in handles:
                h.remove()
            for site in sites:
                site.impl = "auto"
        runs[way] = held
    return {way: [float((runs["fp8"][i] - runs[way][i]).norm()
                        / runs[way][i].norm()) for i in layers]
            for way in ("bf16", "fp8 plain")}


def llama_fp8_lora_train_phase(torch, card, bf16_loss):
    """configs[4] at full width and depth (Llama-3-8B, rank 16 on the 7
    projections, seq 2048, flash) with fp8_train=True under
    policy("fp8"): llama_lora_train's weights (seed 0), its first batch's
    first LLAMA_FP8_ACCUM microbatches of 4 x 2048 a step (cut from 16).
    After the runs, every one of the 224 fp8 sites is held to a plain
    version of its product on the same inputs and rings
    (fp8_site_check, FP8_SITE_TOL). The frozen base bit for bit
    unchanged (a digest of its words on the card); every ring advanced;
    eager then captured, bit for bit, with the repo's kernels' and the
    fp8 products' launch counts.

    The warm-up's first step moves nothing (lr(0) = 0), so the first two
    steps run on the initial weights: the first with empty rings (every
    site at scale 1), the second with the rings it filled. At seed 0
    both losses are held within the fp8 band (0.08) of the bf16 loss of
    the same weights on the same rows (``bf16_loss``, from
    llama_lora_train). At the other LLAMA_FP8_SEEDS the same gaps are
    read, not held: the bf16 loss comes from the fp8 model with its
    sites as bf16 products (fp8_sites_as_plain, held at seed 0 to
    ``bf16_loss`` within LLAMA_FP8_REF_TOL). The band is not a property
    of these random weights: e4m3's three mantissa bits move each
    block's output by about a tenth and 32 blocks compound it, so the
    loss of 16 rows lands on either side of it by seed (PERF.md)."""
    from tpudl_torch.config import get_config
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.lora import lora_optimizer
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        create_train_state,
        make_classification_eval_step,
        make_classification_train_step,
        policy,
    )

    cfg = get_config("llama3_8b_lora")
    pol = policy("fp8")
    band = PRECISION_BANDS["fp8"]
    t0 = time.perf_counter()
    model = build_model(cfg.model, cfg.num_classes, fused_ops=True,
                        attention_impl="flash", fp8_train=True)
    tx = lora_optimizer(llama_optimizer(), model, ("classifier",))
    state = create_train_state(0, model, tx, precision=pol)
    mcfg = model.cfg
    named = dict(model.named_parameters())
    n_proj = sum(p.numel() for n, p in named.items()
                 if n.endswith("_proj.weight"))
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    digest = bits_digest(torch, frozen)
    rows = LLAMA_BATCH * LLAMA_FP8_ACCUM
    first = next(iter(synthetic_token_batches(
        LLAMA_BATCH * LLAMA_ACCUM, LLAMA_SEQ, mcfg.vocab_size,
        num_batches=1)))
    batch = {k: v[:rows] for k, v in first.items()}
    torch.cuda.synchronize()
    print(f"llama_fp8_lora_train: Llama-3-8B LoRA rank {mcfg.lora_rank} with "
          f"fp8_train=True (7 Fp8Dense sites a layer, base frozen in bf16) "
          f"under policy('fp8'): {rows} rows = {LLAMA_FP8_ACCUM} microbatches "
          f"x {LLAMA_BATCH} x seq {LLAMA_SEQ} a step (llama_lora_train's "
          f"first {rows} rows); set-up {time.perf_counter() - t0:.1f} s")
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), accum_steps=LLAMA_FP8_ACCUM,
        precision=pol)
    tokens = rows * LLAMA_SEQ
    attn = 7.0 * rows * mcfg.hidden_size * LLAMA_SEQ ** 2 * mcfg.num_layers
    flops = 4.0 * n_proj * tokens + attn
    sites = 7 * mcfg.num_layers
    # Backward: no dx at the first layer's q/k/v (their input is the
    # frozen embedding's normed output), no dw anywhere (frozen base).
    want_fp8 = {"fwd": sites * LLAMA_FP8_ACCUM,
                "dx": (sites - 3) * LLAMA_FP8_ACCUM, "dw": 0}
    init = {k: p.detach().clone() for k, p in state.params.items()}
    metrics = llama_train_run(
        torch, card, "llama_fp8_lora_train", state, step,
        [batch] * (LLAMA_FP8_STEPS + 3), tokens, flops,
        llama_launches_per_step(mcfg.num_layers, LLAMA_FP8_ACCUM), want_fp8,
        1, LLAMA_FP8_STEPS, init)
    changed = [k for k, v in bits_digest(torch, frozen).items()
               if v != digest[k]]
    if changed or not frozen:
        fail(f"llama_fp8_lora_train: frozen base changed: {changed[:5]}")
    rings = precision_leaves(state)
    flat = [v for k, v in rings.items() if k.endswith("_hist']")]
    if len(flat) != 3 * sites or not all(float(v[0]) > 0 for v in flat):
        fail("llama_fp8_lora_train: a ring did not advance")
    print(f"llama_fp8_lora_train: {len(frozen)} frozen base tensors "
          f"unchanged (word digests); {len(flat)} rings advanced")
    ids, mask = (torch.as_tensor(batch[k][:LLAMA_BATCH], device="cuda")
                 for k in ("input_ids", "attention_mask"))
    site_errs = fp8_site_check(torch, model, ids, mask)
    worst = max(site_errs, key=site_errs.get)
    print(f"llama_fp8_lora_train: all {len(site_errs)} fp8 sites (rings after "
          f"the run, one microbatch of {LLAMA_BATCH} x {LLAMA_SEQ}) against "
          f"the plain product of the same casts: largest difference "
          f"{site_errs[worst]:.3e} of the output's largest magnitude, at "
          f"{worst} (tol {FP8_SITE_TOL:.3e})")
    if len(site_errs) != sites or not site_errs[worst] <= FP8_SITE_TOL:
        fail(f"llama_fp8_lora_train: fp8 site {worst} is "
             f"{site_errs[worst]:.3e} from its plain product (tol "
             f"{FP8_SITE_TOL}; {len(site_errs)} sites checked)")
    layers = (0, 7, 15, mcfg.num_layers - 1)
    drift = fp8_drift(torch, model, ids, mask, layers)
    print(f"llama_fp8_lora_train: the fp8 forward's block outputs (blocks "
          f"{', '.join(str(i + 1) for i in layers)}), relative L2 distance "
          f"from the bf16 products' {', '.join(f'{x:.3e}' for x in drift['bf16'])}"
          f"; from the plain fp8 products' (the same casts, f32 products) "
          f"{', '.join(f'{x:.3e}' for x in drift['fp8 plain'])}")
    # The fp8 losses of the initial weights, step 1 (empty rings) and
    # step 2 (filled rings), against the bf16 loss of the same weights.
    evaluate = make_classification_eval_step(
        input_keys=("input_ids", "attention_mask"))
    seeds = {}
    for seed in LLAMA_FP8_SEEDS:
        model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
        with fp8_sites_as_plain(model):
            ref = microbatch_eval_loss(torch, evaluate, state, batch,
                                       LLAMA_FP8_ACCUM)
        if seed == 0:
            if not abs(ref - bf16_loss) <= LLAMA_FP8_REF_TOL:
                fail(f"llama_fp8_lora_train: the fp8 model's sites as bf16 "
                     f"products give {ref:.5f} at seed 0, the bf16 LoRA "
                     f"model {bf16_loss:.5f} (tol {LLAMA_FP8_REF_TOL})")
            fp8_losses = metrics["eager"]["losses"][:2]
            ref_shown = f"{ref:.5f}; llama_lora_train's {bf16_loss:.5f}"
            ref = bf16_loss
        else:
            restart(torch, state)
            fp8_losses = []
            for _ in range(2):
                state, m = step(state, batch, 1)
                fp8_losses.append(float(m["loss"]))
            ref_shown = f"{ref:.5f}"
        gaps = [abs(x - ref) for x in fp8_losses]
        seeds[seed] = {"bf16_loss": ref, "fp8_losses": fp8_losses,
                       "gaps": gaps}
        print(f"llama_fp8_lora_train: seed {seed}: fp8 losses "
              f"{fp8_losses[0]:.5f} (step 1, empty rings) and "
              f"{fp8_losses[1]:.5f} (step 2, filled rings), bf16 loss of the "
              f"same weights and rows {ref_shown}: gaps {gaps[0]:.5f} and "
              f"{gaps[1]:.5f} (band {band}, "
              f"{'held' if seed == 0 else 'read'})")
        if seed == 0 and not max(gaps) <= band:
            fail(f"llama_fp8_lora_train: an fp8 loss is {max(gaps):.5f} "
                 f"from the bf16 loss {ref:.5f} (band {band})")
    metrics.update({"first_step_loss": seeds[0]["fp8_losses"][0],
                    "bf16_first_step_loss": bf16_loss,
                    "loss_gap": seeds[0]["gaps"][0],
                    "second_step_loss_gap": seeds[0]["gaps"][1],
                    "seeds": seeds, "site_max_err": site_errs[worst],
                    "drift_blocks": [i + 1 for i in layers], "drift": drift})
    del state, model, named, frozen, init
    return metrics


def llama1b_full_train_phase(torch, card):
    """Full-parameter training of Llama-3.2-1B (LLAMA3_1B) at full width and
    depth: lora_rank=0, so every parameter trains against f32 masters cast
    to bf16 at use, under policy("bf16", bf16_moments=True) (AdamW's
    first moment in bf16), seq 2048, LLAMA1B_ACCUM microbatches of 4, the
    llama3_8b_lora optimizer (its warm-up from 0: the first step moves
    nothing, the others move every tensor). The losses of steps 1 and 2
    (both on the initial weights) within LLAMA1B_EVAL_TOL of the eval
    step's on the same batches; every parameter tensor has moved after
    the run, the masters stay f32, losses finite; eager then captured,
    bit for bit, with exact launch counts (every norm gets a backward:
    the embedding trains). Then, as a reading, the same model from the
    same weights at the optimizer's constant 1e-4 (no warm-up), and
    llama1b_cut_parity."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        create_train_state,
        make_classification_eval_step,
        make_classification_train_step,
        policy,
    )

    pol = policy("bf16", bf16_moments=True)
    t0 = time.perf_counter()
    model = build_model("llama3-1b", 2, fused_ops=True, attention_impl="flash")
    state = create_train_state(0, model, llama_optimizer(), precision=pol)
    mcfg = model.cfg
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    n_proj = sum(p.numel() for n, p in named.items()
                 if n.endswith("_proj.weight"))
    if not all(p.requires_grad and p.dtype == torch.float32
               for p in named.values()):
        fail("llama1b_full_train: not every parameter is a trainable f32 "
             "master")
    mus = {t.dtype for t in state.opt_state["mu"].values()}
    if mus != {torch.bfloat16}:
        fail(f"llama1b_full_train: first moments in {mus}, not bf16")
    rows = LLAMA_BATCH * LLAMA1B_ACCUM
    batches = list(synthetic_token_batches(rows, LLAMA_SEQ, mcfg.vocab_size,
                                           num_batches=3 + LLAMA1B_STEPS))
    torch.cuda.synchronize()
    print(f"llama1b_full_train: Llama-3.2-1B ({mcfg.num_layers} layers, hidden "
          f"{mcfg.hidden_size}), {n_params / 1e9:.3f} B parameters all "
          f"trainable (f32 masters), policy('bf16', bf16_moments=True), "
          f"{LLAMA1B_ACCUM} microbatches x {LLAMA_BATCH} x seq {LLAMA_SEQ}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    keys = ("input_ids", "attention_mask")
    evaluate = make_classification_eval_step(input_keys=keys)
    # The initial weights' loss on each batch the runs see.
    held = [microbatch_eval_loss(torch, evaluate, state, b, LLAMA1B_ACCUM)
            for b in batches[:1 + LLAMA1B_STEPS + 1]]
    step = make_classification_train_step(
        input_keys=keys, accum_steps=LLAMA1B_ACCUM, precision=pol)
    tokens = rows * LLAMA_SEQ
    attn = 7.0 * rows * mcfg.hidden_size * LLAMA_SEQ ** 2 * mcfg.num_layers
    # Forward, input and weight gradients of every projection.
    flops = 6.0 * n_proj * tokens + attn
    per_step = llama_launches_per_step(mcfg.num_layers, LLAMA1B_ACCUM)
    # The first input norm's backward runs too: the embedding trains.
    per_step["norm_bwd"] += LLAMA1B_ACCUM
    init = {k: p.detach().clone() for k, p in state.params.items()}
    metrics = llama_train_run(torch, card, "llama1b_full_train", state, step,
                              batches, tokens, flops, per_step, {}, 1,
                              LLAMA1B_STEPS, init)
    losses = metrics["eager"]["losses"]
    gaps = [abs(a - b) for a, b in zip(losses, held)]
    print(f"llama1b_full_train: the initial weights' eval losses on the "
          f"runs' batches {', '.join(f'{x:.4f}' for x in held)}; the steps' "
          f"{', '.join(f'{x:.4f}' for x in losses)} (steps 1 and 2 run on "
          f"the initial weights: gaps {gaps[0]:.2e} and {gaps[1]:.2e}, tol "
          f"{LLAMA1B_EVAL_TOL})")
    if not max(gaps[:2]) <= LLAMA1B_EVAL_TOL:
        fail(f"llama1b_full_train: a loss on the initial weights is "
             f"{max(gaps[:2]):.3e} from the eval step's (tol "
             f"{LLAMA1B_EVAL_TOL})")
    still = [k for k, p in state.params.items() if torch.equal(p, init[k])]
    if still:
        fail(f"llama1b_full_train: parameters that did not move: {still[:5]}")
    if not all(p.dtype == torch.float32 for p in state.params.values()):
        fail("llama1b_full_train: a master left f32")
    print(f"llama1b_full_train: all {len(init)} parameter tensors moved, "
          f"masters f32, first moments bf16")
    # A reading: the same weights and batches at the optimizer's
    # constant 1e-4, whose first step moves every weight.
    state.tx = llama_optimizer(constant=True)
    restart(torch, state, init)
    constant = []
    for b in batches[:1 + LLAMA1B_CONSTANT_STEPS]:
        state, m = step(state, b, 1)
        constant.append(float(m["loss"]))
    print(f"llama1b_full_train: at a constant lr of 1e-4 from the same "
          f"weights: losses {', '.join(f'{x:.4f}' for x in constant)}")
    metrics.update({"num_params": n_params, "accum_steps": LLAMA1B_ACCUM,
                    "microbatch": LLAMA_BATCH, "seq": LLAMA_SEQ,
                    "initial_weights_eval_losses": held,
                    "constant_lr_losses": constant})
    del state, model, named, init
    gc.collect()
    torch.cuda.empty_cache()
    metrics["cut_parity"] = llama1b_cut_parity_phase(torch)
    return metrics


def llama1b_cut_parity_phase(torch):
    """llama1b_full_train's step held to a plain reference: Llama-3.2-1B at
    full width cut to LLAMA1B_CUT_LAYERS layers, from one set of weights,
    through the kernel path (the phase's: fused_ops=True,
    attention_impl="flash", policy("bf16", bf16_moments=True)), the plain
    bf16 path (fused_ops=False, the reference attention, the same
    policy) and an f32 oracle (plain, no policy, f32 moments), over
    batches of LLAMA_BATCH x LLAMA_SEQ. The first step's gradients
    against the oracle's: the kernel path's relative L2 error of all
    gradients together, and of each tensor's but the ungated
    classifier.bias, may not exceed KERNEL_ERR_RATIO x the plain path's
    (as llama_train_parity). Then LLAMA1B_CUT_STEPS steps with the
    phase's optimizer (warm-up from 0: steps 3 and 4 run on weights that
    steps 2 and 3 moved) and LLAMA1B_CONSTANT_STEPS from the same
    weights at its constant 1e-4: every loss within the bf16 band (0.03,
    tpudl's bf16-vs-f32 band) of the oracle's."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.llama import LLAMA3_1B, LlamaForSequenceClassification
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        policy,
    )

    kw = dict(num_layers=LLAMA1B_CUT_LAYERS, num_labels=2)
    init = LlamaForSequenceClassification(LLAMA3_1B(**kw), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(13))
    params = {k: v.detach() for k, v in init.state_dict().items()}
    pol = policy("bf16", bf16_moments=True)
    paths = {
        "kernel": (torch.bfloat16, pol, {"fused_ops": True,
                                         "attention_impl": "flash"}),
        "plain": (torch.bfloat16, pol, {"fused_ops": False}),
        "oracle": (torch.float32, None, {"fused_ops": False}),
    }
    batches = list(synthetic_token_batches(
        LLAMA_BATCH, LLAMA_SEQ, init.cfg.vocab_size, seed=9,
        num_batches=LLAMA1B_CUT_STEPS))
    del init
    runs = {"warm-up": (None, batches),
            "constant 1e-4": (True, batches[:LLAMA1B_CONSTANT_STEPS])}
    out = {}
    for name, (dtype, prec, extra) in paths.items():
        model = LlamaForSequenceClassification(
            LLAMA3_1B(dtype=dtype, **kw, **extra), device="meta")
        st = create_train_state(0, model, llama_optimizer(), params=params,
                                precision=prec)
        step = make_classification_train_step(
            input_keys=("input_ids", "attention_mask"), precision=prec)
        grads, _ = step.grads_and_metrics(st, batches[0], fold_in(7, 0, "cuda"))
        out[name] = {"grads": {k: g.double() for k, g in grads.items()}}
        for run, (constant, feed) in runs.items():
            if constant:
                st.tx = llama_optimizer(constant=True)
                restart(torch, st, params)
            losses = []
            for b in feed:
                st, m = step(st, b, 1)
                losses.append(float(m["loss"]))
            out[name][run] = losses
        del st, model, step, grads
        gc.collect()
        torch.cuda.empty_cache()
    del params
    go = out["oracle"]["grads"]
    names = sorted(go)
    gated = [k for k in names if k != "classifier.bias"]

    def err(grads, keys):
        num = sum(float(((grads[k] - go[k]) ** 2).sum()) for k in keys)
        den = sum(float((go[k] ** 2).sum()) for k in keys)
        return (num / den) ** 0.5 if den > 0 else num ** 0.5

    errs = {p: {"all gradients": err(out[p]["grads"], gated),
                **{k: err(out[p]["grads"], [k]) for k in names}}
            for p in ("kernel", "plain")}
    ratio = {k: errs["kernel"][k] / max(errs["plain"][k], 1e-300)
             for k in errs["kernel"]}
    judged = ["all gradients"] + gated
    worst = sorted(judged, key=lambda k: -ratio[k])[:5]
    band = PRECISION_BANDS["bf16"]
    gaps = {p: {run: [abs(a - b) for a, b in zip(out[p][run],
                                                  out["oracle"][run])]
                for run in runs}
            for p in ("kernel", "plain")}
    print(f"llama1b_cut_parity: Llama-3.2-1B width, {LLAMA1B_CUT_LAYERS} "
          f"layers, all {len(names)} parameters trained, rel L2 err of the "
          f"first step's gradients vs the f32 oracle, kernel vs plain path: "
          f"all gradients {errs['kernel']['all gradients']:.4e} vs "
          f"{errs['plain']['all gradients']:.4e}; worst judged ratios: "
          + ", ".join(f"{k} {ratio[k]:.3f} ({errs['kernel'][k]:.3e} vs "
                      f"{errs['plain'][k]:.3e})" for k in worst)
          + f"; ungated: classifier.bias {ratio['classifier.bias']:.3f}")
    for run in runs:
        print(f"llama1b_cut_parity: losses, {run}, batches of {LLAMA_BATCH} x "
              f"{LLAMA_SEQ}: "
              + "; ".join(f"{p} {', '.join(f'{x:.4f}' for x in out[p][run])}"
                          for p in paths)
              + f" (largest gap to the oracle: kernel "
              f"{max(gaps['kernel'][run]):.4f}, plain "
              f"{max(gaps['plain'][run]):.4f}; band {band})")
    bad = [k for k in judged if ratio[k] > KERNEL_ERR_RATIO]
    if bad:
        fail(f"llama1b_cut_parity: the kernel path's gradient error exceeds "
             f"{KERNEL_ERR_RATIO} x the plain path's in {bad[:5]}")
    largest = max(x for p in gaps.values() for g in p.values() for x in g)
    if not largest <= band:
        fail(f"llama1b_cut_parity: a loss is {largest:.4f} from the f32 "
             f"oracle's (band {band})")
    return {"layers": LLAMA1B_CUT_LAYERS,
            "gradients_rel_err": {p: errs[p]["all gradients"] for p in errs},
            "worst_ratio": [worst[0], ratio[worst[0]]],
            "losses": {p: {run: out[p][run] for run in runs} for p in out},
            "loss_gaps": gaps}


# ---------------------------------------------------------------------------
# The quantized tiers and the MoE MLP: quant_dot, quant_slice,
# quant_kv8_slice, export_quant, bert_quant_eval, moe_train
# ---------------------------------------------------------------------------

#: quant_dot kernel vs its plain twin: both sum exact f32 products in f32
#: (another order) and round once to the output dtype: each element within
#: 2^-7 of itself (one bf16 step) plus 2^-10 of the output's largest
#: magnitude (near-zero sums); f32 x through the tensor cores (split into
#: three bf16 terms, M > 16) 1e-4 of the largest magnitude.
QUANT_TOL = {"bfloat16": (2.0**-7, 2.0**-10), "float32": (1e-5, 1e-4)}
#: quant_dot's main-path shapes: (rows of x, in, out). Decode at the
#: slice's 4 slots (and at 8 and 16 rows: the GEMV's one and two n8 tiles
#: of x), prefill at its window, BERT-base at 256 x 128.
QUANT_SHAPES = (
    (NUM_SLOTS, 4096, 4096), (NUM_SLOTS, 4096, 1024),
    (NUM_SLOTS, 4096, 14336), (NUM_SLOTS, 14336, 4096),
    (8, 4096, 4096), (16, 4096, 4096),
    (PROMPT_LEN, 4096, 4096), (PROMPT_LEN, 4096, 1024),
    (PROMPT_LEN, 4096, 14336), (PROMPT_LEN, 14336, 4096),
    (BERT_BATCH * BERT_SEQ, 768, 768), (BERT_BATCH * BERT_SEQ, 768, 3072),
    (BERT_BATCH * BERT_SEQ, 3072, 768),
)
QUANT_WEIGHT_DTYPES = ("int8", "fp8_e4m3")
#: quant_dot launches a decode or prefill step: 7 projections x 32 layers.
QUANT_PER_STEP = 7 * 32
#: BERT-base quantized eval: 6 quantized products a layer x 12.
BERT_QUANT_PER_FORWARD = 6 * 12
#: The teacher-forced logit check of the quantized sessions: this many
#: greedy requests, up to this many of their tokens.
QUANT_PARITY_REQUESTS = 2
QUANT_PARITY_TOKENS = 16
#: export_quant: the 8B's width, its first layers.
EXPORT_QUANT_LAYERS = 4
#: moe_train: llama3-1b-moe (8 experts, top-2, capacity 1.25) cut to 4 of
#: its 16 layers, 2 microbatches of LLAMA_BATCH x LLAMA_SEQ, aux weight
#: 0.01; its parity cut: 1 layer, 4 x 2048, within 0.03 of an f32 oracle.
MOE_LAYERS = 4
MOE_ACCUM = 2
MOE_STEPS = 2
MOE_AUX_WEIGHT = 0.01
MOE_CUT_LAYERS = 1
MOE_CUT_STEPS = 3


def quant_dot_kernel_phase(torch):
    """The quant_dot kernel (csrc/quant_dot.cu: the tensor-core GEMV at M
    <= 16, the TMA + wgmma product above, the FMA GEMV and the mma.sync
    kernel for f32 x and ragged K) against its plain twin at the main
    path's shapes, int8 and e4m3, bf16 x; two runs bitwise equal. Times
    (graph replay): the kernel, the plain twin, bf16 torch.matmul on the
    full-precision weight, dequantize + torch.matmul, and
    torch._weight_int8pack_mm (the one PyTorch call of the same function,
    int8 only, where this build has it for CUDA); the bound (the weight,
    x and y bytes at the memory rate, or 2MNK at the bf16 peak). At the
    GEMV's shapes the kernel and bf16 torch.matmul are also timed L2-cold
    (``cold_ms``: weights rotated over copies past twice the L2, as a
    decode step streams them); ``graph_ms`` replays one weight, L2-warm
    where it fits the 50 MB L2."""
    from tpudl_torch.ops import quant_dot as qd
    from tpudl_torch.quant.quantize import quantize_leaf

    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for m, k, n in QUANT_SHAPES:
        w = torch.randn(n, k, generator=g, device="cuda") * 0.02
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        wb = w.bfloat16()
        if m <= qd.GEMV_MAX_ROWS:
            wbs = [wb] + [wb.clone() for _ in range(
                -(-COLD_BYTES // (2 * n * k)) - 1)]
            bf16_cold = cold_ms(lambda i: (lambda: x @ wbs[i % len(wbs)].t()),
                                2 * n * k)
            del wbs
        for wd in QUANT_WEIGHT_DTYPES:
            leaf = quantize_leaf(w, wd)
            q, s = leaf["qvalues"], leaf["qscale"]
            y = qd._quant_dot_cuda(x, q, s)
            again = qd._quant_dot_cuda(x, q, s)
            ref = qd.quant_matmul_ref(x, q, s)
            torch.cuda.synchronize()
            rtol, atol = QUANT_TOL["bfloat16"]
            err = errors(y, ref, rtol, atol * float(ref.float().abs().max()))
            nbytes = m * k * 2 + n * k + 4 * n + m * n * 2
            row = case_row((m, k, n), torch.bfloat16, wd, err, rtol, nbytes,
                           2.0 * m * n * k, BF16_OPS_PER_S)
            row["entry"] = "gemv" if m <= qd.GEMV_MAX_ROWS else "gemm"
            if not err[2] or not torch.equal(y, again):
                fail(f"quant_dot [{m}, {k}] -> {n} {wd}: max abs err "
                     f"{err[0]:.3e} (tol {rtol} + {atol} x max), repeat "
                     f"bitwise {torch.equal(y, again)}")
            library = None
            if wd == "int8" and hasattr(torch, "_weight_int8pack_mm"):
                s16 = s.bfloat16()

                def library():
                    return torch._weight_int8pack_mm(x, q, s16)
            timed_case(row, lambda: qd._quant_dot_cuda(x, q, s),
                       lambda: qd.quant_matmul_ref(x, q, s), plain_calls=5)
            if library is not None:
                # Up to 169 ms a call at BERT's shapes: few calls.
                row["library_ms"] = library_ms(library, calls=2, reps=3)
                row["library"] = "torch._weight_int8pack_mm"
            row["bf16_matmul_ms"] = graph_ms(lambda: x @ wb.t(), calls=20,
                                             reps=5)
            row["dequant_matmul_ms"] = graph_ms(
                lambda: x @ (q.float() * s[:, None]).bfloat16().t(),
                calls=10, reps=5)
            cold = ""
            if m <= qd.GEMV_MAX_ROWS:
                copies = [q] + [q.clone() for _ in range(
                    -(-COLD_BYTES // (n * k)) - 1)]
                row["cold_ms"] = cold_ms(lambda i: (
                    lambda: qd._quant_dot_cuda(x, copies[i % len(copies)], s)),
                    n * k)
                row["bf16_matmul_cold_ms"] = bf16_cold
                plan = qd.gemv_plan(m, n, k)
                row["plan"] = {key: plan[key] for key in qd.GEMV_ARGS}
                cold = (f"L2-cold {row['cold_ms'] * 1e3:.2f} us "
                        f"({100 * row['bound'][0] / row['cold_ms']:.1f} % of "
                        f"the bound; bf16 matmul {bf16_cold * 1e3:.2f} us, "
                        f"{row['cold_ms'] / bf16_cold:.3f}x), plan "
                        f"{row['plan']}; ")
                del copies
            rows.append(row)
            print(f"quant_dot [{m}, {k}] -> {n} {wd} ({row['entry']}): "
                  f"{cold}{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f}"
                  f" us, bf16 matmul {row['bf16_matmul_ms'] * 1e3:.2f} us, "
                  f"dequantize + matmul {row['dequant_matmul_ms'] * 1e3:.2f} "
                  f"us, library {row['library_ms'] and row['library_ms'] * 1e3}"
                  f" us; bound {row['bound'][0] * 1e3:.2f} us "
                  f"({row['bound'][1]}); max abs err {err[0]:.3e}")
    # The TMA route at ragged M, N and K (split K, then not), once.
    for m, k, n in ((PROMPT_LEN + 1, 4112, 1000), (4099, 4112, 1000)):
        w = torch.randn(n, k, generator=g, device="cuda") * 0.02
        x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        for wd in QUANT_WEIGHT_DTYPES:
            leaf = quantize_leaf(w, wd)
            q, s = leaf["qvalues"], leaf["qscale"]
            y = qd._quant_dot_cuda(x, q, s)
            again = qd._quant_dot_cuda(x, q, s)
            ref = qd.quant_matmul_ref(x, q, s)
            rtol, atol = QUANT_TOL["bfloat16"]
            err = errors(y, ref, rtol, atol * float(ref.float().abs().max()))
            if not err[2] or not torch.equal(y, again):
                fail(f"quant_dot ragged [{m}, {k}] -> {n} {wd}: max abs err "
                     f"{err[0]:.3e}, repeat bitwise {torch.equal(y, again)}")
            print(f"quant_dot ragged [{m}, {k}] -> {n} {wd} (split "
                  f"{qd.gemm_plan(m, n, k)['split']}): max abs err "
                  f"{err[0]:.3e}")
    # The scalar variant (K not whole 16-byte vectors) and f32 x, once.
    for m, k, n in ((NUM_SLOTS, 4100, 1000), (PROMPT_LEN, 4100, 1000)):
        w = torch.randn(n, k, generator=g, device="cuda") * 0.02
        leaf = quantize_leaf(w, "int8")
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(m, k, generator=g, device="cuda").to(dt)
            y = qd._quant_dot_cuda(x, leaf["qvalues"], leaf["qscale"])
            ref = qd.quant_matmul_ref(x, leaf["qvalues"], leaf["qscale"])
            rtol, atol = QUANT_TOL[str(dt).split(".")[-1]]
            err = errors(y, ref, rtol, atol * float(ref.float().abs().max()))
            if not err[2]:
                fail(f"quant_dot unaligned [{m}, {k}] -> {n} {dt}: max abs "
                     f"err {err[0]:.3e}")
            print(f"quant_dot unaligned [{m}, {k}] -> {n} {dt}: max abs err "
                  f"{err[0]:.3e}")
    return {"quant_dot": rows}


def quant_sites(model, impl):
    """Set every QuantDense's product form (the kernel "auto", the plain
    twin's composite "reference")."""
    from tpudl_torch.quant.dense import QuantDense

    for mod in model.modules():
        if isinstance(mod, QuantDense):
            mod.impl = impl
    return model


def teacher_forced_logits(torch, model, params, prompt, cont, kv=None):
    """Logits [len(cont) + 1, V] of ``model`` on ``prompt`` then ``cont``
    teacher-forced, through the serving contracts one slot at a time: the
    prefill, then one decode call a token on the dense cache (``kv`` None)
    or on a paged cache of page 16 (``kv`` "int8" or "bf16")."""
    from tpudl_torch.export.decode import device_index_cache
    from tpudl_torch.models.generate import decode_fn, paged_decode_fn, prefill_fn
    from tpudl_torch.models.llama import init_cache
    from tpudl_torch.serve.cache import PagedKVCache

    ids = torch.tensor([prompt], device="cuda")
    logits, row = prefill_fn(model)(params, ids, torch.ones_like(ids))
    out = [logits[0]]
    n = len(prompt)
    if kv is None:
        cache = device_index_cache(row)
        step = decode_fn(model)
    else:
        pc = PagedKVCache(init_cache(model.cfg, 1, device="meta"),
                          page_size=16, kv_dtype=None if kv == "bf16" else kv,
                          device="cuda")
        pc.seat(row, 0, 0, n, n + len(cont))
        step = paged_decode_fn(model, 16, pc.quantized)
        cache = pc.cache
    for i, t in enumerate(cont):
        args = (params, cache, torch.tensor([t], device="cuda"),
                torch.tensor([n + i], device="cuda"))
        if kv is not None:
            args += tuple(pc.dispatch_args())
        logits, _ = step(*args)
        if kv is not None:
            pc.advance([0])
        out.append(logits[0])
    return torch.stack(out).float()


def quant_parity(torch, what, qmodel, qparams, oracle_params, requests,
                 results, kv=None):
    """The kernel path's logit error against an f32 oracle on the
    dequantized weights (dense f32 cache), teacher-forced on the kernel
    session's own tokens of QUANT_PARITY_REQUESTS greedy requests, may be
    no larger than the plain twin's (the composite: dequantize, then the
    bf16 product) on the same tokens and cache."""
    import dataclasses

    from tpudl_torch.models.llama import LlamaForCausalLM

    oracle = LlamaForCausalLM(dataclasses.replace(
        qmodel.cfg, dtype=torch.float32, fused_ops=False, weight_dtype=None),
        device="meta")
    twin = quant_sites(LlamaForCausalLM(qmodel.cfg, device="meta"),
                       "reference")
    sums = {"kernel": 0.0, "plain twin": 0.0}
    count = 0
    greedy = [r for r in requests if r.temperature == 0.0]
    for req in greedy[:QUANT_PARITY_REQUESTS]:
        cont = results[req.request_id].tokens[:QUANT_PARITY_TOKENS]
        with torch.no_grad():
            ref = teacher_forced_logits(torch, oracle, oracle_params,
                                        req.input_ids, cont[:-1])
            for name, m in (("kernel", qmodel), ("plain twin", twin)):
                got = teacher_forced_logits(torch, m, qparams, req.input_ids,
                                            cont[:-1], kv)
                if not bool(torch.isfinite(got).all()):
                    fail(f"{what}: non-finite logits on the {name} path")
                sums[name] += float((got - ref).abs().sum())
        count += ref.numel()
    mean_k, mean_p = sums["kernel"] / count, sums["plain twin"] / count
    print(f"{what}: mean |logit - f32 oracle on the dequantized weights| "
          f"over {count} teacher-forced logits: kernel path {mean_k:.5f}, "
          f"plain twin {mean_p:.5f}")
    if mean_k > mean_p:
        fail(f"{what}: the kernel path's logit error {mean_k:.5f} exceeds "
             f"the plain twin's {mean_p:.5f}")
    return {"mean_err_kernel": mean_k, "mean_err_plain_twin": mean_p}


def oracle_params_of(torch, qparams):
    """f32 parameters of the f32 oracle: the quantized pairs dequantized
    to f32, every other leaf widened."""
    from tpudl_torch.quant.quantize import dequantize_tree

    return {k: v.float() for k, v in dequantize_tree(qparams).items()}


def quant_serve_runs(torch, what, model, params, requests, kw, card, dense,
                     adapters=False):
    """Serve ``requests`` through ServeSession.from_model(**kw) eager then
    captured: every result ok, exactly QUANT_PER_STEP quant_dot, 65
    RMSNorm and 32 SwiGLU launches (224 segmented-LoRA with adapters) per
    prefill and decode step, tokens equal; TTFT, TPOT, tokens/s beside
    the dense bf16 slice's. Returns (the captured run's session and
    results, metrics)."""
    from tpudl_torch.ops import segmented_lora as sl
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.ops.quant_dot import quant_matmul
    from tpudl_torch.serve import Request, ServeSession

    counted = {"quant_dot": quant_matmul, "rms_norm_fwd": rms_norm,
               "swiglu_fwd": swiglu}
    if adapters:
        counted["seg_lora"] = sl.segmented_lora
    warm = ServeSession.from_model(model, params, capture=False, **kw)
    warm.serve([Request("warm", [1, 2, 3], max_new_tokens=2)])
    del warm
    runs = {capture: serve_run(
        torch, ServeSession.from_model(model, params, capture=capture, **kw),
        requests, counted) for capture in (False, True)}
    out = {}
    for capture, (session, results, wall, launches, peak) in runs.items():
        way = "captured" if capture else "eager"
        eng = session.engine
        calls = eng.num_prefills + eng.num_decode_steps
        bad = [rid for rid, r in results.items() if not r.ok]
        if bad:
            fail(f"{what}: requests not ok: {bad}")
        for req in requests:
            toks = results[req.request_id].tokens
            if len(toks) != req.max_new_tokens or not all(
                    0 <= t < model.cfg.vocab_size for t in toks):
                fail(f"{what}: request {req.request_id}: {len(toks)} tokens")
        want = {"quant_dot": QUANT_PER_STEP * calls, "rms_norm_fwd": 65 * calls,
                "swiglu_fwd": 32 * calls}
        if adapters:
            want["seg_lora"] = 224 * calls
        if launches != want:
            fail(f"{what} ({way}): launches {launches} != expected {want}")
        ttft = [r.ttft_s * 1e3 for r in results.values()]
        tpot = [r.tpot_s * 1e3 for r in results.values()
                if r.tpot_s is not None]
        tokens = sum(len(r.tokens) for r in results.values())
        m = {"ttft_p50_ms": pct(ttft, 50), "ttft_p90_ms": pct(ttft, 90),
             "tpot_p50_ms": pct(tpot, 50), "tpot_p90_ms": pct(tpot, 90),
             "tokens_per_s": tokens / wall, "prefills": eng.num_prefills,
             "decode_steps": eng.num_decode_steps, "peak_memory_gib": peak,
             "launches": launches, "cache_bytes": eng.cache.nbytes,
             "quant_dot_per_step": launches["quant_dot"] // calls}
        if adapters:
            m["pool"] = eng.adapter_pool.stats()
        d = dense if capture else dense["eager"]
        print(f"{what} metrics, {way} ({card}): TTFT p50 "
              f"{m['ttft_p50_ms']:.2f} ms, p90 {m['ttft_p90_ms']:.2f}; TPOT p50 "
              f"{m['tpot_p50_ms']:.3f} ms, p90 {m['tpot_p90_ms']:.3f} (bf16 "
              f"dense slice {d['tpot_p50_ms']:.3f} / {d['tpot_p90_ms']:.3f}); "
              f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s "
              f"(bf16 {d['tokens_per_s']:.1f}); {eng.num_prefills} prefills, "
              f"{eng.num_decode_steps} decode steps, {m['quant_dot_per_step']} "
              f"quant_dot launches a step; cache {m['cache_bytes'] / 2**20:.1f}"
              f" MiB; peak memory {peak:.2f} GiB"
              + (f"; pool {m['pool']}" if adapters else ""))
        out[capture] = m
    same_tokens(runs, requests, what)
    metrics = out[True]
    metrics["eager"] = out[False]
    return runs[True][0], runs[True][1], metrics


def quant_slice_phase(torch, model, params, card, dense, requests):
    """The slice's session (4 slots, dense cache, max_seq_len 512, the
    slice's 8 greedy requests and one sampled) with weight_dtype="int8",
    then "fp8_e4m3", eager then captured; weight_bytes_report; the
    teacher-forced logit rule (quant_parity); a profiled window of
    decode steps for each weight dtype, on the captured session that just
    served. Returns ({weight dtype: (session, results)}, metrics)."""
    from tpudl_torch.quant import quantize_model, weight_bytes_report
    from tpudl_torch.serve import Request

    sessions, out = {}, {}
    for wd in QUANT_WEIGHT_DTYPES:
        what = f"quant_slice ({wd})"
        t0 = time.perf_counter()
        qmodel, qparams = quantize_model(model, params, wd)
        torch.cuda.synchronize()
        report = weight_bytes_report(qparams)
        print(f"{what}: quantize_model {time.perf_counter() - t0:.2f} s; "
              f"weight_bytes_report {report}")
        kw = dict(prompt_len=PROMPT_LEN, num_slots=NUM_SLOTS, weight_dtype=wd)
        session, results, m = quant_serve_runs(torch, what, model, params,
                                               requests, kw, card, dense)
        m["weight_bytes"] = report
        oracle = oracle_params_of(torch, qparams)
        m["parity"] = quant_parity(torch, what, qmodel, qparams, oracle,
                                   requests, results)
        del oracle
        torch.cuda.empty_cache()
        # The captured session just served: no second quantize and capture.
        m["decode_device_busy_share"] = profile_decode(
            torch, model, params, Request, dict(kw), session=session)
        if wd == "int8":
            sessions[wd] = (qmodel, qparams, results)
        else:
            sessions[wd] = (qmodel, None, results)
        del qparams
        torch.cuda.empty_cache()
        out[wd] = m
    return sessions, out


def quant_kv8_slice_phase(torch, model, params, card, dense, requests,
                          adapters, t_requests, int8):
    """tpudl's acceptance cell: int8 weights over int8 KV pages in one
    session (paged, page 16), eager then captured, without tenants (the
    slice's requests; the logit rule through the paged int8 path), then
    with the six tenants of tenant_slice on the quantized base (their
    requests; the pool evicts and reloads). The pool bytes against a bf16
    pool of the same pages."""
    from tpudl_torch.models.llama import init_cache
    from tpudl_torch.serve.cache import PagedKVCache

    kw = dict(prompt_len=PROMPT_LEN, num_slots=NUM_SLOTS, paged=True,
              page_size=16, weight_dtype="int8", kv_dtype="int8")
    what = "quant_kv8_slice"
    session, results, m = quant_serve_runs(torch, what, model, params,
                                           requests, kw, card, dense)
    cache = session.engine.cache
    bf16 = PagedKVCache(init_cache(model.cfg, NUM_SLOTS, device="meta"),
                        page_size=16, num_pages=cache.num_pages,
                        device="meta")
    host = cache.page_table.nbytes + cache.start.nbytes + cache.lens.nbytes
    m["pool_bytes"], m["bf16_pool_bytes"] = cache.nbytes, bf16.nbytes
    ratio = (cache.nbytes - host) / (bf16.nbytes - host)
    print(f"{what}: int8 pool {cache.nbytes} B against a bf16 pool of the "
          f"same {cache.num_pages} pages {bf16.nbytes} B: {ratio:.4f}x of the "
          f"device bytes ((2 x 8 x 128 + 2 x 8 x 4) / 4096 = "
          f"{(2 * 8 * 128 + 2 * 8 * 4) / 4096:.4f})")
    if abs(ratio - (2 * 8 * 128 + 2 * 8 * 4) / 4096) > 1e-6:
        fail(f"{what}: pool bytes ratio {ratio}")
    qmodel, qparams, _ = int8
    oracle = oracle_params_of(torch, qparams)
    m["parity"] = quant_parity(torch, what, qmodel, qparams, oracle,
                               requests, results, kv="int8")
    del oracle
    torch.cuda.empty_cache()
    tkw = dict(kw, adapters=adapters, adapter_pages=TENANT_PAGES,
               adapter_rank_max=16)
    _, t_results, tm = quant_serve_runs(torch, f"{what} (tenants)", model,
                                        params, t_requests, tkw, card, dense,
                                        adapters=True)
    if not (tm["pool"]["evictions"] > 0 and tm["pool"]["reloads"] > 0):
        fail(f"{what} (tenants): the pool did not evict and reload: "
             f"{tm['pool']}")
    m["tenants"] = tm
    return results, m


def export_quant_phase(torch, sessions, card, requests):
    """The quantized serving programs as torch.export artifacts, at the
    8B's full width cut to EXPORT_QUANT_LAYERS layers (its first layers'
    quantized weights; tracing and loading 32 layers took ~115 s): the
    dense int8 pair and the paged int8-weights-over-int8-pages pair
    (export_serving_decoder(paged=True, kv_dtype="int8")), each product a tpudl::quant_dot node; served from artifacts
    (captured) with the tokens of model sessions of the same cut model and
    its 7 x EXPORT_QUANT_LAYERS quant_dot launches a step."""
    from tpudl_torch.export.decode import export_serving_decoder
    from tpudl_torch.export.export import load_exported_obj
    from tpudl_torch.ops.library import graph_ops
    from tpudl_torch.ops.quant_dot import quant_matmul
    from tpudl_torch.serve import Request, ServeSession

    qmodel, qparams, _ = sessions["int8"]
    n = EXPORT_QUANT_LAYERS
    qmodel, qparams = cut_llama(qmodel, qparams, n)
    per_step = 7 * n
    out = {}
    for paged in (False, True):
        way = "paged int8 KV" if paged else "dense"
        kw = dict(paged=True, page_size=16, kv_dtype="int8") if paged else {}
        ref = ServeSession.from_model(qmodel, qparams, prompt_len=PROMPT_LEN,
                                      num_slots=NUM_SLOTS, **kw)
        ref_results = ref.serve([Request(**r.__dict__) for r in requests])
        del ref
        t0 = time.perf_counter()
        pre, dec = export_serving_decoder(qmodel, qparams, NUM_SLOTS,
                                          PROMPT_LEN, **kw)
        export_s = time.perf_counter() - t0
        want = {"rms_norm": 2 * n + 1, "swiglu": n, "quant_dot": per_step}
        for name, blob in (("prefill", pre), ("decode", dec)):
            ops = graph_ops(load_exported_obj(blob).graph_module)
            if ops != want:
                fail(f"export_quant ({way}): the {name} program holds {ops}, "
                     f"expected {want}")
        t0 = time.perf_counter()
        session = ServeSession.from_artifacts(pre, dec, qparams, paged=paged)
        load_s = time.perf_counter() - t0
        if paged and not session.engine.cache.quantized:
            fail("export_quant: the paged artifact session's pool is not int8")
        session.serve([Request("warm", [1, 2, 3], max_new_tokens=2)])
        _, results, wall, launches, peak = serve_run(
            torch, session, requests, {"quant_dot": quant_matmul})
        eng = session.engine
        calls = eng.num_prefills + eng.num_decode_steps - 2
        if launches != {"quant_dot": per_step * calls}:
            fail(f"export_quant ({way}): launches {launches}")
        differ = [r.request_id for r in requests
                  if results[r.request_id].tokens
                  != ref_results[r.request_id].tokens]
        if differ:
            fail(f"export_quant ({way}): the artifact session's tokens differ "
                 f"from the model session's for {differ}")
        tpot = pct([r.tpot_s * 1e3 for r in results.values()
                    if r.tpot_s is not None], 50)
        print(f"export_quant ({way}, {n} layers, {card}): export "
              f"{export_s:.2f} s (prefill {len(pre) / 1e6:.3f} MB, decode "
              f"{len(dec) / 1e6:.3f} MB, no weights), load {load_s:.2f} s; "
              f"{len(requests)} requests with the model session's tokens; "
              f"TPOT p50 {tpot:.3f} ms; peak memory {peak:.2f} GiB")
        out["paged" if paged else "dense"] = {
            "layers": n, "export_s": export_s, "load_s": load_s,
            "tpot_p50_ms": tpot, "prefill_bytes": len(pre),
            "decode_bytes": len(dec)}
        del session
        gc.collect()
    return out


def bert_quant_eval_phase(torch, card):
    """BERT-base's fused eval forward (fused_ops, attention_impl="fused")
    at BERT_BATCH x BERT_SEQ with int8 weights (quantize_model, bound with
    load_state_dict(assign=True)) against the same model in bf16: ms a
    forward each (eager), exactly BERT_QUANT_PER_FORWARD quant_dot
    launches a forward. quant_parity's rule holds the int8 model's
    weight_dtype wiring: its logits' error against an f32 oracle on the
    dequantized weights (fused_ops off, plain attention, TF32 off) may be
    no larger than its plain twin's (every QuantDense "reference": the
    dequantized bf16 product) on the same batch."""
    import dataclasses

    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BertForSequenceClassification
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.ops.quant_dot import quant_matmul
    from tpudl_torch.quant import quantize_model, weight_bytes_report

    model = build_model("bert-base", 2, fused_ops=True, attention_impl="fused")
    model.init_weights(torch.Generator(device="cuda").manual_seed(21))
    model.eval()
    batch = next(iter(synthetic_token_batches(BERT_BATCH, BERT_SEQ, 30522,
                                              num_batches=1)))
    ids = torch.as_tensor(batch["input_ids"], device="cuda")
    mask = torch.as_tensor(batch["attention_mask"], device="cuda")
    qmodel, qparams = quantize_model(model, model.state_dict(), "int8")
    qmodel.load_state_dict(qparams, strict=True, assign=True)
    qmodel.eval()
    oracle = BertForSequenceClassification(dataclasses.replace(
        qmodel.cfg, dtype=torch.float32, fused_ops=False,
        attention_impl="reference", weight_dtype=None), device="meta")
    oracle.load_state_dict(oracle_params_of(torch, qparams), strict=True,
                           assign=True)
    oracle.eval()
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = oracle(ids, mask).float()
            for name, m in (("bf16", model), ("int8", qmodel)):
                quant_matmul.launches = 0
                logits = m(ids, mask)
                torch.cuda.synchronize()
                if name == "int8" and quant_matmul.launches != \
                        BERT_QUANT_PER_FORWARD:
                    fail(f"bert_quant_eval: {quant_matmul.launches} "
                         f"quant_dot launches, expected "
                         f"{BERT_QUANT_PER_FORWARD}")
                if not bool(torch.isfinite(logits).all()):
                    fail(f"bert_quant_eval: non-finite {name} logits")
                out[name] = (logits.float(), eager_ms(lambda: m(ids, mask),
                                                      calls=5, reps=3))
            twin = quant_sites(qmodel, "reference")(ids, mask).float()
            quant_sites(qmodel, "auto")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not bool(torch.isfinite(twin).all()):
        fail("bert_quant_eval: non-finite logits on the plain twin")
    ms = {name: v[1] for name, v in out.items()}
    err = float((out["int8"][0] - out["bf16"][0]).abs().max())
    scale = float(out["bf16"][0].abs().max())
    mean_k = float((out["int8"][0] - ref).abs().mean())
    mean_p = float((twin - ref).abs().mean())
    report = weight_bytes_report(qparams)
    print(f"bert_quant_eval ({card}): BERT-base fused eval forward "
          f"[{BERT_BATCH}, {BERT_SEQ}]: bf16 {out['bf16'][1]:.2f} ms, int8 "
          f"{out['int8'][1]:.2f} ms a forward; int8 logits max |diff| from "
          f"bf16 {err:.4f} (largest logit {scale:.4f}); mean |logit - f32 "
          f"oracle on the dequantized weights| over {ref.numel()} logits: "
          f"kernel path {mean_k:.6f}, plain twin {mean_p:.6f}; "
          f"{BERT_QUANT_PER_FORWARD} quant_dot launches a forward; weights "
          f"{report['total_bytes'] / 1e6:.1f} MB (quant ratio "
          f"{report['quant_ratio']})")
    if not err <= 0.05 + 0.05 * scale:
        fail(f"bert_quant_eval: int8 logits {err:.4f} from bf16")
    if mean_k > mean_p:
        fail(f"bert_quant_eval: the kernel path's logit error {mean_k:.6f} "
             f"exceeds the plain twin's {mean_p:.6f}")
    del model, qmodel, qparams, oracle, out, ref, twin
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16_ms": ms["bf16"], "int8_ms": ms["int8"],
            "max_abs_logit_diff": err, "mean_err_kernel": mean_k,
            "mean_err_plain_twin": mean_p, "weight_bytes": report}


def expert_load(torch, model, batch):
    """Top-1 share of each expert of layer 0's router on ``batch``'s first
    LLAMA_BATCH rows (one eval forward), and the aux loss it records."""
    moe = model.model.layer_0.moe
    seen = []
    # The layer's input; its router product is F.linear on router.weight.
    hook = moe.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.nn.functional.linear(
            args[0].float(), mod.router.weight.float()).argmax(-1).flatten()))
    try:
        with torch.no_grad():
            model(torch.as_tensor(batch["input_ids"][:LLAMA_BATCH],
                                  device="cuda"),
                  torch.as_tensor(batch["attention_mask"][:LLAMA_BATCH],
                                  device="cuda"))
    finally:
        hook.remove()
    counts = torch.bincount(seen[0], minlength=moe.num_experts).float()
    return (counts / counts.sum()).tolist(), float(moe.aux_loss)


def moe_train_phase(torch, card):
    """llama3-1b-moe at full width (hidden 2048, intermediate 8192, 8
    experts, top-2, capacity 1.25) cut to MOE_LAYERS layers, every
    parameter against f32 masters under policy("bf16", bf16_moments=True),
    MOE_ACCUM microbatches of LLAMA_BATCH x LLAMA_SEQ, moe_aux_weight
    MOE_AUX_WEIGHT, loss_impl="auto": eager then captured bit for bit,
    exact launch counts (flash, norms, cross-entropy; the experts are
    einsums), the aux loss finite and > 0, the router's gradient nonzero,
    the expert load; then moe_cut_parity."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        policy,
    )

    pol = policy("bf16", bf16_moments=True)
    t0 = time.perf_counter()
    model = build_model("llama3-1b-moe", 2, fused_ops=True,
                        attention_impl="flash", num_layers=MOE_LAYERS)
    state = create_train_state(0, model, llama_optimizer(), precision=pol)
    mcfg = model.cfg
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    rows = LLAMA_BATCH * MOE_ACCUM
    batches = list(synthetic_token_batches(rows, LLAMA_SEQ, mcfg.vocab_size,
                                           num_batches=3 + MOE_STEPS))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    print(f"moe_train: llama3-1b-moe ({mcfg.num_layers} of 16 layers, hidden "
          f"{mcfg.hidden_size}, intermediate {mcfg.intermediate_size}, "
          f"{mcfg.moe_experts} experts, top-{mcfg.moe_k}, capacity factor "
          f"{mcfg.moe_capacity_factor}), {n_params / 1e9:.3f} B parameters "
          f"all trainable (f32 masters), policy('bf16', bf16_moments=True), "
          f"{MOE_ACCUM} microbatches x {LLAMA_BATCH} x seq {LLAMA_SEQ}, "
          f"moe_aux_weight {MOE_AUX_WEIGHT}; {resident:.2f} GiB resident "
          f"(state); set-up {time.perf_counter() - t0:.1f} s")
    keys = ("input_ids", "attention_mask")
    step = make_classification_train_step(
        input_keys=keys, accum_steps=MOE_ACCUM, precision=pol,
        moe_aux_weight=MOE_AUX_WEIGHT, loss_impl="auto")
    grads, m0 = step.grads_and_metrics(
        state, batches[0], [fold_in(1, a, "cuda") for a in range(MOE_ACCUM)])
    router = [k for k in grads if k.endswith("moe.router.weight")]
    if len(router) != MOE_LAYERS or not all(
            float(grads[k].abs().max()) > 0 for k in router):
        fail(f"moe_train: router gradients {[(k, float(grads[k].abs().max())) for k in router]}")
    aux = float(m0["moe_aux"])
    if not (aux > 0 and aux == aux and aux < float("inf")):
        fail(f"moe_train: aux loss {aux}")
    del grads
    load, layer0_aux = expert_load(torch, model, batches[0])
    print(f"moe_train: aux loss {aux:.4f} (sum over {MOE_LAYERS} layers; "
          f"1.0 a layer at perfect balance); layer 0's top-1 expert load "
          f"{', '.join(f'{x:.3f}' for x in load)} (its aux {layer0_aux:.4f});"
          f" every router gradient nonzero")
    tokens = rows * LLAMA_SEQ
    n = mcfg.num_layers
    per_step = {"flash_fwd": n, "flash_dq": n, "flash_dkv": n,
                "rms_norm_fwd": 2 * n + 1, "norm_bwd": 2 * n + 1,
                "xent_fwd": 1, "xent_bwd": 1}
    per_step = {k: MOE_ACCUM * v for k, v in per_step.items()}
    cap = -(-2 * LLAMA_SEQ * 1.25 // 8)
    # Model FLOPs: 6 x (attention projections + the experts' products at
    # k x capacity slots, dispatch and combine) x tokens, + attention.
    e_tok = 8 * cap / LLAMA_SEQ
    proj = sum(p.numel() for k, p in named.items()
               if k.endswith("_proj.weight"))
    expert = 3 * mcfg.hidden_size * mcfg.intermediate_size * e_tok * n
    flops = (6.0 * (proj + expert) * tokens
             + 7.0 * rows * mcfg.hidden_size * LLAMA_SEQ ** 2 * n)
    # On the host: the card holds the state, the eager run's snapshot and
    # the captured step's activations (7.7 GB more did not fit).
    init = {k: p.detach().cpu() for k, p in state.params.items()}
    metrics = llama_train_run(torch, card, "moe_train", state, step, batches,
                              tokens, flops, per_step, {}, 1, MOE_STEPS, init)
    metrics.update({"num_params": n_params, "layers": n, "aux_loss": aux,
                    "expert_load_layer0": load, "resident_gib": resident})
    del state, model, named, init
    gc.collect()
    torch.cuda.empty_cache()
    metrics["cut_parity"] = moe_cut_parity_phase(torch)
    return metrics


def moe_cut_parity_phase(torch):
    """moe_train's step held to an f32 oracle: llama3-1b-moe at full
    width cut to MOE_CUT_LAYERS layer(s), one set of weights, batches of
    LLAMA_BATCH x LLAMA_SEQ, MOE_CUT_STEPS steps at the optimizer's
    constant 1e-4: every loss of the kernel path (the phase's) within
    0.03 of the oracle's (plain, f32, no policy)."""
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.llama import LLAMA3_1B, LlamaForSequenceClassification
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        policy,
    )

    kw = dict(num_layers=MOE_CUT_LAYERS, num_labels=2, moe_experts=8)
    init = LlamaForSequenceClassification(LLAMA3_1B(**kw), device="cuda")
    init.init_weights(torch.Generator(device="cuda").manual_seed(23))
    params = {k: v.detach() for k, v in init.state_dict().items()}
    batches = list(synthetic_token_batches(
        LLAMA_BATCH, LLAMA_SEQ, init.cfg.vocab_size, seed=11,
        num_batches=MOE_CUT_STEPS))
    del init
    paths = {"kernel": (torch.bfloat16, policy("bf16", bf16_moments=True),
                        {"fused_ops": True, "attention_impl": "flash"}, "auto"),
             "oracle": (torch.float32, None, {"fused_ops": False},
                        "reference")}
    losses = {}
    for name, (dtype, prec, extra, loss_impl) in paths.items():
        model = LlamaForSequenceClassification(
            LLAMA3_1B(dtype=dtype, **kw, **extra), device="meta")
        st = create_train_state(0, model, llama_optimizer(constant=True),
                                params=params, precision=prec)
        step = make_classification_train_step(
            input_keys=("input_ids", "attention_mask"), precision=prec,
            moe_aux_weight=MOE_AUX_WEIGHT, loss_impl=loss_impl)
        losses[name] = []
        for b in batches:
            st, m = step(st, b, 1)
            losses[name].append(float(m["loss"]))
        del st, model, step
        gc.collect()
        torch.cuda.empty_cache()
    gaps = [abs(a - b) for a, b in zip(losses["kernel"], losses["oracle"])]
    print(f"moe_cut_parity: llama3-1b-moe width, {MOE_CUT_LAYERS} layer, "
          f"{LLAMA_BATCH} x {LLAMA_SEQ}, constant 1e-4: kernel losses "
          f"{', '.join(f'{x:.4f}' for x in losses['kernel'])}; f32 oracle "
          f"{', '.join(f'{x:.4f}' for x in losses['oracle'])}; largest gap "
          f"{max(gaps):.4f} (band {PRECISION_BANDS['bf16']})")
    if max(gaps) > PRECISION_BANDS["bf16"]:
        fail(f"moe_cut_parity: a loss is {max(gaps):.4f} from the oracle's")
    return {"kernel_losses": losses["kernel"],
            "oracle_losses": losses["oracle"], "max_gap": max(gaps)}


# ---------------------------------------------------------------------------
# The data layer's paths (ROADMAP queue A item 13): text -> WordPiece ->
# Parquet -> converter -> BERT-large (configs[3]), and CIFAR-10 Parquet ->
# ResNet-18 (configs[0]), as the notebooks run them, through the port.
# ---------------------------------------------------------------------------

#: train_sst2.py --text-data: 8192 raw sentences, a 4096-token vocab.
DATA_TEXT_ROWS = 8192
DATA_VOCAB = 4096
DATA_WARMUP_STEPS = 2
DATA_STEPS = 6
DATA_PROFILE_STEPS = 2
#: train_cifar10.py --materialize: CIFAR-10's train split; the ingested
#: tarball holds one batch of its test split.
CIFAR_ROWS = 50_000
CIFAR_TEST_ROWS = 10_000
CIFAR_WARMUP_STEPS = 2
CIFAR_STEPS = 8
CIFAR_PROFILE_STEPS = 2


class RecordedStep:
    """A train step that keeps each call's loss for the bitwise check and
    the Throughput meter, and passes the compiled step's compile marker
    on to fit's spans."""

    def __init__(self, step, meter):
        self.step, self.meter, self.losses = step, meter, []

    @property
    def compile_pending(self):
        return getattr(self.step, "compile_pending", False)

    def __call__(self, state, batch, rng):
        state, metrics = self.step(state, batch, rng)
        self.losses.append(metrics["loss"])
        self.meter.step(metrics["loss"])
        return state, metrics


def run_snapshot(torch, losses, state):
    """(losses, state_dict, optimizer state, step): what check_bitwise
    holds between an eager and a captured run."""
    return (torch.stack(losses).clone(),
            {k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            {k: {n: t.clone() for n, t in v.items()}
             for k, v in state.opt_state.items() if isinstance(v, dict)},
            state.step)


def goodput_check(name, records):
    """Classify a run's span records (tpudl_torch.obs.goodput); fail
    unless the categories sum to the wall clock within 1 %."""
    from tpudl_torch.obs import goodput

    cls = goodput.classify(records)
    parts = sum(cls[k] for k in ("productive_s", "eval_s", "compile_s",
                                 "data_wait_s", "metric_wait_s",
                                 "checkpoint_s", "recovery_s", "other_s",
                                 "idle_s"))
    spans = {}
    for r in records:
        if r.get("kind") == "span":
            spans[r["cat"]] = spans.get(r["cat"], 0) + 1
    print(f"{name}: {goodput.format_goodput(cls)}; spans {spans}; "
          f"categories sum to {parts:.4f} s of {cls['wall_s']:.4f} s wall")
    if not cls["wall_s"] > 0 or abs(parts - cls["wall_s"]) > 0.01 * cls[
            "wall_s"]:
        fail(f"{name}: goodput categories sum to {parts} s, the wall clock "
             f"is {cls['wall_s']} s")
    for cat in ("step", "compile", "data_wait"):
        if not spans.get(cat):
            fail(f"{name}: no {cat!r} span in the run's records {spans}")
    return cls


def print_trace_summary(name, path, steps, step_s):
    """Read the Chrome trace fit(profile_dir=) wrote back through
    summarize_trace (tpudl_torch.train.profiling), print it and the
    "profile: device us/step by kind" line, and return the summary (but
    its top ops). Fails unless it read ``steps`` steps of device events."""
    from tpudl_torch.train.profiling import format_summary, summarize_trace

    summary = summarize_trace(path)
    if summary["steps"] != steps or summary["num_events"] == 0:
        fail(f"{name}: the profile of {steps} steps read back "
             f"{summary['steps']} steps, {summary['num_events']} device "
             f"events")
    print(f"{name}: fit(profile_dir=) over {steps} captured steps "
          f"(unprofiled step {step_s * 1e3:.3f} ms), summarize_trace:\n"
          + format_summary(summary))
    print("profile: device us/step by kind: " + ", ".join(
        f"{kind} {r['ms_per_step'] * 1e3:.1f} ({100 * r['share']:.1f}%)"
        for kind, r in summary["by_category"].items()))
    return {k: v for k, v in summary.items() if k != "top_ops"}


def data_bert_large_phase(torch, card):
    """configs[3] (bert_large_v4_32) as ``train_sst2.py --config
    bert_large_v4_32 --text-data`` runs it, through the port's data
    layer: materialize_sst2_text writes DATA_TEXT_ROWS raw sentences as
    Parquet; a DATA_VOCAB-token WordPiece vocab is trained on them;
    tokenize_text_dataset writes the ids at seq 128; split_train_eval
    holds out the last file; the converter feeds the rest, shuffled with
    seed=cfg.seed, through prefetch_to_device(transform=
    normalize_sst2_batch, assembly_workers=2). BERT-large
    (fused_ops=True, attention_impl="fused", loss_impl="auto") trains at
    the config's 256 = 4 x 64, bf16 first moments, eagerly and then
    captured from the same seeded weights over the same batches: W
    warm-up steps and DATA_STEPS timed ones (counts reset just before:
    exact launches a step), losses finite, the two runs equal bit for
    bit. The captured run goes under fit with a MetricLogger (one JSONL
    line per logged step) and an active span recorder, then evaluate on
    the holdout (eager against captured within EVAL_PAD_TOL, exact
    launches); its records' goodput categories sum to the wall clock
    within 1 %. Then DATA_PROFILE_STEPS more captured steps under
    fit(profile_dir=), read back by summarize_trace."""
    import shutil
    import tempfile

    from tpudl_torch import obs
    from tpudl_torch.config import get_config
    from tpudl_torch.data.datasets import (
        eval_stream,
        materialize_sst2_text,
        normalize_sst2_batch,
        split_train_eval,
        tokenize_text_dataset,
    )
    from tpudl_torch.data.prefetch import prefetch_to_device
    from tpudl_torch.data.tokenizer import (
        WordPieceTokenizer,
        build_wordpiece_vocab,
    )
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        evaluate,
        fit,
        make_classification_eval_step,
        make_classification_train_step,
        make_optimizer,
    )
    from tpudl_torch.train.logging import MetricLogger
    from tpudl_torch.train.metrics import Throughput, transformer_train_flops

    cfg = get_config("bert_large_v4_32")
    b, seq, accum = cfg.global_batch_size, cfg.seq_len, cfg.accum_steps
    keys = ("input_ids", "attention_mask")
    root = tempfile.mkdtemp(prefix="tpudl_data_bert_large_")
    try:
        t0 = time.perf_counter()
        text = materialize_sst2_text(os.path.join(root, "text"),
                                     num_rows=DATA_TEXT_ROWS, seed=cfg.seed)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        corpus = (str(s) for batch in text.make_batch_iterator(
            1024, epochs=1, shuffle=False, drop_last=False,
            columns=("sentence",)) for s in batch["sentence"])
        tok = WordPieceTokenizer(build_wordpiece_vocab(corpus, DATA_VOCAB))
        tok.save_vocab(os.path.join(root, "vocab.txt"))
        vocab_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = tokenize_text_dataset(os.path.join(root, "text"),
                                    os.path.join(root, "ids"), tok,
                                    seq_len=seq)
        tokenize_s = time.perf_counter() - t0
        train_conv, eval_conv = split_train_eval(ids)
        if (ids.num_rows != DATA_TEXT_ROWS
                or train_conv.num_rows + eval_conv.num_rows != ids.num_rows):
            fail(f"data_bert_large: {ids.num_rows} tokenized rows, split "
                 f"{train_conv.num_rows} + {eval_conv.num_rows}")
        first = next(eval_conv.make_batch_iterator(8))
        if not (first["input_ids"].shape == (8, seq)
                and (first["input_ids"][:, 0] == tok.cls_id).all()
                and int(first["input_ids"].max()) < len(tok.vocab)):
            fail(f"data_bert_large: tokenized rows {first['input_ids'][:2]}")
        print(f"data_bert_large: materialize_sst2_text {DATA_TEXT_ROWS} rows "
              f"in {write_s:.2f} s (the writer); WordPiece vocab of "
              f"{len(tok.vocab)} tokens trained in {vocab_s:.2f} s; "
              f"tokenize_text_dataset at seq {seq} in {tokenize_s:.2f} s "
              f"({DATA_TEXT_ROWS / tokenize_s:.0f} rows/s, the tokenizer); "
              f"split_train_eval: {train_conv.num_rows} train rows in "
              f"{len(train_conv.files)} files, {eval_conv.num_rows} held "
              f"out")

        step = make_classification_train_step(
            input_keys=keys, label_key="label", accum_steps=accum,
            loss_impl="auto")
        per_step = {k: v * accum for k, v in
                    launches_per_step(24, True, seq).items()}
        w, n = DATA_WARMUP_STEPS, DATA_STEPS
        runs = {}
        for capture in (False, True):
            way = "captured" if capture else "eager"
            t0 = time.perf_counter()
            model = build_model(cfg.model, cfg.num_classes, fused_ops=True,
                                attention_impl="fused")
            state = create_train_state(cfg.seed, model,
                                       make_optimizer(cfg.optim))
            n_params = sum(p.numel() for p in model.parameters())
            run_step = compile_step(step, state) if capture else step
            recorded = RecordedStep(run_step, Throughput(b, warmup=w))
            feed = prefetch_to_device(
                train_conv.make_batch_iterator(b, epochs=None, shuffle=True,
                                               seed=cfg.seed),
                transform=normalize_sst2_batch, assembly_workers=2)
            log_dir = os.path.join(root, f"log-{way}")
            logger = MetricLogger(log_dir, tensorboard=False, stdlog=False)
            rec = obs.enable(os.path.join(root, "obs")) if capture else None
            torch.cuda.synchronize()
            print(f"data_bert_large ({way}): BERT-large, "
                  f"{n_params / 1e6:.2f} M parameters, fused_ops and the "
                  f"fused slice, global batch {b} = {accum} x {b // accum} x "
                  f"seq {seq}, AdamW with bf16 first moments; set-up "
                  f"{time.perf_counter() - t0:.1f} s")
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            state, _, _ = fit(recorded, state, feed, 1, num_steps=w,
                              log_every=1, logger=logger)
            torch.cuda.synchronize()
            reset_counts()
            state, last, _ = fit(recorded, state, feed, 1, num_steps=n,
                                 log_every=1, logger=logger)
            timed = recorded.meter.result(recorded.losses[-1])
            launches = train_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            waits = [x * 1e3 for x in feed.waits[w:]]
            feed.close()
            want = {k: per_step.get(k, 0) * n for k in launches}
            if launches != want:
                fail(f"data_bert_large ({way}): kernel launches {launches} "
                     f"!= expected {want} ({per_step} per step)")
            loss_t = torch.stack(recorded.losses)
            if not bool(torch.isfinite(loss_t).all()):
                fail(f"data_bert_large: non-finite loss in "
                     f"{loss_t.tolist()}")
            if timed["steps_measured"] != n:
                fail(f"data_bert_large: the meter timed "
                     f"{timed['steps_measured']} steps, not {n}")
            snapshot = run_snapshot(torch, recorded.losses, state)
            step_s = timed["step_ms"] / 1e3
            flops = transformer_train_flops(n_params, b * seq)
            util = flops / step_s / BF16_OPS_PER_S
            capture_s = getattr(run_step, "capture_s", None)
            print(f"data_bert_large metrics, {way} ({card}): step "
                  f"{step_s * 1e3:.2f} ms, {b / step_s:.1f} samples/s, MFU "
                  f"{100 * util:.2f}% (6ND = {flops:.3e} FLOP over "
                  f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16), peak "
                  f"memory {peak:.2f} GiB, data wait a step "
                  f"{statistics.mean(waits):.3f} ms (max {max(waits):.3f}), "
                  f"launches {launches}, losses "
                  f"{', '.join(f'{x:.4f}' for x in loss_t.tolist())}"
                  + ("" if capture_s is None
                     else f", step captured in {capture_s:.3f} s"))
            eval_step = make_classification_eval_step(input_keys=keys,
                                                      loss_impl="auto")
            if capture:
                eval_step = compile_step(eval_step, state, has_rng=False)
            stream = eval_stream(eval_conv, b, normalize_sst2_batch)
            n_eval = sum(1 for _ in stream())
            reset_counts()
            result = evaluate(eval_step, state, stream())
            ev_launches = train_counts()
            want = {k: eval_launches(24, seq).get(k, 0) * n_eval
                    for k in ev_launches}
            if ev_launches != want:
                fail(f"data_bert_large ({way}): evaluate launched "
                     f"{ev_launches}, expected {want}")
            run_s = time.perf_counter() - t_run
            logger.close()
            with open(os.path.join(log_dir, "metrics.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            if [x["step"] for x in lines] != list(range(1, w + 1)) + list(
                    range(1, n + 1)) or not all("loss" in x for x in lines):
                fail(f"data_bert_large ({way}): metrics.jsonl holds "
                     f"{[x.get('step') for x in lines]}, not one line per "
                     f"logged step")
            print(f"data_bert_large ({way}): evaluate over "
                  f"{eval_conv.num_rows} held-out rows ({n_eval} batches): "
                  f"loss {result['loss']:.6f}, accuracy "
                  f"{result['accuracy']:.4f}; metrics.jsonl {len(lines)} "
                  f"lines; the run {run_s:.1f} s")
            metrics = {
                "step_ms": step_s * 1e3, "samples_per_s": b / step_s,
                "mfu": util, "peak_memory_gib": peak, "num_params": n_params,
                "batch": b, "accum_steps": accum, "seq": seq, "steps": n,
                "data_wait_ms": waits, "capture_s": capture_s,
                "losses": loss_t.tolist(), "eval": result,
                "writer_s": write_s, "vocab_s": vocab_s,
                "tokenize_s": tokenize_s, "run_s": run_s}
            if rec is not None:
                cls = goodput_check("data_bert_large (captured)", rec.records)
                obs.disable()
                metrics["goodput"] = cls
                # After evaluate and the span records: DATA_PROFILE_STEPS
                # more captured steps under fit(profile_dir=).
                feed = prefetch_to_device(
                    train_conv.make_batch_iterator(b, epochs=None,
                                                   shuffle=True, seed=1),
                    transform=normalize_sst2_batch, assembly_workers=2)
                state, _, info = fit(run_step, state, feed, 1,
                                     num_steps=DATA_PROFILE_STEPS,
                                     profile_dir=os.path.join(root, "prof"),
                                     profile_window=(0, DATA_PROFILE_STEPS))
                feed.close()
                metrics["profile"] = print_trace_summary(
                    "data_bert_large", info["profile_trace"],
                    DATA_PROFILE_STEPS, step_s)
            runs[capture] = (launches, snapshot, metrics)
            del state, model, run_step, eval_step
            gc.collect()
            torch.cuda.empty_cache()
        check_bitwise("data_bert_large", runs[False][1], runs[True][1])
        launches, _, metrics = runs[True]
        eager = runs[False][2]
        diff = {k: abs(eager["eval"][k] - metrics["eval"][k])
                for k in metrics["eval"]}
        if not all(d <= EVAL_PAD_TOL for d in diff.values()):
            fail(f"data_bert_large: captured evaluate {metrics['eval']} vs "
                 f"eager {eager['eval']}")
        metrics["eager"] = eager
        metrics["launches_per_step"] = per_step
        return launches, metrics
    finally:
        obs.disable()
        shutil.rmtree(root, ignore_errors=True)


def write_cifar_tarball(path, images, labels):
    """A CIFAR-10 python archive holding one batch (test_batch): rows of
    3072 uint8 in CHW plane order, as the distribution pickles them."""
    import io
    import pickle
    import tarfile

    blob = pickle.dumps({
        b"batch_label": b"testing batch 1 of 1",
        b"labels": [int(x) for x in labels],
        b"data": images.transpose(0, 3, 1, 2).reshape(len(images), 3072),
        b"filenames": [f"{i}.png".encode() for i in range(len(images))]})
    with tarfile.open(path, "w:gz") as tf:
        info = tarfile.TarInfo("cifar-10-batches-py/test_batch")
        info.size = len(blob)
        tf.addfile(info, io.BytesIO(blob))


def data_cifar_resnet18_phase(torch, card):
    """configs[0] (cifar10_resnet18) as ``train_cifar10.py --materialize``
    runs it, through the port's data layer: materialize_cifar10_like
    writes CIFAR_ROWS rows (CIFAR-10's train split) as Parquet;
    ingest_cifar10 reads a CIFAR-format tarball of one CIFAR_TEST_ROWS
    batch that this phase writes (test_batch); the converter feeds the
    train rows, shuffled, through prefetch_to_device with a host
    transform of BatchAugmenter (pad 4, crop 32, flip, uint8, a seed a
    batch) and wire_cifar_batch, and device_normalize_cifar runs in the
    step. ResNet-18 (CIFAR stem) trains at 256 x 32², SGD, eagerly and
    then captured from the same seeded weights: W warm-up steps and
    CIFAR_STEPS timed ones (exact launches: one cross-entropy each way a
    step), losses finite, running statistics moved and finite, the runs
    equal bit for bit. Then evaluate over the ingested batch, eager
    against captured within EVAL_PAD_TOL; and the captured step runs
    CIFAR_PROFILE_STEPS more under fit(profile_dir=), whose Chrome trace
    summarize_trace reads back."""
    import shutil
    import tempfile

    import numpy as np

    from tpudl_torch.config import get_config
    from tpudl_torch.data.augment import BatchAugmenter
    from tpudl_torch.data.datasets import (
        device_normalize_cifar,
        eval_stream,
        materialize_cifar10_like,
        normalize_cifar_batch,
        wire_cifar_batch,
    )
    from tpudl_torch.data.ingest import ingest_cifar10
    from tpudl_torch.data.prefetch import prefetch_to_device
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        evaluate,
        fit,
        make_classification_eval_step,
        make_classification_train_step,
        make_optimizer,
    )
    from tpudl_torch.train.metrics import Throughput

    cfg = get_config("cifar10_resnet18")
    b, size = cfg.global_batch_size, cfg.image_size
    root = tempfile.mkdtemp(prefix="tpudl_data_cifar_")
    try:
        t0 = time.perf_counter()
        train_conv = materialize_cifar10_like(os.path.join(root, "train"),
                                              num_rows=CIFAR_ROWS,
                                              seed=cfg.seed)
        write_s = time.perf_counter() - t0
        rng = np.random.default_rng(cfg.seed + 1)
        test_images = rng.integers(0, 256, (CIFAR_TEST_ROWS, size, size, 3),
                                   dtype=np.uint8)
        test_labels = rng.integers(0, cfg.num_classes, CIFAR_TEST_ROWS)
        tar = os.path.join(root, "cifar-10-python.tar.gz")
        write_cifar_tarball(tar, test_images, test_labels)
        t0 = time.perf_counter()
        test_conv = ingest_cifar10(tar, os.path.join(root, "test"),
                                   split="test")
        ingest_s = time.perf_counter() - t0
        (back,) = test_conv.make_batch_iterator(CIFAR_TEST_ROWS)
        if not (np.array_equal(back["image"], test_images)
                and np.array_equal(back["label"], test_labels)):
            fail("data_cifar_resnet18: the ingested test batch is not the "
                 "tarball's images and labels")
        sample = wire_cifar_batch({"image": test_images[:64],
                                   "label": test_labels[:64]})
        norm = device_normalize_cifar()
        on_card = norm({"image": torch.as_tensor(sample["image"],
                                                 device="cuda")})["image"]
        host = normalize_cifar_batch(sample)["image"]
        norm_err = float(np.abs(on_card.cpu().numpy() - host).max())
        if not norm_err <= AUGMENT_TOL:
            fail(f"data_cifar_resnet18: device_normalize_cifar vs the host "
                 f"normalization {norm_err} (tol {AUGMENT_TOL})")
        print(f"data_cifar_resnet18: materialize_cifar10_like {CIFAR_ROWS} "
              f"rows in {write_s:.2f} s ({len(train_conv.files)} files); "
              f"ingest_cifar10 of a {CIFAR_TEST_ROWS}-row test_batch tarball "
              f"in {ingest_s:.2f} s, read back equal; device_normalize_cifar "
              f"vs host {norm_err:.1e}")

        def augment(batch):
            seed = int(batch.pop("seed"))
            return wire_cifar_batch(BatchAugmenter(
                crop=(size, size), pad=4, seed=seed, normalize=False,
                backend="native")(batch))

        def feed():
            raw = train_conv.make_batch_iterator(b, epochs=None, shuffle=True,
                                                 seed=cfg.seed)
            return prefetch_to_device(
                ({**batch, "seed": cfg.seed + i}
                 for i, batch in enumerate(raw)),
                transform=augment, assembly_workers=4)

        step = make_classification_train_step(
            cfg.label_smoothing, input_transform=norm, loss_impl="auto")
        per_step = resnet_counts(1)
        w, n = CIFAR_WARMUP_STEPS, CIFAR_STEPS
        runs = {}
        for capture in (False, True):
            way = "captured" if capture else "eager"
            model = build_model(cfg.model, cfg.num_classes, small_inputs=True)
            state = create_train_state(cfg.seed, model,
                                       make_optimizer(cfg.optim))
            n_params = sum(p.numel() for p in model.parameters())
            run_step = compile_step(step, state) if capture else step
            recorded = RecordedStep(run_step, Throughput(b, warmup=w))
            batches = feed()
            torch.cuda.reset_peak_memory_stats()
            state, _, _ = fit(recorded, state, batches, 1, num_steps=w)
            torch.cuda.synchronize()
            stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
            reset_counts()
            state, last, _ = fit(recorded, state, batches, 1, num_steps=n)
            timed = recorded.meter.result(recorded.losses[-1])
            launches = train_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            waits = [x * 1e3 for x in batches.waits[w:w + n]]
            want = {k: per_step.get(k, 0) * n for k in launches}
            if launches != want:
                fail(f"data_cifar_resnet18 ({way}): kernel launches "
                     f"{launches} != expected {want}")
            loss_t = torch.stack(recorded.losses)
            stats = state.batch_stats
            still = [k for k in stats if torch.equal(stats[k], stats0[k])]
            bad = [k for k in stats
                   if not bool(torch.isfinite(stats[k]).all())]
            if not bool(torch.isfinite(loss_t).all()) or still or bad:
                fail(f"data_cifar_resnet18: losses {loss_t.tolist()}, "
                     f"statistics that did not move {still[:3]} or are not "
                     f"finite {bad[:3]}")
            snapshot = run_snapshot(torch, recorded.losses, state)
            step_s = timed["step_ms"] / 1e3
            flops = 3.0 * model.forward_flops(size, size) * b
            util = flops / step_s / BF16_OPS_PER_S
            capture_s = getattr(run_step, "capture_s", None)
            print(f"data_cifar_resnet18 metrics, {way} ({card}): ResNet-18 "
                  f"(CIFAR stem, bf16), {n_params / 1e6:.2f} M parameters, "
                  f"batch {b} at {size}x{size}: step {step_s * 1e3:.3f} ms, "
                  f"{b / step_s:.1f} images/s, MFU {100 * util:.2f}% (3 x "
                  f"the forward's FLOPs x {b} = {flops:.4e}), peak memory "
                  f"{peak:.2f} GiB, data wait a step "
                  f"{statistics.mean(waits):.3f} ms (max {max(waits):.3f}), "
                  f"launches {launches}, losses "
                  f"{', '.join(f'{x:.4f}' for x in loss_t.tolist())}"
                  + ("" if capture_s is None
                     else f", step captured in {capture_s:.3f} s"))
            metrics = {"step_ms": step_s * 1e3, "images_per_s": b / step_s,
                       "mfu": util, "peak_memory_gib": peak,
                       "num_params": n_params, "batch": b, "steps": n,
                       "data_wait_ms": waits, "capture_s": capture_s,
                       "losses": loss_t.tolist(), "writer_s": write_s,
                       "ingest_s": ingest_s}
            eval_step = make_classification_eval_step(input_transform=norm,
                                                      loss_impl="auto")
            if capture:
                eval_step = compile_step(eval_step, state, has_rng=False)
            stream = eval_stream(test_conv, b, wire_cifar_batch)
            n_eval = sum(1 for _ in stream())
            reset_counts()
            result = evaluate(eval_step, state, stream())
            ev_launches = train_counts()
            want = {k: n_eval if k == "xent_fwd" else 0 for k in ev_launches}
            if ev_launches != want:
                fail(f"data_cifar_resnet18 ({way}): evaluate launched "
                     f"{ev_launches}, expected {want}")
            print(f"data_cifar_resnet18 ({way}): evaluate over the ingested "
                  f"batch ({n_eval} batches of {b}): loss "
                  f"{result['loss']:.6f}, accuracy {result['accuracy']:.4f}")
            metrics["eval"] = result
            # After evaluate, so both runs evaluate the same weights.
            if capture:
                prof_dir = os.path.join(root, "profile")
                state, _, info = fit(run_step, state, batches, 1,
                                     num_steps=CIFAR_PROFILE_STEPS,
                                     profile_dir=prof_dir,
                                     profile_window=(0, CIFAR_PROFILE_STEPS))
                metrics["profile"] = print_trace_summary(
                    "data_cifar_resnet18", info["profile_trace"],
                    CIFAR_PROFILE_STEPS, step_s)
            batches.close()
            runs[capture] = (launches, snapshot, metrics)
            del state, model, run_step, eval_step
            gc.collect()
            torch.cuda.empty_cache()
        check_bitwise("data_cifar_resnet18", runs[False][1], runs[True][1])
        launches, _, metrics = runs[True]
        eager = runs[False][2]
        diff = {k: abs(eager["eval"][k] - metrics["eval"][k])
                for k in metrics["eval"]}
        if not all(d <= EVAL_PAD_TOL for d in diff.values()):
            fail(f"data_cifar_resnet18: captured evaluate {metrics['eval']} "
                 f"vs eager {eager['eval']}")
        metrics["eager"] = eager
        return launches, metrics
    finally:
        shutil.rmtree(root, ignore_errors=True)


def hopper_ptxas(text):
    """ptxas -v's figures for each bf16 attention kernel on TMA and wgmma
    (the forwards ``*_fwd_kernel``, the dQ launches ``flash_dq_tma_kernel``
    and ``whole_dq_tma_kernel`` and the dK/dV kernel
    ``attn_dkv_tma_kernel``, with template arguments D, N, slots): registers at entry (the
    consumers raise theirs with setmaxnreg), spill stores and loads, and
    any wgmma serialisation warning (C7512 / C7515). Their shared memory
    is dynamic (Plan and DkvPlan in attention_hopper.cuh and
    attention_dkv.cuh), so ptxas does not see it. The same figures for
    the softmax_dropout kernels at Skv 128 (the BERT step's rows: L lanes
    a row, C runs a lane, R rows a pass), aligned path, one dtype in and
    out. And for the bf16 norm and SwiGLU forwards
    on the main paths: the rows kernel of LayerNorm at H 768 and 1024 (3
    and 4 vectors a lane, with and without the residual; in f32 at H
    1024, 8), the wide kernel of RMSNorm
    at H 4096 (2 vectors a thread, plain and residual+sum), and SwiGLU's
    1 and 2 vectors a thread. And the norm backward's instantiations on
    the main paths (MAIN_PATH_NORM_BWD_KERNELS) with its second pass
    (norm_colsum_kernel), and the quantized product's TMA + wgmma kernel
    (int8, e4m3) with its split-K sum."""
    out, current = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '[^']*?((?:flash|whole)_fwd_kernel"
                      r"|(?:flash|whole)_dq_tma_kernel|attn_dkv_tma_kernel)"
                      r"ILi(\d+)ELi(\d+)ELi(\d+)", line)
        if m:
            current = f"{m.group(1)}<D {m.group(2)}, N {m.group(3)}, slots {m.group(4)}>"
            continue
        m = re.search(r"Compiling entry function '[^']*?(softmax_dropout_(?:fwd|bwd)_kernel)"
                      r"I(13__nv_bfloat16S\d*_|ff)Li(\d+)ELi(\d+)ELi(\d+)ELb1E", line)
        if m:
            dtype = "f32" if m.group(2) == "ff" else "bf16"
            lanes, runs, rows = m.group(3), m.group(4), m.group(5)
            skv128 = (dtype, lanes) in (("bf16", "16"), ("f32", "32")) and runs == "1"
            current = (f"{m.group(1)}<{dtype}, L {lanes}, C {runs}, R {rows}>"
                       if skv128 else None)
            continue
        m = re.search(r"Compiling entry function '[^']*?(norm_fwd_(?:rows|wide)_kernel)"
                      r"I13__nv_bfloat16Li(\d)ELb([01])ELb([01])ELi(\d)E", line)
        if m:
            kind = "LayerNorm" if m.group(2) == "1" else "RMSNorm"
            variant = {("0", "0"): "plain", ("1", "0"): "residual",
                       ("1", "1"): "residual+sum"}[(m.group(3), m.group(4))]
            key = (m.group(1), kind, variant, m.group(5))
            current = (f"{m.group(1)}<bf16, {kind}, {variant}, {m.group(5)} vectors a "
                       f"thread>" if key in MAIN_PATH_NORM_KERNELS else None)
            continue
        # BERT-large's width, H 1024: the LayerNorm rows kernel at 4
        # vectors a lane in bf16 and 8 in f32.
        m = re.search(r"Compiling entry function '[^']*?(norm_fwd_rows_kernel)"
                      r"IfLi1ELb([01])ELb([01])ELi8E", line)
        if m:
            variant = {("0", "0"): "plain", ("1", "0"): "residual",
                       ("1", "1"): "residual+sum"}[(m.group(2), m.group(3))]
            current = (f"{m.group(1)}<f32, LayerNorm, {variant}, 8 vectors a "
                       f"thread>" if variant != "residual+sum" else None)
            continue
        m = re.search(r"Compiling entry function '[^']*?(norm_bwd_(?:rows|wide)_kernel)"
                      r"I(13__nv_bfloat16|f)Li([01])ELi(\d)E", line)
        if m:
            key = (m.group(1), "f32" if m.group(2) == "f" else "bf16",
                   "LayerNorm" if m.group(3) == "1" else "RMSNorm", m.group(4))
            current = (f"{key[0]}<{key[1]}, {key[2]}, {key[3]} vectors a "
                       f"{'lane' if 'rows' in key[0] else 'thread'}>"
                       if key in MAIN_PATH_NORM_BWD_KERNELS else None)
            continue
        m = re.search(r"Compiling entry function '[^']*?(norm_colsum_kernel"
                      r"|quant_split_sum_kernel)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Compiling entry function '[^']*?(quant_gemm_tma_kernel)"
                      r"ILi([01])ELi(\d+)E", line)
        if m:
            current = (f"{m.group(1)}<{'int8' if m.group(2) == '0' else 'e4m3'}, "
                       f"{m.group(3)} rows of x>")
            continue
        m = re.search(r"Compiling entry function '[^']*?(quant_gemv_mma_kernel)"
                      r"ILi([01])ELi([12])ELi(\d+)E", line)
        if m:
            current = (f"{m.group(1)}<{'int8' if m.group(2) == '0' else 'e4m3'}, "
                       f"{8 * int(m.group(3))} rows of x, tiles of {m.group(4)}>")
            continue
        m = re.search(r"Compiling entry function '[^']*?(swiglu_fwd_kernel)"
                      r"I13__nv_bfloat16Li(\d)E", line)
        if m:
            current = f"{m.group(1)}<bf16, {m.group(2)} vectors a thread>"
            continue
        if current and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            current += f": spill stores {spill.group(1)} B, loads {spill.group(2)} B"
        elif current and "Used " in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{current}, {regs} registers at entry")
            current = None
        elif re.search(r"C751[25]", line):
            out.append("wgmma serialised: " + line.strip())
    return out


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
        for line in hopper_ptxas(info["ptxas"]):
            print(f"build: {name}: {line}")

    marks = [time.perf_counter()]

    def mark(name):
        """Print the seconds since the previous mark (a phase's time)."""
        marks.append(time.perf_counter())
        print(f"phase {name}: {marks[-1] - marks[-2]:.1f} s "
              f"({marks[-1] - marks[0]:.1f} s since the build)")

    floor = launch_floor_phase(torch)
    chain = pdl_chain_check(torch)
    cases = kernel_phase(torch, F)
    quant_cases = quant_dot_kernel_phase(torch)
    mark("kernels, launch floor, pdl chain, quant_dot")
    seg_cases = seg_lora_kernel_phase(torch)
    tiny_reference_phase(torch)
    tenant_tiny_phase(torch)
    model, params, requests, results, launches, metrics = slice_phase(
        torch, card)
    mark("tiny, slice")
    parity_phase(torch, model, params, requests, results)
    mark("parity")
    serve_steps = metrics["prefills"] + metrics["decode_steps"]
    adapters, t_requests, t_results, tenant_launches, tenant_metrics = \
        tenant_slice_phase(torch, model, params, card, metrics)
    tenant_metrics["parity"] = tenant_parity_phase(
        torch, model, params, adapters, t_requests, t_results)
    tenant_steps = tenant_metrics["prefills"] + tenant_metrics["decode_steps"]
    gen_metrics = generate_chunked_phase(torch, model, params, card)
    mark("tenant_slice, tenant_parity")
    export_serving = export_llama_serving_phase(torch, model, params, card,
                                                requests)
    mark("generate_chunked, export_llama_serving")
    quant_sessions, quant_metrics = quant_slice_phase(
        torch, model, params, card, metrics, requests)
    quant_launches = quant_metrics["int8"]["launches"]["quant_dot"]
    quant_steps = (quant_metrics["int8"]["prefills"]
                   + quant_metrics["int8"]["decode_steps"])
    mark("quant_slice")
    _, kv8_metrics = quant_kv8_slice_phase(
        torch, model, params, card, metrics, requests, adapters, t_requests,
        quant_sessions["int8"])
    mark("quant_kv8_slice")
    export_quant = export_quant_phase(torch, quant_sessions, card, requests)
    mark("export_quant")
    # Free the 8B model before the training phases.
    del model, params, requests, results, adapters, t_results
    del quant_sessions
    gc.collect()
    torch.cuda.empty_cache()

    mark("free")
    train_cases = train_kernel_phase(torch, F)
    fused_cases = fused_kernel_phase(torch, F)
    llama_cases = llama_kernel_phase(torch, F)
    whole_cases = whole_attention_kernel_phase(torch, F)
    tiny_train_phase(torch)
    tiny_train_phase(torch, fused_slice=True)
    tiny_llama_train_phase(torch)
    mark("train, fused and llama kernels, tiny trains")
    state, train_launches, train_metrics = train_phase(torch, card)
    del state
    torch.cuda.empty_cache()
    train_metrics["parity"] = train_parity_phase(torch)
    state, fused_launches, fused_metrics = train_phase(torch, card,
                                                      fused_slice=True)
    del state
    torch.cuda.empty_cache()
    fused_metrics["remat_accum"] = bert_remat_accum_phase(torch)
    bert_export = export_bert_phase(torch, card)
    mark("train, train_fused, remat_accum, export_bert")
    bert_quant = bert_quant_eval_phase(torch, card)
    mark("bert_quant_eval")
    fused_metrics["parity"] = train_parity_phase(torch, fused_slice=True)
    state, launches_512, metrics_512 = train_phase(
        torch, card, fused_slice=True, batch_size=BERT_512_BATCH,
        seq=BERT_512_SEQ, name="train_512")
    del state
    torch.cuda.empty_cache()
    metrics_512["parity"] = train_parity_phase(
        torch, fused_slice=True, batch_size=BERT_512_BATCH, seq=BERT_512_SEQ,
        num_layers=2, phase="train_512_parity")
    gc.collect()
    torch.cuda.empty_cache()
    mark("train_fused_parity, train_512")
    resnet_launches, resnet_metrics = resnet50_train_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_metrics["parity"] = resnet_parity_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_export = export_resnet50_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("resnet50_train, resnet_parity, export_resnet50")
    large_launches, data_large = data_bert_large_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    cifar_launches, data_cifar = data_cifar_resnet18_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("data_bert_large, data_cifar_resnet18")
    ft_bert = ft_bert_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    ft_resnet50 = ft_resnet50_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    ft_kill = ft_kill_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("ft_bert, ft_resnet50, ft_kill")
    fp8_matmul = fp8_matmul_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_precision = train_precision_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("fp8_matmul, train_precision")
    llama_launches, llama_metrics = llama_lora_train_phase(torch, card)
    mark("llama_lora_train")
    gc.collect()
    torch.cuda.empty_cache()
    llama_fp8 = llama_fp8_lora_train_phase(
        torch, card, llama_metrics["fp8_reference_loss"])
    gc.collect()
    torch.cuda.empty_cache()
    mark("llama_fp8_lora_train")
    llama_metrics["parity"] = llama_train_parity_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    mark("llama_train_parity")
    llama1b = llama1b_full_train_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("llama1b_full_train")
    moe = moe_train_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("moe_train")
    remat_metrics = remat_captured_phase(torch, card,
                                         fused_metrics["peak_memory_gib"])
    mark("remat_captured")

    norms_cu = "tpudl_torch/ops/csrc/norms.cu"
    mlp_cu = "tpudl_torch/ops/csrc/mlp_fused.cu"
    sd_cu = "tpudl_torch/ops/csrc/softmax_dropout.cu"
    xent_cu = "tpudl_torch/ops/csrc/cross_entropy.cu"
    flash_cu = "tpudl_torch/ops/csrc/flash_attention.cu"
    whole_cu = "tpudl_torch/ops/csrc/fused_attention.cu"
    llama_step = llama_launches_per_step(32, LLAMA_ACCUM)
    seg_cu = "tpudl_torch/ops/csrc/segmented_lora.cu"
    # name -> (source, replaces, main-path launches, per step, headline case)
    table = {
        # Serving: the decode shape in bf16 (the path's dtype), without a
        # residual (the variant the library call computes).
        "rms_norm_fwd": (norms_cu, "tpudl/ops/norms.py:199",
                         launches["rms_norm_fwd"], 65, cases),
        "swiglu_fwd": (mlp_cu, "tpudl/ops/mlp_fused.py:197",
                       launches["swiglu_fwd"], 32, cases),
        # Training: the first case, the BERT-base step's own call in bf16.
        "layer_norm_fwd": (norms_cu, "tpudl/ops/norms.py:199",
                           train_launches["layer_norm_fwd"],
                           TRAIN_LAUNCHES["layer_norm_fwd"], train_cases),
        "norm_bwd": (norms_cu, "tpudl/ops/norms.py:335",
                     train_launches["norm_bwd"], TRAIN_LAUNCHES["norm_bwd"],
                     train_cases),
        "bias_gelu_fwd": (mlp_cu, "tpudl/ops/mlp_fused.py:94",
                          train_launches["bias_gelu_fwd"],
                          TRAIN_LAUNCHES["bias_gelu_fwd"], train_cases),
        "bias_gelu_bwd": (mlp_cu, "tpudl/ops/mlp_fused.py:108",
                          train_launches["bias_gelu_bwd"],
                          TRAIN_LAUNCHES["bias_gelu_bwd"], train_cases),
        # The fused slice: the first case, the train_fused step's own call
        # (softmax_dropout [256, 12, 128, 128] bf16; cross-entropy [256, 2]
        # f32); launches from the train_fused run.
        "softmax_dropout_fwd": (sd_cu, "tpudl/ops/softmax_dropout.py:168",
                                fused_launches["softmax_dropout_fwd"],
                                TRAIN_FUSED_LAUNCHES["softmax_dropout_fwd"],
                                fused_cases),
        "softmax_dropout_bwd": (sd_cu, "tpudl/ops/softmax_dropout.py:199",
                                fused_launches["softmax_dropout_bwd"],
                                TRAIN_FUSED_LAUNCHES["softmax_dropout_bwd"],
                                fused_cases),
        "xent_fwd": (xent_cu, "tpudl/ops/cross_entropy.py:173",
                     fused_launches["xent_fwd"],
                     TRAIN_FUSED_LAUNCHES["xent_fwd"], fused_cases),
        "xent_bwd": (xent_cu, "tpudl/ops/cross_entropy.py:209",
                     fused_launches["xent_bwd"],
                     TRAIN_FUSED_LAUNCHES["xent_bwd"], fused_cases),
        # The Llama LoRA slice: the first case, the Llama-3-8B step's own
        # call (SwiGLU backward [8192, 14336] bf16; flash [4, 2048, 32,
        # 128] bf16 causal); launches from the llama_lora_train run.
        "swiglu_bwd": (mlp_cu, "tpudl/ops/mlp_fused.py:207",
                       llama_launches["swiglu_bwd"],
                       llama_step["swiglu_bwd"], llama_cases),
        "flash_fwd": (flash_cu, "tpudl/ops/flash_attention.py:224",
                      llama_launches["flash_fwd"],
                      llama_step["flash_fwd"], llama_cases),
        "flash_dq": (flash_cu, "tpudl/ops/flash_attention.py:453",
                     llama_launches["flash_dq"], llama_step["flash_dq"],
                     llama_cases),
        "flash_dkv": (flash_cu, "tpudl/ops/flash_attention.py:477",
                      llama_launches["flash_dkv"],
                      llama_step["flash_dkv"], llama_cases),
        # BERT-base at seq 512: the first case, the train_512 step's own
        # call ([32, 512, 12, 64] bf16, padding mask, dropout 0.1);
        # launches from the train_512 run.
        "fused_attn_fwd": (whole_cu, "tpudl/ops/fused_attention.py:218",
                           launches_512["fused_attn_fwd"],
                           TRAIN_512_LAUNCHES["fused_attn_fwd"], whole_cases),
        "fused_attn_bwd": (whole_cu, "tpudl/ops/fused_attention.py:248",
                           launches_512["fused_attn_bwd"],
                           TRAIN_512_LAUNCHES["fused_attn_bwd"], whole_cases),
        # Multi-tenant serving: the first case, the decode step's q_proj
        # call ([4, 4096] -> 4096 bf16, f32 pages); launches per prefill
        # and decode step from the tenant_slice run.
        "seg_lora": (seg_cu, "tpudl/ops/segmented_lora.py:177",
                     tenant_launches["seg_lora"], 224, seg_cases),
    }
    kernels = []
    # The quantized product has no Pallas site (tpudl's is XLA's
    # mixed-dtype dot in tpudl/quant/dense.py): its headline is the int8
    # decode case; launches from quant_slice's int8 captured run.
    quant_rows = quant_cases["quant_dot"]
    head = next(c for c in quant_rows if c["shape"][0] == NUM_SLOTS
                and c["variant"] == "int8")
    if quant_launches != QUANT_PER_STEP * quant_steps:
        fail(f"quant_dot: {quant_launches} launches over {quant_steps} steps")
    kernels.append({
        "name": "quant_dot", "route": "cuda",
        "source": "tpudl_torch/ops/csrc/quant_dot.cu",
        "replaces": "tpudl/quant/dense.py:56",
        "launches": quant_launches, "launches_per_step": QUANT_PER_STEP,
        "kernel_launches_per_call": 1,
        "max_abs_err": max(c["max_abs_err"] for c in quant_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
        "library_ms": head["library_ms"],
        "shape": head["shape"], "dtype": head["dtype"],
        "cases": [{k: v for k, v in c.items() if k != "bound"}
                  | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                  for c in quant_rows],
    })
    for name, (source, replaces, count, per_step, where) in table.items():
        rows = where[name]
        if where is cases:
            # The serving cases, then the Llama LoRA step's.
            rows = rows + llama_cases[name]
        if where is cases:
            head = next(c for c in rows if c["shape"][0] == NUM_SLOTS
                        and c["dtype"] == "bfloat16"
                        and c["variant"] == "plain")
            if count != per_step * serve_steps:
                fail(f"{name}: {count} launches over {serve_steps} steps")
        else:
            head = rows[0]
        if where is seg_cases and count != per_step * tenant_steps:
            fail(f"{name}: {count} launches over {tenant_steps} steps")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "launches_per_step": per_step,
            # Calls count once; the whole-row backward is two launches
            # (dQ with the row term, then dK/dV).
            "kernel_launches_per_call": 2 if name == "fused_attn_bwd" else 1,
            "max_abs_err": max(c["max_abs_err"] for c in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
            "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"],
            # Backward rows: SDPA's backward alone beside library_ms (its
            # forward + backward).
            **({"library_bwd_ms": head["library_bwd_ms"]}
               if "library_bwd_ms" in head else {}),
            # Segmented LoRA: the two bmm without the page gather.
            **({"library_pregathered_ms": head["library_pregathered_ms"]}
               if "library_pregathered_ms" in head else {}),
            # The cross-entropy: the launches of resnet50_train's run too
            # (8 each way a step, one per microbatch).
            **({"launches_resnet50_train": resnet_launches[name],
                "launches_per_step_resnet50_train":
                    resnet_counts(8)[name]}
               if name in ("xent_fwd", "xent_bwd") else {}),
            # The data layer's BERT-large run (bert_large_v4_32): its
            # captured run's launches and launches a step.
            **({"launches_data_bert_large": large_launches[name],
                "launches_per_step_data_bert_large":
                    data_large["launches_per_step"][name]}
               if data_large["launches_per_step"].get(name) else {}),
            **({"launches_data_cifar_resnet18": cifar_launches[name],
                "launches_per_step_data_cifar_resnet18":
                    resnet_counts(1)[name]}
               if name in ("xent_fwd", "xent_bwd") else {}),
            # softmax_dropout: the plain softmax in f32 beside library_ms
            # (the same in the logits' dtype).
            **({"library_f32_ms": head["library_f32_ms"]}
               if "library_f32_ms" in head else {}),
            "cases": [{k: v for k, v in c.items() if k != "bound"}
                      | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                      for c in rows],
        })
    print(json.dumps({"slice": metrics, "tenant_slice": tenant_metrics,
                      "train": train_metrics,
                      "train_fused": fused_metrics, "train_512": metrics_512,
                      "resnet50_train": resnet_metrics,
                      "llama_lora_train": llama_metrics,
                      "generate_chunked": gen_metrics,
                      "export_llama_serving": export_serving,
                      "export_resnet50": resnet_export,
                      "export_bert": bert_export,
                      "remat_captured": remat_metrics,
                      "ft_bert": ft_bert, "ft_resnet50": ft_resnet50,
                      "ft_kill": ft_kill,
                      "fp8_matmul": fp8_matmul,
                      "train_precision": train_precision,
                      "llama_fp8_lora_train": llama_fp8,
                      "llama1b_full_train": llama1b,
                      "quant_slice": quant_metrics,
                      "quant_kv8_slice": kv8_metrics,
                      "export_quant": export_quant,
                      "bert_quant_eval": bert_quant, "moe_train": moe,
                      "data_bert_large": data_large,
                      "data_cifar_resnet18": data_cifar,
                      "launch_floor": floor, "pdl_chain": chain,
                      "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
