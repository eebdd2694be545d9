"""The weight-only quantized product: the Hopper kernel, its plain twin,
and the wrapper that dispatches between them.

``quant_matmul(x, qvalues, qscale)`` is ``y = (x @ qvalues^T) * qscale``
with f32 accumulation, the scale applied once after the contraction and
the result cast to ``x``'s dtype: tpudl's fused quantized product
(tpudl/quant/dense.py ``quant_dot``, impl "fused"), for the port's
``[out, in]`` weights. The full-precision weight never exists.

- the kernel is ``csrc/quant_dot.cu``: ``tpudl_quant_gemv`` for at most
  16 rows of x (decode; a programmatic dependent launch): for bf16 x in
  whole 16-byte vectors the tensor-core kernel on the plan of
  ``gemv_plan`` (K split over the warps of a CTA, summed in warp order),
  else the FMA kernel; and
  ``tpudl_quant_gemm`` past that (prefill, BERT): for bf16 x in whole
  16-byte vectors the TMA + ``wgmma`` kernel on the plan of
  ``gemm_plan`` (split-K where the output tiles are too few, the
  partials in an f32 workspace this wrapper allocates), else the
  ``mma.sync`` kernel. It replaces no Pallas kernel: tpudl's product is
  XLA's mixed-dtype ``dot_general``;
- ``quant_matmul_ref`` is the plain twin: ``x`` and the weights widened
  to f32, one f32 product, the scale, the cast. The CPU tests hold it to
  tpudl; ``chip_smoke.py`` holds the kernel to it. Nothing on the card's
  main path calls it.

``quant_matmul`` is the op ``tpudl::quant_dot`` (tpudl_torch.ops.library):
on a CUDA tensor the kernel (a shape it does not take raises, nothing
falls back), on a CPU tensor the plain twin, so a ``torch.export`` trace
holds it; tpudl_torch.quant.dense.quant_dot holds tpudl's ``impl`` seam
in front of it ("fused" on a CPU tensor raises there). Its gradient with respect to ``x``
(a LoRA adapter trained over a quantized base) is a plain product with
the dequantized weight; the quantized pair takes none.

``quant_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.norms import KERNEL_DTYPES, check_cuda_operand

#: Weight storage dtypes the kernel takes (csrc/quant_dot.cu ``QType``).
QTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
#: Rows of x up to which the GEMV entry point runs.
GEMV_MAX_ROWS = 16
#: The tiled kernel's grid bound on rows (65535 row tiles of 64).
GEMM_MAX_ROWS = 65535 * 64
#: The TMA kernel's tile (csrc/quant_dot.cu ``kTmaRows``, ``kTmaChannels``,
#: ``kTmaK``, which tests/test_torch_quant.py reads from the source): rows
#: of x, output channels, K a step; and the taller tile's rows of x
#: (``kTmaTallRows``), taken where its tiles alone fill the card. The split
#: policy lives in ``gemm_plan`` alone.
TMA_TILE = (128, 128, 64)
TMA_TALL_ROWS = 256
#: The H100's streaming multiprocessors; K is split while the units
#: still fit one a multiprocessor, keeping at least ``MIN_SPLIT_STEPS``
#: K steps a unit.
_SMS = 132
MIN_SPLIT_STEPS = 4
#: The tensor-core GEMV's sizes (csrc/quant_dot.cu ``kGemvTile``,
#: ``kGemvHalfTile``, ``kGemvStepK``, ``kGemvSteps``, ``kGemvMaxWarps``,
#: ``kGemvMaxTiles``, ``kGemvPad``, which tests/test_torch_quant.py reads
#: from the source): output channels a tile (16, the mma's rows, or 8
#: where the plan wants twice the tiles), K a step, steps a round (the x
#: fragments a warp holds), and the plan's bounds on warps a CTA and
#: tiles a CTA; floats of padding a row of the partials.
GEMV_TILE = 16
GEMV_HALF_TILE = 8
GEMV_STEP_K = 64
GEMV_STEPS = 4
GEMV_MAX_WARPS = 16
GEMV_MAX_TILES = 16
GEMV_PAD = 4


def gemv_plan(m: int, n: int, k: int) -> dict:
    """The tensor-core GEMV's launch plan for ``[m, k] x [n, k]^T``, ``m``
    <= 16: a pure function of the shape, so the order in which the K
    slices' f32 partials are summed, and the result's bits, depend on the
    shape alone.

    K is cut into ``ksteps`` steps of 64 and those into one run a warp
    (warp w takes steps ``[w * ksteps // warps, (w + 1) * ksteps //
    warps)``; none empty): the ``warps`` of a CTA (16, or 8 for 9-16 rows
    of x, whose fragments take twice the registers) take consecutive
    runs, summed in warp order; a run longer than ``GEMV_STEPS`` steps
    takes ``rounds``. The ``ntiles`` tiles of 16 channels are cut into
    ``groups`` of ``tiles`` so that the ``grid`` of one CTA a group is
    about one a multiprocessor (one CTA fills a multiprocessor's
    registers); where tiles of 16 would leave half the multiprocessors
    idle, a tile is ``height`` = 8 channels (twice the CTAs, each half
    the bytes and half the widening). ``nb`` is the n8 tiles of x and
    ``smem`` a CTA's bytes of partials."""
    nb = 1 if m <= 8 else 2
    ksteps = -(-k // GEMV_STEP_K)
    height = GEMV_TILE if -(-n // GEMV_TILE) * 2 > _SMS else GEMV_HALF_TILE
    ntiles = -(-n // height)
    warps = min(GEMV_MAX_WARPS // nb, ksteps)
    tiles = min(GEMV_MAX_TILES, -(-ntiles // _SMS))
    groups = -(-ntiles // tiles)
    per_warp = -(-ksteps // warps)
    return {"nb": nb, "ksteps": ksteps, "warps": warps, "height": height,
            "ntiles": ntiles, "tiles": tiles, "groups": groups,
            "grid": groups, "rounds": -(-per_warp // GEMV_STEPS),
            "smem": warps * 8 * nb * (tiles * height + GEMV_PAD) * 4}


#: The plan's entries that ``tpudl_quant_gemv`` takes, in its order (all
#: 0: the FMA kernel).
GEMV_ARGS = ("warps", "tiles", "height")


def vector_route(x: torch.Tensor, qvalues: torch.Tensor) -> bool:
    """Whether these operands take the vector kernels (the tensor-core
    GEMV at M <= 16, the TMA + ``wgmma`` product above): bf16 x whose
    rows are whole 16-byte vectors, x and the weight 16-byte aligned.
    Otherwise the FMA GEMV or the ``mma.sync`` product; the choice is by
    operand alone."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 16 == 0
            and x.data_ptr() % 16 == 0 and qvalues.data_ptr() % 16 == 0)


def gemm_plan(m: int, n: int, k: int) -> dict:
    """The TMA kernel's launch plan for ``[m, k] x [n, k]^T``: a pure
    function of the shape, so the split partials' order, and the
    result's bits, depend on the shape alone.

    The output is cut into ``tiles`` of ``rows`` rows of x (256 where
    such tiles number at least the multiprocessors, else 128) by 128
    channels. Where they are fewer than the multiprocessors, the
    ``ksteps`` steps of 64 along K are cut into ``split`` runs of ``per``
    (the last may be shorter, none empty, at least ``MIN_SPLIT_STEPS``
    each), as many as still fit one wave of one block a multiprocessor.
    A unit is one (split, tile); ``grid`` persistent blocks walk them,
    and with ``split`` > 1 the partials take ``ws`` f32 values."""
    tm, tn, tk = TMA_TILE
    ksteps = -(-k // tk)
    tall = -(-m // TMA_TALL_ROWS) * -(-n // tn) >= _SMS
    rows = TMA_TALL_ROWS if tall else tm
    tiles = -(-m // rows) * -(-n // tn)
    split = max(1, min(_SMS // tiles, ksteps // MIN_SPLIT_STEPS))
    per = -(-ksteps // split)
    split = -(-ksteps // per)
    return {"rows": rows, "ksteps": ksteps, "tiles": tiles, "split": split,
            "per": per,
            "units": tiles * split, "grid": min(tiles * split, _SMS),
            "ws": split * m * n if split > 1 else 0}


def quant_matmul_ref(x: torch.Tensor, qvalues: torch.Tensor,
                     qscale: torch.Tensor) -> torch.Tensor:
    """The plain twin of the fused form: ``(x_f32 @ q_f32^T) * scale``,
    cast to ``x``'s dtype."""
    y = torch.matmul(x.float(), qvalues.float().t())
    return (y * qscale).to(x.dtype)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("quant_dot")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tpudl_quant_gemv.argtypes = [p, p, p, p, i32, i32, i64, i32,
                                         i32, i32, i32, i32, p]
        lib.tpudl_quant_gemm.argtypes = [p, p, p, p, p, i32, i32, i64, i32,
                                         i32, i32, i32, i32, i32, p]
        for fn in (lib.tpudl_quant_gemv, lib.tpudl_quant_gemm):
            fn.restype = i32
        _lib = lib
    return _lib


def check_operands(x, qvalues, qscale) -> None:
    """Raise unless the kernel takes these operands: x f32 or bf16 on the
    card, qvalues int8 or e4m3 ``[N, K]`` contiguous with K = x's last
    dimension, qscale f32 ``[N]``, and a row count the grid holds."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"quant_dot kernel takes f32 or bf16 x, got {x.dtype}")
    if qvalues.dtype not in QTYPES:
        raise ValueError(f"quant_dot kernel takes int8 or float8_e4m3fn "
                         f"weights, got {qvalues.dtype}")
    if qvalues.dim() != 2 or qvalues.shape[1] != x.shape[-1]:
        raise ValueError(f"qvalues must be [N, K] with K = x's last dimension "
                         f"{x.shape[-1]}, got {tuple(qvalues.shape)}")
    if tuple(qscale.shape) != (qvalues.shape[0],):
        raise ValueError(f"qscale must be [{qvalues.shape[0]}], got "
                         f"{tuple(qscale.shape)}")
    check_cuda_operand(x, "x", x.device, x.dtype)
    check_cuda_operand(qvalues, "qvalues", x.device, qvalues.dtype)
    check_cuda_operand(qscale, "qscale", x.device, torch.float32)
    if not qvalues.is_contiguous():
        raise ValueError("quant_dot kernel takes contiguous qvalues")
    rows = x.numel() // max(x.shape[-1], 1)
    if rows > GEMM_MAX_ROWS:
        raise ValueError(f"quant_dot kernel takes at most {GEMM_MAX_ROWS} "
                         f"rows, got {rows}")
    if x.shape[-1] == 0 or qvalues.shape[0] == 0:
        raise ValueError("quant_dot kernel takes non-empty K and N")


def _quant_dot_cuda(x: torch.Tensor, qvalues: torch.Tensor,
                    qscale: torch.Tensor) -> torch.Tensor:
    check_operands(x, qvalues, qscale)
    n, k = qvalues.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        lib = _kernel()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common = (KERNEL_DTYPES[x.dtype], QTYPES[qvalues.dtype], stream)
        if m <= GEMV_MAX_ROWS:
            plan = (gemv_plan(m, n, k) if vector_route(x2, qvalues)
                    else dict.fromkeys(GEMV_ARGS, 0))
            code = lib.tpudl_quant_gemv(x2.data_ptr(), qvalues.data_ptr(),
                                        qscale.data_ptr(), y.data_ptr(), m, n,
                                        k, *(plan[a] for a in GEMV_ARGS),
                                        *common)
            _build.check(lib, "quant_gemv", code)
        else:
            split = per = grid = rows = 0
            ws = None
            if vector_route(x2, qvalues):
                plan = gemm_plan(m, n, k)
                split, per, grid = plan["split"], plan["per"], plan["grid"]
                rows = plan["rows"]
                if plan["ws"]:
                    ws = torch.empty(plan["ws"], dtype=torch.float32,
                                     device=x.device)
            code = lib.tpudl_quant_gemm(
                x2.data_ptr(), qvalues.data_ptr(), qscale.data_ptr(),
                y.data_ptr(), None if ws is None else ws.data_ptr(), m, n, k,
                split, per, grid, rows, *common)
            _build.check(lib, "quant_gemm", code)
        quant_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


def quant_matmul(x: torch.Tensor, qvalues: torch.Tensor,
                 qscale: torch.Tensor) -> torch.Tensor:
    """``(x @ qvalues^T) * qscale`` in ``x``'s dtype, f32 accumulation,
    through the op: the kernel on CUDA tensors, the plain twin on CPU
    tensors (tpudl_torch.quant.dense.quant_dot holds the ``impl``
    seam)."""
    return torch.ops.tpudl.quant_dot(x, qvalues, qscale)


quant_matmul.launches = 0
