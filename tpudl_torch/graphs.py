"""CUDA-graph capture: the port's counterpart of ``jax.jit`` for its hot
loops (tpudl_torch.train.loop.compile_step for the train and eval
steps, ``CapturedCall`` for the serving engine's prefill and decode
calls, ``KeyedGraphs`` for ``generate()``'s decode chunks).

A captured call replays every kernel of one step from one graph launch,
so the host pays one launch a step instead of one per kernel. What that
takes, and where each piece lives:

- **Static inputs.** A graph reads fixed addresses. ``StaticInputs``
  owns one device buffer per input (a batch column, a decode step's
  tokens, positions, page table ...) and copies each call's values in
  before the replay; a value of another shape or dtype raises a
  ``ValueError`` naming both, since the graph cannot take it.
- **Random draws.** Every dropout mask and kernel seed word comes from
  an explicit ``torch.Generator``. ``Graph`` registers the generators it
  is given with the capture (``CUDAGraph.register_generator_state``);
  the caller reseeds them before each replay, and the replay then draws
  what an eager call on a fresh generator of that seed draws.
- **Launch counts.** The kernel wrappers count their launches in plain
  ints (``rms_norm.launches`` ...), which a replay, running no Python,
  would leave still. ``Graph.capture`` records each counter's change
  during the capture, puts the counters back (a capture runs nothing),
  and ``Graph.replay`` adds the recorded change on every replay.
- **Failures.** A capture that fails raises; nothing falls back to the
  eager call.

Kernels must be built, and cuBLAS, cuDNN and the allocator warmed, by
an eager call before the capture: the callers run their first call
eagerly.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def launch_counters() -> List[Tuple[Any, str]]:
    """Every kernel wrapper's launch counter, as ``(function, attribute)``
    pairs."""
    from tpudl_torch.ops import (
        cross_entropy,
        flash_attention,
        fused_attention,
        mlp_fused,
        norms,
        quant_dot,
        segmented_lora,
        softmax_dropout,
    )
    # The module's name is shadowed by its function in tpudl_torch.ops.
    from tpudl_torch.ops.fp8_dot import fp8_dot

    fns = (norms.layer_norm, norms.rms_norm, norms.norm_bwd,
           mlp_fused.bias_gelu, mlp_fused.bias_gelu_bwd, mlp_fused.swiglu,
           mlp_fused.swiglu_bwd, softmax_dropout.softmax_dropout,
           softmax_dropout.softmax_dropout_bwd,
           cross_entropy.softmax_cross_entropy, cross_entropy.xent_bwd,
           fused_attention.fused_attention_fwd,
           fused_attention.fused_attention_bwd,
           segmented_lora.segmented_lora, quant_dot.quant_matmul)
    return [(fn, "launches") for fn in fns] + [
        (flash_attention.flash_attention, f"launches_{name}")
        for name in ("fwd", "dq", "dkv")] + [
        (fp8_dot, f"launches_{name}")
        for name in ("fwd", "dx", "dw")]


class Graph:
    """One captured CUDA graph, the generators its capture registered and
    the launch counts it adds on each replay. ``capture_s`` is the
    capture's wall time (instantiation included)."""

    def __init__(self, generators: Sequence[torch.Generator] = (),
                 pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.generators = list(generators)
        self.pool = pool
        self.deltas: List[Tuple[Any, str, int]] = []
        self.capture_s: Optional[float] = None

    def capture(self, fn: Callable, *args, **kwargs):
        """Capture ``fn(*args, **kwargs)``; returns its outputs, which
        every replay rewrites in place."""
        counters = launch_counters()
        before = [getattr(f, a) for f, a in counters]
        t0 = time.perf_counter()
        # Registered before the capture begins, which starts each
        # generator's in-graph offsets at zero.
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        try:
            # thread_local: the prefetcher's transfer thread pins host
            # memory and copies to the card while a step captures; in the
            # default global mode those calls invalidate the capture.
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = fn(*args, **kwargs)
        finally:
            after = [getattr(f, a) for f, a in counters]
            for (f, a), n in zip(counters, before):
                setattr(f, a, n)
        self.deltas = [(f, a, n1 - n0) for (f, a), n0, n1
                       in zip(counters, before, after) if n1 != n0]
        self.capture_s = time.perf_counter() - t0
        return out

    def replay(self) -> None:
        self.graph.replay()
        for f, a, d in self.deltas:
            setattr(f, a, getattr(f, a) + d)


def _tensors(values: Dict[Any, Any]) -> Dict[Any, torch.Tensor]:
    """``values`` (tensors, numpy arrays or numbers) as tensors, host
    values without a copy."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in values.items()}


def _signature(tensors: Dict[Any, torch.Tensor]) -> Dict[Any, tuple]:
    return {k: (tuple(t.shape), t.dtype) for k, t in tensors.items()}


class StaticInputs:
    """Device buffers a graph reads, one per key of the first ``values``
    (tensors, numpy arrays or numbers), filled from them; ``fill`` copies a
    later call's values in (asynchronously, on the current stream)."""

    def __init__(self, values: Dict[Any, Any], device: torch.device):
        self.signature = _signature(_tensors(values))
        self.bufs = {k: torch.empty(s, dtype=d, device=device)
                     for k, (s, d) in self.signature.items()}
        self.fill(values)

    def fill(self, values: Dict[Any, Any]) -> Dict[Any, torch.Tensor]:
        tensors = _tensors(values)
        got = _signature(tensors)
        if got != self.signature:
            raise ValueError(
                f"the captured graph takes inputs {_show(self.signature)}, "
                f"got {_show(got)}: a new shape or dtype needs a new capture")
        for k, t in tensors.items():
            buf = self.bufs[k]
            if buf.is_cuda and not t.is_cuda:
                # From pinned memory the copy is queued without waiting for
                # the card (a pageable one waited for the step before); the
                # host allocator keeps the pinned block until it has run.
                t = t.pin_memory()
            buf.copy_(t, non_blocking=True)
        return self.bufs


def _show(sig) -> str:
    return "{" + ", ".join(f"{k}: {list(s)} {str(d).replace('torch.', '')}"
                           for k, (s, d) in sig.items()) + "}"


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "items"):  # dicts and the pools' mappings
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _same_storage(a, b) -> bool:
    """Whether two argument trees hold the same tensors at the same
    addresses (what a captured graph baked in)."""
    la, lb = _tensor_leaves(a), _tensor_leaves(b)
    return len(la) == len(lb) and all(
        x.data_ptr() == y.data_ptr() and x.shape == y.shape
        and x.dtype == y.dtype for x, y in zip(la, lb))


class CapturedCall:
    """A serving contract of tpudl_torch.models.generate (a prefill or a
    decode step) as a CUDA graph.

    ``fn`` carries ``fn.body`` (the device work, on device or host
    arguments), ``fn.check`` (the host checks the body does not repeat),
    ``fn.static_args`` (the positions of the arguments whose tensors the
    graph reads in place: the weights, the cache, the adapter pools;
    every other argument is copied into a static buffer each call) and
    ``fn.cache_arg`` (the argument holding the cache a decode step writes
    in place, None for a prefill, whose cache is an output).

    The first call runs ``fn`` eagerly (the warm-up: kernels built,
    cuBLAS and the allocator set up); the second checks, captures the
    body with the greedy selection (``argmax`` of the f32 logits) and
    replays it; every later call checks, copies its arguments in and
    replays. A captured call returns ``(logits, cache)``: a decode step's
    cache is the cache argument itself (its tensors are written in
    place), a prefill's the graph's output buffers; the greedy tokens
    are left in ``greedy`` (None after an eager call). The logits,
    ``greedy`` and a prefill's cache are the graph's buffers: the next
    call rewrites them, so the caller reads or copies them out first. A
    static argument whose tensors moved raises."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.calls = 0
        self.graph: Optional[Graph] = None
        self.inputs: Optional[StaticInputs] = None
        self.static: Dict[int, Any] = {}
        self.outputs = None
        self.greedy: Optional[torch.Tensor] = None

    @property
    def capture_s(self) -> Optional[float]:
        return None if self.graph is None else self.graph.capture_s

    def _dynamic(self, args) -> Dict[int, Any]:
        return {i: a for i, a in enumerate(args)
                if i not in self.fn.static_args}

    def _check_static(self, args) -> None:
        for i in self.fn.static_args:
            known = self.static[i]
            if args[i] is known:
                continue
            if not _same_storage(args[i], known):
                raise ValueError(
                    f"argument {i} of the captured call holds other "
                    f"tensors than at capture (the graph reads the weights, "
                    f"the cache and the adapter pools in place)")
            self.static[i] = args[i]

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            self.greedy = None
            return self.fn(*args)
        self.fn.check(*args)
        if self.graph is None:
            self._capture(args)
        else:
            self._check_static(args)
            self.inputs.fill(self._dynamic(args))
        self.graph.replay()
        logits, cache = self.outputs
        self.greedy = self._greedy
        cache_arg = self.fn.cache_arg
        return logits, cache if cache_arg is None else args[cache_arg]

    def _capture(self, args) -> None:
        self.static = {i: args[i] for i in self.fn.static_args}
        device = _tensor_leaves(args[0])[0].device
        self.inputs = StaticInputs(self._dynamic(args), device)
        full = list(args)
        for i, buf in self.inputs.bufs.items():
            full[i] = buf

        def run():
            logits, cache = self.fn.body(*full)
            return (logits, cache), torch.argmax(logits.float(), dim=-1)

        self.graph = Graph()
        self.outputs, self._greedy = self.graph.capture(run)


class KeyedGraphs:
    """Graphs of one device keyed by static shape and structural switches
    (``generate()``'s decode chunks): per key, the first ``run`` calls
    ``fn`` eagerly, the second captures it and every call from then on
    replays. Each capture registers one generator of this object's own
    (``register_generator_state``); ``run`` hands it the caller's
    generator state before the replay and the advanced state back after,
    so a replay draws what the eager call would have drawn from the
    caller's generator, and leaves it where the eager call would."""

    def __init__(self, device: torch.device):
        self.generator = torch.Generator(device=device)
        self.graphs: Dict[Any, Tuple[Graph, Any]] = {}
        self.seen: set = set()

    def run(self, key, fn: Callable[[torch.Generator], Any],
            generator: torch.Generator):
        """``fn(generator)``'s outputs, which the key's next replay
        rewrites."""
        entry = self.graphs.get(key)
        if entry is None and key not in self.seen:
            self.seen.add(key)
            return fn(generator)
        self.generator.set_state(generator.get_state())
        if entry is None:
            graph = Graph([self.generator])
            entry = self.graphs[key] = (graph,
                                        graph.capture(fn, self.generator))
            self.generator.set_state(generator.get_state())
        graph, out = entry
        graph.replay()
        generator.set_state(self.generator.get_state())
        return out
