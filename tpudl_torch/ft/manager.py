"""AsyncCheckpointManager: full-resume-state checkpoints with a bounded
on-step stall (the port's counterpart of tpudl.ft.manager).

- ``save(step, state, rng=..., data_state=...)`` copies every leaf of
  the state to host memory synchronously (the step path's cost, plus
  back-pressure if the previous save has not committed) and hands the
  copies to a background writer thread that stages, fsyncs and
  atomically commits (tpudl_torch.ft.store / tpudl_torch.ft.writer).
  The copy is a real copy: the port's optimizer updates the parameters
  in place, so a background write of the live tensors (or of a CPU
  tensor's ``numpy()`` alias) would be torn by the next step.
- The payload round-trips FULL resume state: every parameter of the
  model (a LoRA model's frozen base too), the optimizer state (its
  device ``count``, the host mirror ``host_count``, the moments or
  traces; ``scalars`` is refilled by ``prepare_`` before every update
  and is left out), the BatchNorm running statistics, a precision
  policy's state (the loss scale, its growth count and skipped steps,
  and the fp8 amax rings; tpudl_torch.train.precision), the step, the
  training seed (``rng``, an int: each step draws from
  ``fold_seed(rng, state.step)``) and the data position — so a
  restarted run is schedule-identical to an uninterrupted one.
- ``restore`` / ``restore_full`` write IN PLACE (``copy_`` into the
  state's own parameters, buffers and optimizer tensors), so a state a
  compiled step has captured (tpudl_torch.train.loop.compile_step) keeps
  replaying correctly. Leaf shapes and dtypes are validated against the
  committed metadata FIRST, raising CheckpointShapeError with every
  offending path.
- A corrupted latest checkpoint makes ``restore_full(step=None)`` walk
  BACK to the newest committed step that loads, counting
  ``ft_corrupt_checkpoints``; an explicit step raises.

Leaf keys are ``['params']['<state_dict name>']``, ``['opt_state'][...]``,
``['step']``, ``['batch_stats'][...]`` and ``['precision'][...]`` (tpudl's
key names and dtypes: ``['precision']['loss_scale']['scale']`` f32,
``['growth_count']`` and ``['skipped']`` int32,
``['precision']['fp8']['bert']...['query']['x_hist']`` f32 rings, so
either store reads the other's precision leaves); the seed and the data
position ride ``meta.json`` (``rng: {"seed": int}``, ``data_state``).
Process 0 (``torch.distributed``'s rank, 0 without a process group) is
the sole writer. ``mesh`` / ``rules`` raise NotImplementedError (ROADMAP
queue A item 7: sharded state).
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from tpudl_torch.ft import chaos
from tpudl_torch.ft.store import (
    CheckpointCorruptError,
    CheckpointStore,
    diff_leaf_shapes,
    dtype_name,
)
from tpudl_torch.ft.writer import AsyncCheckpointWriter
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import spans as obs_spans

STEP_KEY = "['step']"
HOST_COUNT_KEY = "['opt_state']['host_count']"


def refuse_sharding(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            f"mesh={mesh!r} / rules={rules!r} are not ported to tpudl_torch "
            f"yet (ROADMAP queue A item 7 (launcher and sharding))")


def state_payload(state: Any) -> dict:
    """The serializable part of a TrainState, as tensors: the live
    parameters, statistics and optimizer tensors themselves, and 0-d
    int64 copies of the host counters."""
    opt: Dict[str, Any] = {}
    for k, v in state.opt_state.items():
        if k == "scalars":
            continue
        opt[k] = torch.tensor(v, dtype=torch.int64) if isinstance(v, int) \
            else v
    payload = {
        "params": dict(state.model.named_parameters()),
        "opt_state": opt,
        "step": torch.tensor(int(state.step), dtype=torch.int64),
    }
    stats = getattr(state, "batch_stats", None)
    if stats is not None:
        payload["batch_stats"] = stats
    precision = getattr(state, "precision", None)
    if precision is not None:
        # The live tensors: a restore copies into them, so a captured
        # step keeps reading the restored scale and rings.
        payload["precision"] = precision
    return payload


def flatten_with_keys(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key path, leaf)] of nested dicts in insertion order, keys
    spelled as ``jax.tree_util.keystr`` spells dict paths."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in tree.items():
        out += flatten_with_keys(v, f"{prefix}[{k!r}]")
    return out


def snapshot_to_host(
        leaves: List[Tuple[str, torch.Tensor]]) -> List[Tuple[str, torch.Tensor]]:
    """A host copy of every leaf, complete when this returns: the
    on-step stall. A device leaf is copied to pageable host memory (a
    blocking copy on the current stream); a CPU leaf is cloned."""
    out = []
    for key, leaf in leaves:
        t = leaf.detach()
        out.append((key, t.clone() if t.device.type == "cpu" else t.cpu()))
    return out


def validate_template(saved: "dict[str, dict]",
                      template_leaves: List[Tuple[str, torch.Tensor]]) -> None:
    """Compare saved leaf shapes AND dtypes against a restore template;
    raise CheckpointShapeError naming every mismatch."""
    diff_leaf_shapes(
        {key: tuple(spec["shape"]) for key, spec in saved.items()},
        {key: tuple(leaf.shape) for key, leaf in template_leaves},
        "checkpoint/template mismatch",
        saved_dtypes={key: spec["dtype"] for key, spec in saved.items()},
        template_dtypes={key: dtype_name(leaf.dtype)
                         for key, leaf in template_leaves})


@torch.no_grad()
def load_into(state: Any, meta: dict, tensors: Dict[str, torch.Tensor]) -> Any:
    """Validate ``tensors`` (one checkpoint's leaves) against ``state``
    and copy them into it in place; returns ``state``."""
    template = flatten_with_keys(state_payload(state))
    validate_template({leaf["key"]: leaf for leaf in meta["leaves"]},
                      template)
    for key, live in template:
        live.copy_(tensors[key])
    state.step = int(tensors[STEP_KEY])
    if HOST_COUNT_KEY in tensors:
        state.opt_state["host_count"] = int(tensors[HOST_COUNT_KEY])
    return state


def host_leaves(state: Any) -> List[Tuple[str, torch.Tensor]]:
    """The payload's leaves on the host, for a write on this thread: a
    device leaf is copied, a CPU leaf is passed as it is."""
    return [(key, leaf.detach().cpu())
            for key, leaf in flatten_with_keys(state_payload(state))]


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class AsyncCheckpointManager:
    """Step-indexed checkpoints with atomic commit and full resume state
    (see the module docstring). ``background=False`` writes each save on
    the caller's thread instead of the writer thread (what
    ``tpudl_torch.checkpoint.CheckpointManager(async_save=False)``
    does)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 background: bool = True):
        self._store = CheckpointStore(directory, max_to_keep=max_to_keep)
        self._is_writer = _process_index() == 0
        self._writer: Optional[AsyncCheckpointWriter] = None
        if self._is_writer:
            self._store.gc_stale()
            if background:
                self._writer = AsyncCheckpointWriter(self._store)

    @property
    def directory(self) -> str:
        return self._store.directory

    @property
    def store(self) -> CheckpointStore:
        return self._store

    # -- save ----------------------------------------------------------

    def save(self, step: int, state: Any, rng: Optional[int] = None,
             data_state: Optional[dict] = None, block: bool = False) -> bool:
        """Snapshot and enqueue one checkpoint (or write it, without a
        background writer). Returns False on non-writer ranks and for
        steps already committed. ``block=True`` waits for the commit."""
        if not self._is_writer:
            return False
        if self._store.is_committed(step):
            return False
        rec = obs_spans.active_recorder()
        clock = time.monotonic if rec is None else rec.clock
        t0 = clock()
        extra_meta: dict = {}
        if rng is not None:
            extra_meta["rng"] = {"seed": int(rng)}
        if data_state is not None:
            extra_meta["data_state"] = data_state
        reg = obs_counters.registry()
        waited = 0.0
        if self._writer is None:
            leaves = host_leaves(state)
            w0 = clock()
            committed = self._store.write(
                step, leaves, extra_meta=extra_meta,
                delay_hook=chaos.io_delay_hook())
            self._store.retain()
            reg.histogram("checkpoint_write_s").observe(clock() - w0)
            if committed:
                reg.counter("checkpoint_saves").inc()
        else:
            # The stall the step loop pays: the host copy (complete
            # before this returns: the next step updates the state in
            # place) and back-pressure (inside submit).
            leaves = snapshot_to_host(
                flatten_with_keys(state_payload(state)))
            waited = self._writer.submit(
                step, leaves, extra_meta=extra_meta,
                delay_hook=chaos.io_delay_hook())
        dur = clock() - t0
        reg.histogram("checkpoint_stall_s").observe(dur)
        if waited > 0:
            reg.histogram("checkpoint_backpressure_s").observe(waited)
        if rec is not None:
            # One span covers the whole stall; back-pressure rides as an
            # attribute.
            rec.record("checkpoint_save", obs_spans.CAT_CHECKPOINT, t0, dur,
                       {"step": step, "async": self._writer is not None,
                        "backpressure_s": waited})
        if block and self._writer is not None:
            self._writer.wait()
        return True

    # -- restore -------------------------------------------------------

    def restore(self, state: Any, step: Optional[int] = None, mesh=None,
                rules=None) -> Any:
        return self.restore_full(state, step=step, mesh=mesh, rules=rules)[0]

    def restore_full(self, state: Any, step: Optional[int] = None, mesh=None,
                     rules=None) -> Tuple[Any, Optional[int], Optional[dict]]:
        """Restore ``(state, rng, data_state)`` into ``state`` in place.
        ``step=None`` means the newest committed checkpoint, walking back
        past corrupt ones; an explicit step raises CheckpointCorruptError
        instead."""
        refuse_sharding(mesh, rules)
        if step is not None:
            return self._restore_one(state, step)
        steps = self._store.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint found in {self._store.directory}")
        last_err: Optional[Exception] = None
        for candidate in reversed(steps):
            try:
                return self._restore_one(state, candidate)
            except CheckpointCorruptError as e:
                obs_counters.registry().counter("ft_corrupt_checkpoints").inc()
                warnings.warn(
                    f"checkpoint step {candidate} is corrupt, falling back "
                    f"to the previous committed step: {e}", stacklevel=2)
                last_err = e
        raise CheckpointCorruptError(
            f"every committed checkpoint in {self._store.directory} failed "
            f"to load") from last_err

    def _restore_one(self, state, step):
        with obs_spans.span("checkpoint_restore", obs_spans.CAT_CHECKPOINT,
                            step=step):
            meta, tensors = self._store.read(step)
            load_into(state, meta, tensors)
        rng = meta.get("rng")
        return (state, None if rng is None else int(rng["seed"]),
                meta.get("data_state"))

    # -- bookkeeping ---------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return self._store.latest_step()

    def all_steps(self) -> List[int]:
        return self._store.all_steps()

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.wait()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()

    def __enter__(self) -> "AsyncCheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
