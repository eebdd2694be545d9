"""Train-state checkpoint / resume: the port's counterpart of
tpudl.checkpoint.

tpudl writes its default mode through Orbax, which does not exist on a
PyTorch machine. Here both modes write the fault-tolerance store
(tpudl_torch.ft.store: staging, fsync, a COMMIT marker, one rename to
``step_<N>``), the format tpudl's ``async_save=True`` mode writes:

- ``CheckpointManager(directory, max_to_keep, async_save)``:
  step-indexed checkpoints with retention. ``async_save=True`` is
  tpudl_torch.ft.AsyncCheckpointManager (a host snapshot on the step
  path, the write on a background thread); ``async_save=False`` writes
  the same store on the caller's thread. Both carry full resume state
  when ``save`` is given ``rng`` / ``data_state``, ``restore_full``
  returns them, and both restore IN PLACE (the state object, its
  parameters, buffers and optimizer tensors stay the same objects).
- ``save_train_state`` / ``restore_train_state``: one-shot full-state
  checkpoints. A save writes one committed store directory beside
  ``path`` (``<path>.tpudl-staging``) and publishes it with two renames
  (old -> ``<path>.tpudl-prev``, staging -> ``<path>``), so a crash
  leaves the old checkpoint, the new one, or — between the renames —
  the old one under the ``.tpudl-prev`` name, which the restore falls
  back to.

``mesh`` / ``rules`` (sharded restore) raise NotImplementedError naming
ROADMAP queue A item 7.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Any, List, Optional, Tuple

from tpudl_torch.ft.manager import (
    AsyncCheckpointManager,
    host_leaves,
    load_into,
    refuse_sharding,
)
from tpudl_torch.ft.store import CheckpointShapeError  # noqa: F401  (re-export)
from tpudl_torch.ft.store import CheckpointStore
from tpudl_torch.obs import spans as obs_spans

_STAGE_SUFFIX = ".tpudl-staging"
_PREV_SUFFIX = ".tpudl-prev"


def save_train_state(path: str, state: Any, overwrite: bool = True) -> None:
    """One-shot full-train-state checkpoint at ``path``: a store
    directory holding one committed step (the state's), published through
    the staging / prev renames (see the module docstring)."""
    path = os.path.abspath(path)
    staging = path + _STAGE_SUFFIX
    prev = path + _PREV_SUFFIX
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"checkpoint exists at {path}")
    with obs_spans.span("save_train_state", obs_spans.CAT_CHECKPOINT):
        # Stale staging debris from an earlier crash must not block this
        # save.
        shutil.rmtree(staging, ignore_errors=True)
        CheckpointStore(staging, max_to_keep=0).write(
            int(state.step), host_leaves(state))
        if os.path.exists(path):
            shutil.rmtree(prev, ignore_errors=True)
            os.rename(path, prev)
        # If only a .tpudl-prev survives (a PREVIOUS save crashed
        # mid-publish), it is the sole restorable checkpoint: it must
        # outlive the publish rename below.
        os.rename(staging, path)
        shutil.rmtree(prev, ignore_errors=True)


def restore_train_state(path: str, state: Any, mesh=None, rules=None) -> Any:
    """Restore a ``save_train_state`` checkpoint into ``state`` (a fresh
    TrainState from the same model and optimizer code) in place, and
    return it. If ``path`` is missing but a ``.tpudl-prev`` sibling exists
    (a save crashed mid-publish), the previous checkpoint restores with a
    warning."""
    refuse_sharding(mesh, rules)
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + _PREV_SUFFIX):
        warnings.warn(
            f"checkpoint {path} missing but a previous committed copy "
            f"exists ({path + _PREV_SUFFIX}) — a save crashed "
            f"mid-publish; restoring the previous checkpoint", stacklevel=2)
        path = path + _PREV_SUFFIX
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    store = CheckpointStore(path)
    step = store.latest_step()
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {path}")
    with obs_spans.span("restore_train_state", obs_spans.CAT_CHECKPOINT):
        meta, tensors = store.read(step)
        return load_into(state, meta, tensors)


class CheckpointManager:
    """Step-indexed checkpoints with retention — the periodic-save side of
    fail-fast-then-resume. ``fit`` works the same against both modes
    (see the module docstring); ``close()`` / the context manager's exit
    drains pending writes."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self._impl = AsyncCheckpointManager(directory, max_to_keep=max_to_keep,
                                            background=async_save)
        self.directory = self._impl.directory

    def save(self, step: int, state: Any, rng: Optional[int] = None,
             data_state: Optional[dict] = None) -> bool:
        # Both modes copy the state to the host before save() returns, so
        # fit's next in-place step cannot tear the checkpoint.
        return self._impl.save(step, state, rng=rng, data_state=data_state)

    def restore(self, state: Any, step: Optional[int] = None, mesh=None,
                rules=None) -> Any:
        return self._impl.restore(state, step=step, mesh=mesh, rules=rules)

    def restore_full(self, state: Any, step: Optional[int] = None, mesh=None,
                     rules=None) -> Tuple[Any, Optional[int], Optional[dict]]:
        """Restore ``(state, rng, data_state)``: the training seed and the
        data position saved beside the state (None each when the save
        was not given them)."""
        return self._impl.restore_full(state, step=step, mesh=mesh,
                                       rules=rules)

    def latest_step(self) -> Optional[int]:
        return self._impl.latest_step()

    def all_steps(self) -> List[int]:
        return self._impl.all_steps()

    def wait_until_finished(self) -> None:
        self._impl.wait_until_finished()

    def close(self) -> None:
        self._impl.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
