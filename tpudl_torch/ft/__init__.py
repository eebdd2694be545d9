"""tpudl_torch.ft — fault tolerance: async checkpointing, preemption
handling, supervised restart and fault injection (the port's
counterpart of tpudl.ft, in tpudl's on-disk format).

- ``tpudl_torch.ft.store``      — staging + atomic-commit checkpoint
  layout (a checkpoint is committed in full or invisible);
- ``tpudl_torch.ft.writer``     — background writer thread: the step
  path pays only the host snapshot + back-pressure, never the IO;
- ``tpudl_torch.ft.manager``    — AsyncCheckpointManager: FULL resume
  state (step, RNG seed, data position), restored in place, with
  corruption fallback and clear shape-mismatch errors;
- ``tpudl_torch.ft.preemption`` — SIGTERM/SIGINT grace-window protocol:
  cooperative emergency checkpoint, hard-exit watchdog;
- ``tpudl_torch.ft.supervisor`` — Supervisor: restart with exponential
  backoff under a retry budget, plus ``resume_run``, the
  resume-idempotent payload prologue;
- ``tpudl_torch.ft.data``       — ResumableIterator: checkpointable
  (epoch, offset) data position;
- ``tpudl_torch.ft.chaos``      — fault injection (worker kills,
  checkpoint truncation, IO delay).

Attributes resolve lazily (PEP 562): ``tpudl_torch.train.loop`` imports
the preemption flag on its hot path without the rest.
"""

from __future__ import annotations

_EXPORTS = {
    "AsyncCheckpointManager": ("tpudl_torch.ft.manager", "AsyncCheckpointManager"),
    "CheckpointStore": ("tpudl_torch.ft.store", "CheckpointStore"),
    "CheckpointCorruptError": ("tpudl_torch.ft.store", "CheckpointCorruptError"),
    "CheckpointShapeError": ("tpudl_torch.ft.store", "CheckpointShapeError"),
    "AsyncCheckpointWriter": ("tpudl_torch.ft.writer", "AsyncCheckpointWriter"),
    "PreemptionGuard": ("tpudl_torch.ft.preemption", "PreemptionGuard"),
    "Supervisor": ("tpudl_torch.ft.supervisor", "Supervisor"),
    "SupervisorGaveUp": ("tpudl_torch.ft.supervisor", "SupervisorGaveUp"),
    "RestartPolicy": ("tpudl_torch.ft.supervisor", "RestartPolicy"),
    "resume_run": ("tpudl_torch.ft.supervisor", "resume_run"),
    "ResumableIterator": ("tpudl_torch.ft.data", "ResumableIterator"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'tpudl_torch.ft' has no attribute {name!r}"
        ) from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
