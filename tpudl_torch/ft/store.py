"""On-disk checkpoint store with staging + atomic commit markers: the
port's counterpart of tpudl.ft.store, in the same on-disk format, so a
checkpoint one package writes the other's store reads.

A checkpoint either exists COMMITTED in full or it does not exist at
all, wherever a crash, preemption or injected kill lands. The protocol:

1. ``stage(step)`` hands out a private staging directory
   (``.staging-<step>-<pid>-<n>``) next to the final location;
2. the writer serializes every file into the staging dir and fsyncs;
3. a ``COMMIT`` marker is written (and fsynced) INTO the staging dir;
4. one atomic ``os.rename`` publishes the staging dir as
   ``step_<N>`` (ten digits).

``latest_step``/``all_steps`` only trust directories that carry the
marker, so a half-written directory is invisible to restore and reaped
by ``gc_stale()``. ``read`` validates payload sizes and the CRC-32
against the committed metadata and raises ``CheckpointCorruptError`` on
a truncated or bit-rotted payload, which lets the manager walk back to
the previous committed step.

Format: one ``payload.bin`` (the leaves' raw bytes, C order,
concatenated) plus ``meta.json``: ``version``, ``step``, one entry per
leaf (``key``, ``shape``, ``dtype``, ``offset``, ``nbytes``),
``payload_crc32`` and the non-array resume state. A leaf is a torch
tensor or a numpy array. Dtypes are numpy's names; ``bfloat16`` leaves
are their raw 16-bit words, written from and read into
``torch.bfloat16`` tensors, so neither direction needs ``ml_dtypes``.
``read`` returns CPU tensors. Stdlib, numpy and torch; no device work.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

COMMIT_MARKER = "COMMIT"
PAYLOAD_FILE = "payload.bin"
META_FILE = "meta.json"
FORMAT_VERSION = 1

_STEP_PREFIX = "step_"
_STAGING_PREFIX = ".staging-"

#: torch dtype -> the numpy name meta.json records (tpudl's names).
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.uint16: "uint16", torch.uint32: "uint32", torch.uint64: "uint64",
    # Quantized e4m3 weights (tpudl_torch.quant): ml_dtypes' name, raw
    # 8-bit words on both sides, like bfloat16.
    torch.float8_e4m3fn: "float8_e4m3fn",
}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed validation (truncated payload,
    checksum mismatch, unparseable metadata)."""


class CheckpointShapeError(ValueError):
    """The restore template's leaf shapes or dtypes do not match the
    checkpoint: a changed model, reported with every offending path."""


def dtype_name(dtype: torch.dtype) -> str:
    """The meta.json name of a torch dtype ("float32", "bfloat16", ...)."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype name for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise CheckpointCorruptError(
            f"unknown leaf dtype {name!r} in checkpoint metadata") from None


def diff_leaf_shapes(
    saved_shapes: "dict[str, tuple]",
    template_shapes: "dict[str, tuple]",
    context: str,
    saved_dtypes: "Optional[dict]" = None,
    template_dtypes: "Optional[dict]" = None,
) -> None:
    """Compare saved leaf shapes (and, when both sides give them, dtypes)
    against a restore template's and raise CheckpointShapeError naming
    EVERY mismatch."""
    problems = []
    saved_keys = set(saved_shapes)
    for key, have in template_shapes.items():
        if key not in saved_shapes:
            problems.append(f"  {key}: not present in checkpoint")
            continue
        saved_keys.discard(key)
        want = tuple(saved_shapes[key])
        if want != tuple(have):
            problems.append(
                f"  {key}: checkpoint has shape {want}, restore "
                f"template has {tuple(have)}")
        elif (saved_dtypes is not None and template_dtypes is not None
              and key in saved_dtypes and key in template_dtypes
              and str(saved_dtypes[key]) != str(template_dtypes[key])):
            problems.append(
                f"  {key}: checkpoint has dtype {saved_dtypes[key]}, "
                f"restore template has {template_dtypes[key]}")
    for key in sorted(saved_keys):
        problems.append(f"  {key}: present in checkpoint only")
    if problems:
        raise CheckpointShapeError(
            f"{context} (did the model change?):\n" + "\n".join(problems))


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _leaf_bytes(leaf) -> Tuple[list, str, np.ndarray]:
    """(shape, dtype name, the leaf's C-order bytes as a uint8 array that
    aliases a CPU leaf: no copy)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            raise ValueError("the store writes host tensors; snapshot the "
                             "leaf to the CPU first")
        t = t.contiguous()
        flat = t.reshape(-1)
        if flat.numel():
            flat = flat.view(torch.uint8)
        else:
            flat = torch.empty(0, dtype=torch.uint8)
        return list(t.shape), dtype_name(t.dtype), flat.numpy()
    # NOT ascontiguousarray: it promotes 0-d scalars to shape (1,).
    arr = np.asarray(leaf, order="C")
    return list(arr.shape), str(arr.dtype), arr.reshape(-1).view(np.uint8)


class CheckpointStore:
    """Step-indexed atomic checkpoint directory (see module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # -- layout --------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step:010d}")

    def is_committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.step_dir(step), COMMIT_MARKER))

    def all_steps(self) -> List[int]:
        """Committed steps, ascending. Uncommitted/staging dirs are
        invisible by construction."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        steps = []
        for name in names:
            if not name.startswith(_STEP_PREFIX):
                continue
            try:
                step = int(name[len(_STEP_PREFIX):])
            except ValueError:
                continue
            if os.path.exists(os.path.join(self.directory, name,
                                           COMMIT_MARKER)):
                steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- write protocol ------------------------------------------------

    def stage(self, step: int) -> str:
        """Create and return a private staging directory for ``step``."""
        return tempfile.mkdtemp(
            prefix=f"{_STAGING_PREFIX}{step}-{os.getpid()}-",
            dir=self.directory)

    def commit(self, step: int, staged_dir: str) -> bool:
        """Atomically publish ``staged_dir`` as the committed checkpoint
        for ``step``. Returns False (and discards the staging dir) if a
        committed checkpoint for the step already exists."""
        final = self.step_dir(step)
        if self.is_committed(step):
            _rmtree(staged_dir)
            return False
        # fsync the payload files, then the marker, then the rename: the
        # marker reaching the disk before the data would defeat it.
        for name in os.listdir(staged_dir):
            _fsync_file(os.path.join(staged_dir, name))
        with open(os.path.join(staged_dir, COMMIT_MARKER), "w") as f:
            json.dump({"step": step}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            # A crash leftover with the final name but no marker: reap it
            # so the rename lands.
            _rmtree(final)
        os.rename(staged_dir, final)
        _fsync_dir(self.directory)
        return True

    def retain(self) -> List[int]:
        """Drop the oldest committed checkpoints beyond ``max_to_keep``;
        returns the steps removed."""
        steps = self.all_steps()
        removed = []
        while self.max_to_keep and len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            _rmtree(self.step_dir(victim))
            removed.append(victim)
        return removed

    def gc_stale(self) -> List[str]:
        """Reap leftover staging dirs and uncommitted step dirs (crash
        debris). Safe only when this process is the sole writer — the
        manager calls it once at construction."""
        reaped = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(_STAGING_PREFIX) or (
                    name.startswith(_STEP_PREFIX)
                    and not os.path.exists(os.path.join(path, COMMIT_MARKER))):
                _rmtree(path)
                reaped.append(path)
        return reaped

    def delete(self, step: int) -> None:
        _rmtree(self.step_dir(step))

    # -- payload serialization ----------------------------------------

    def write(self, step: int, leaves: "List[tuple]",
              extra_meta: Optional[dict] = None, delay_hook=None) -> bool:
        """Serialize ``leaves`` ([(key, CPU tensor or np.ndarray), ...])
        and the metadata to a staging dir and commit. ``delay_hook``
        (the chaos IO delay) runs after staging is created, before bytes
        land."""
        staged = self.stage(step)
        try:
            if delay_hook is not None:
                delay_hook()
            meta = {"version": FORMAT_VERSION, "step": step, "leaves": []}
            if extra_meta:
                meta.update(extra_meta)
            offset = 0
            crc = 0
            with open(os.path.join(staged, PAYLOAD_FILE), "wb") as f:
                for key, leaf in leaves:
                    shape, dtype, buf = _leaf_bytes(leaf)
                    f.write(buf.data)
                    crc = zlib.crc32(buf, crc)
                    meta["leaves"].append({
                        "key": key, "shape": shape, "dtype": dtype,
                        "offset": offset, "nbytes": int(buf.nbytes)})
                    offset += int(buf.nbytes)
            meta["payload_crc32"] = crc
            with open(os.path.join(staged, META_FILE), "w") as f:
                json.dump(meta, f)
            return self.commit(step, staged)
        except BaseException:
            _rmtree(staged)
            raise

    def read_meta(self, step: int) -> dict:
        """Committed metadata for ``step`` (raises CheckpointCorruptError
        on unreadable metadata, FileNotFoundError when the step is not
        committed)."""
        if not self.is_committed(step):
            raise FileNotFoundError(
                f"no committed checkpoint for step {step} in "
                f"{self.directory}")
        meta_path = os.path.join(self.step_dir(step), META_FILE)
        try:
            with open(meta_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: unreadable metadata "
                f"({meta_path}): {e}") from e

    def read(self, step: int) -> "tuple[dict, dict]":
        """Load a committed checkpoint: ``(meta, tensors)`` with
        ``tensors`` mapping leaf key -> CPU tensor. The payload's size
        and checksum are validated first, so a truncated or bit-rotted
        file raises CheckpointCorruptError."""
        meta = self.read_meta(step)
        payload_path = os.path.join(self.step_dir(step), PAYLOAD_FILE)
        try:
            size = os.path.getsize(payload_path)
        except OSError as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: missing payload "
                f"({payload_path}): {e}") from e
        expected = max((leaf["offset"] + leaf["nbytes"]
                        for leaf in meta["leaves"]), default=0)
        if size < expected:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: payload truncated ({size} bytes "
                f"on disk, metadata expects {expected})")
        blob = bytearray(expected)
        with open(payload_path, "rb") as f:
            f.readinto(blob)
        want_crc = meta.get("payload_crc32")
        if want_crc is not None and zlib.crc32(blob) != want_crc:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: payload checksum mismatch — "
                f"in-place corruption (bit rot / partial overwrite)")
        tensors = {}
        for leaf in meta["leaves"]:
            dtype = torch_dtype(leaf["dtype"])
            offset, nbytes = leaf["offset"], leaf["nbytes"]
            if nbytes == 0:
                t = torch.empty(leaf["shape"], dtype=dtype)
            else:
                raw = blob if offset % dtype.itemsize == 0 else \
                    bytearray(blob[offset:offset + nbytes])
                t = torch.frombuffer(
                    raw, dtype=dtype, count=nbytes // dtype.itemsize,
                    offset=offset if raw is blob else 0,
                ).reshape(leaf["shape"])
            tensors[leaf["key"]] = t
        return meta, tensors


def _rmtree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
