"""The native (C++) augmentation kernel, built with ``g++`` and loaded
with ``ctypes``: the port's counterpart of tpudl.native.

``load_library()`` compiles ``csrc/augment.cpp`` at first use,

    g++ -O3 -fPIC -shared -fopenmp -o build/tpudl_torch/libtpudl_data-<hash>.so \\
        tpudl_torch/data/csrc/augment.cpp

into the checkout's gitignored ``build/`` directory (never beside the
source); the file name carries a hash of the source and the flags, so an
edited source rebuilds. A toolchain without OpenMP (no ``libgomp``)
builds the same source without ``-fopenmp``: the pragmas drop out and the
batch runs on one thread, with the same results (``openmp()`` says
which). It returns None when the build or the load fails (the reason is
logged, and kept in ``last_error()``);
``tpudl_torch.data.augment.BatchAugmenter(backend="native")`` raises
then. Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_log = logging.getLogger("tpudl_torch.data.native")
SOURCE = Path(__file__).resolve().parent / "csrc" / "augment.cpp"
#: Gitignored build directory under the checkout root.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpudl_torch"
FLAGS = ("-O3", "-fPIC", "-shared")
OPENMP = "-fopenmp"

_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = None  # None = untried, False = failed
_error: Optional[str] = None
_openmp: Optional[bool] = None


def library_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtpudl_data-{h.hexdigest()[:16]}.so"


def _compile(out: str, flags) -> None:
    subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", out,
                    str(SOURCE)], check=True, capture_output=True, text=True,
                   timeout=120)


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename into place, so that processes
    # building at once never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        try:
            _compile(tmp, FLAGS + (OPENMP,))
        except subprocess.CalledProcessError as e:
            if "omp" not in (e.stderr or ""):
                raise
            _compile(tmp, FLAGS)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """The kernel library, built if needed; None when it cannot be built
    or loaded."""
    global _lib, _error, _openmp
    with _lock:
        if _lib is None:
            path = library_path()
            try:
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                _configure(lib)
                _lib = lib
                _openmp = _links_openmp(path)
            except (OSError, subprocess.SubprocessError) as e:
                _error = getattr(e, "stderr", None) or str(e)
                _log.warning("native augmenter unavailable: %s", _error)
                _lib = False
        return _lib or None


def last_error() -> Optional[str]:
    """Why the last ``load_library()`` returned None, if it did."""
    return _error


def openmp() -> Optional[bool]:
    """Whether the loaded library runs its batch loop on OpenMP threads
    (None before a library loaded)."""
    return _openmp


def _links_openmp(path: Path) -> bool:
    return b"GOMP_" in path.read_bytes()


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.tpudl_augment_batch.restype = None
    lib.tpudl_augment_batch.argtypes = [
        u8p, i64, i64, i64, i64, i64, i64, i64, i32p, u8p, f32p, f32p, f32p,
    ]
    lib.tpudl_crop_flip_u8.restype = None
    lib.tpudl_crop_flip_u8.argtypes = [
        u8p, i64, i64, i64, i64, i64, i64, i64, i32p, u8p, u8p,
    ]
    lib.tpudl_normalize_batch.restype = None
    lib.tpudl_normalize_batch.argtypes = [
        u8p, i64, i64, i64, i64, i64, i64, f32p, f32p, f32p,
    ]
