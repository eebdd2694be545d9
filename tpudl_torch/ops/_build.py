"""Build and load the hand-written Hopper kernels under ``csrc/``.

The port's counterpart of tpudl.ops.pallas_utils in role: the one place
that knows how a kernel gets from source to a launch. Each
``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use, on the machine with the card, by ``nvcc`` into its own shared
library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/tpudl_torch/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. The file name carries a hash of the source,
the shared headers and the flags, so an edited kernel rebuilds and an
unchanged one is loaded as built. Several sources build in parallel
(one ``nvcc`` each, all started together). Any build error raises with
the compiler's output; there is no fallback.

Nothing here runs at import: the CPU-only test machines import every
module of the port and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
#: Gitignored build directory under the checkout root.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpudl_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, on stderr.
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel library name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the Hopper "
        "kernels are compiled from source on the machine with the card"
    )


def library_path(name: str) -> Path:
    """Where ``name``'s library lives once built (content-addressed)."""
    src = sources()[name]
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernel libraries (default: all) that are not
    built yet, all ``nvcc`` processes at once. Returns
    ``{name: {"path", "seconds", "ptxas"}}``; ``seconds`` is 0.0 and
    ``ptxas`` empty for a library that was already built."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no kernel source for {unknown} in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = {}
    nvcc = None
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0, "ptxas": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(srcs[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                            f"{stdout}{stderr}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target), "seconds": seconds,
                     "ptxas": stderr}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code (its
    ``cudaGetLastError()``)."""
    if code != 0:
        lib.tpudl_cuda_error_string.restype = ctypes.c_char_p
        lib.tpudl_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.tpudl_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
