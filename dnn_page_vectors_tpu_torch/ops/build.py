"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
for ``sm_90a``. The library lands in ``build/torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), named by a hash of its source,
so an edited source rebuilds and an unchanged one is reused. A failed build
raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: (seconds the build took, what nvcc printed: registers, spills)
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda): the port's CUDA kernels are built from source on "
        "first use")


def compile_source(source: str) -> Path:
    """nvcc `csrc/<source>` into BUILD_DIR (once per source content);
    returns the library's path. Raises RuntimeError with nvcc's output
    when the build fails."""
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    BUILD_INFO[source] = (time.perf_counter() - t0,
                          (proc.stdout + proc.stderr).strip())
    return lib


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<source>` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(source)))
            _LIBS[source] = lib
        return lib
