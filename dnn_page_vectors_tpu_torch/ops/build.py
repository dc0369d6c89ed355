"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
for ``sm_90a``. The library lands in ``build/torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), named by a hash of its source,
of every header under ``csrc/``, of nvcc's flags and of what ``nvcc
--version`` prints, so an edited source or header, another flag or
another nvcc rebuilds and an unchanged one is reused. A failed build raises; nothing
falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v prints each kernel's registers and spills into the build log
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: (seconds the build took, 0 when it was cached; what nvcc
# printed: registers, spills), the output kept beside the library
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


@lru_cache(maxsize=None)
def nvcc_version(nvcc: str) -> str:
    """What `nvcc --version` prints (part of the cache key)."""
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True).stdout


def source_digest(source: str, toolchain: str) -> str:
    """The cache key of `CSRC/<source>`'s library: a hash of the source,
    of every header under CSRC (names and contents, in name order), of
    NVCC_FLAGS and of `toolchain` (nvcc's --version output), so that an
    edit to a header the source includes, a changed flag or another nvcc
    rebuilds it."""
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(p for p in CSRC.rglob("*")
                         if p.suffix in (".cuh", ".h", ".hpp")):
        h.update(header.relative_to(CSRC).as_posix().encode() + b"\0")
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode() + b"\0")
    h.update(toolchain.encode())
    return h.hexdigest()[:12]


def compile_source(source: str) -> Path:
    """nvcc `csrc/<source>` into BUILD_DIR (once per cache key, see
    source_digest); returns the library's path. Raises RuntimeError with
    nvcc's output when the build fails."""
    src = CSRC / source
    nvcc = find_nvcc()
    key = source_digest(source, nvcc_version(nvcc))
    lib = BUILD_DIR / f"{src.stem}-{key}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        if source not in BUILD_INFO and log.exists():
            BUILD_INFO[source] = (0.0, log.read_text())
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{proc.stdout}\n{proc.stderr}")
    output = (proc.stdout + proc.stderr).strip()
    log.write_text(output)     # registers and spills, for a cached build
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    BUILD_INFO[source] = (time.perf_counter() - t0, output)
    return lib


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<source>` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(source)))
            _LIBS[source] = lib
        return lib
