"""The port's C++ host library: the trigram hash, the jsonl line index and
the greedy subword encoder (``trigram_hash.cpp``, ``jsonl_index.cpp``,
``bpe_encode.cpp``, ``unicode_util.h``), bound with ``ctypes``.

The three sources compile with ``g++ -O3 -shared -fPIC -std=c++17`` into
one library on first use (``load``), never at import. It lands in
``build/torch_native/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources, the header, the flags and
what ``g++ --version`` prints, so an edit or another compiler rebuilds
and an unchanged tree reuses it. Each process compiles into a name of its
own and moves the result into place with ``os.replace``, so processes that
build at once leave one whole library. A failed build raises: nothing
falls back to the Python encoders, which run only where a caller asks for
them (``use_native=False``).

``ctypes.CDLL`` releases the GIL for the length of each call, so the
tokenizer worker pool (data/loader.py) runs the encoders on several host
cores at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_DIR = Path(__file__).resolve().parent
SOURCES = ("trigram_hash.cpp", "jsonl_index.cpp", "bpe_encode.cpp")
HEADERS = ("unicode_util.h",)
BUILD_DIR = _DIR.parents[1] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# seconds this process's build took (0.0: the library was there already)
BUILD_INFO: Dict[str, float] = {}


def compiler_version(cxx: str) -> str:
    """What `cxx --version` prints (part of the cache key); raises
    RuntimeError when the compiler cannot run."""
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True, check=False)
    except OSError as e:
        raise RuntimeError(f"the C++ compiler {cxx!r} cannot run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"`{cxx} --version` failed ({proc.returncode}): "
                           f"{proc.stderr.strip()}")
    return proc.stdout


def library_key(cxx: str) -> str:
    """The cache key: a hash of every source and header (names and
    contents), of the flags and of the compiler's --version."""
    h = hashlib.sha1()
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (_DIR / name).read_bytes() + b"\0")
    h.update("\0".join((cxx,) + CXX_FLAGS).encode() + b"\0")
    h.update(compiler_version(cxx).encode())
    return h.hexdigest()[:12]


def build() -> Path:
    """Compiles the library into BUILD_DIR unless a library of the same key
    is there; returns its path. Raises RuntimeError with the compiler's
    output when the build fails."""
    lib = BUILD_DIR / f"libdpv_torch_native-{library_key(CXX)}.so"
    if lib.exists():
        # a build earlier in this process keeps its seconds
        BUILD_INFO.setdefault("seconds", 0.0)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native host library failed to build "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dpv_encode_trigrams.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p]
    lib.dpv_encode_trigrams.restype = None
    lib.dpv_encode_trigrams_batch.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p]
    lib.dpv_encode_trigrams_batch.restype = None
    lib.dpv_jsonl_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64p)]
    lib.dpv_jsonl_index.restype = ctypes.c_int64
    lib.dpv_free_i64.argtypes = [i64p]
    lib.dpv_free_i64.restype = None
    lib.dpv_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p,
                                ctypes.c_int64]
    lib.dpv_bpe_new.restype = ctypes.c_void_p
    lib.dpv_bpe_free.argtypes = [ctypes.c_void_p]
    lib.dpv_bpe_free.restype = None
    lib.dpv_bpe_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, i32p]
    lib.dpv_bpe_encode_batch.restype = None
    lib.dpv_bpe_encode_jsonl_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.POINTER(ctypes.c_int8)]
    lib.dpv_bpe_encode_jsonl_batch.restype = None
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on the first call of the process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB
