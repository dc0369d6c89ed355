"""numpy-facing wrapper over the C++ jsonl line-offset index
(jsonl_index.cpp)."""
from __future__ import annotations

import ctypes

import numpy as np

from dnn_page_vectors_tpu_torch.native import load


def index_offsets(path: str) -> np.ndarray:
    """Byte offsets (int64) of every non-blank line of `path`, equal to the
    Python scan of data/jsonl.py (``JsonlCorpus.scan_offsets``). Raises
    OSError when the file cannot be read. The C++ side allocates the
    array; it is copied into numpy and freed here."""
    lib = load()
    out = ctypes.POINTER(ctypes.c_int64)()
    n = lib.dpv_jsonl_index(path.encode("utf-8"), ctypes.byref(out))
    if n < 0:
        raise OSError(f"the native jsonl index cannot read {path}")
    try:
        if n == 0:
            return np.empty(0, dtype=np.int64)
        return np.ctypeslib.as_array(out, shape=(n,)).astype(np.int64,
                                                             copy=True)
    finally:
        if out:
            lib.dpv_free_i64(out)
