"""Real-corpus reader: a jsonl file of {"query": ..., "page": ...} records,
one a line. The record id is the line's number among the non-blank lines,
so every pipeline that takes a ToyCorpus runs unchanged on it (page i's
gold query is record i's "query").

Memory: one pass at start builds an int64 line-offset index (8 bytes a
record); records are read on demand, so host memory stays O(batch)
whatever the corpus's size. The index comes from the C++ scan
(native/jsonl_index.cpp) unless the caller asks for the Python scan
(``use_native=False``); a failed build or read raises.

Reads go through ``os.pread`` on one descriptor: it keeps no file
position, so the tokenizer workers and the prefetch producer read at
once without a handle each, and it drops the GIL for the syscall. A run
of consecutive records (the bulk embed's batches) is one read, split at
the index's offsets; scattered records (the shuffled train batches) are
one read each of exactly the record's bytes, where a seek and a
buffered readline would read a whole buffer per record. Either way a
record is its line up to and including its newline, as ``readline``
returns it.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


class JsonlCorpus:
    # reads drop the GIL (pread, and the C++ encoders after them), so
    # tokenizer worker threads overlap (data/loader.py read_workers)
    threaded_reads = True

    def __init__(self, path: str, use_native: bool = True):
        self.path = os.path.abspath(path)
        self.native_index = use_native
        if use_native:
            from dnn_page_vectors_tpu_torch.native import jsonl_native
            offsets = jsonl_native.index_offsets(self.path)
        else:
            offsets = self.scan_offsets(self.path)
        if offsets.size == 0:
            raise ValueError(f"empty corpus: {path}")
        self._offsets = offsets
        self._fd = os.open(self.path, os.O_RDONLY)
        st = os.fstat(self._fd)
        # where each record's bytes end: the next record's start (blank
        # lines between are cut off at read), the file's end for the last
        self._ends = np.append(offsets[1:], st.st_size).astype(np.int64)
        self._fingerprint = (f"jsonl:{self.path}:{st.st_size}:"
                             f"{st.st_mtime_ns}:{len(offsets)}")

    def close(self) -> None:
        fd, self._fd = getattr(self, "_fd", None), None
        if fd is not None:
            os.close(fd)

    def __del__(self):
        self.close()

    @staticmethod
    def scan_offsets(path: str) -> np.ndarray:
        """The plain scan: the byte offset of every line that holds a
        non-whitespace byte."""
        offsets = []
        with open(path, "rb") as f:
            pos = 0
            for line in f:
                if line.strip():
                    offsets.append(pos)
                pos += len(line)
        return np.asarray(offsets, dtype=np.int64)

    @property
    def offsets(self) -> np.ndarray:
        return self._offsets

    def fingerprint(self) -> str:
        """Stable identity for the tokenizer cache's provenance."""
        return self._fingerprint

    def _lines(self, ids) -> List[bytes]:
        """The raw lines of records `ids` (each up to and including its
        newline), in order."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return []
        starts, ends = self._offsets[ids], self._ends[ids]
        if ids[-1] - ids[0] == ids.size - 1 and (
                ids.size == 1 or (np.diff(ids) == 1).all()):
            lo = int(starts[0])
            blob = os.pread(self._fd, int(ends[-1]) - lo, lo)
            chunks = [blob[a:b] for a, b in zip((starts - lo).tolist(),
                                                (ends - lo).tolist())]
        else:
            chunks = [os.pread(self._fd, b - a, a)
                      for a, b in zip(starts.tolist(), ends.tolist())]
        return [_first_line(c) for c in chunks]

    def _record(self, i: int) -> dict:
        return json.loads(self._lines([i])[0])

    @property
    def num_pages(self) -> int:
        return len(self._offsets)

    @staticmethod
    def _extract(line: bytes, key: bytes) -> Optional[str]:
        """One string field of a jsonl line without a full JSON parse
        (``json.loads`` costs several microseconds a record). Returns None
        whenever the value needs a real parse, and the caller then parses
        the line: any backslash (escapes), any '{' past the first byte (a
        nested key could shadow the top-level one), a missing key, a
        duplicate key (``json.loads`` keeps the last, a find the first), a
        value that is not a string."""
        if b"\\" in line or line.find(b"{", 1) >= 0:
            return None
        j = line.find(key)                    # e.g. b'"page":'
        if j < 0:
            return None
        if line.find(key, j + len(key)) >= 0:
            return None
        j += len(key)
        while j < len(line) and line[j] in b" \t":
            j += 1
        if j >= len(line) or line[j] != 0x22:           # opening '"'
            return None
        j += 1
        e = line.find(b'"', j)
        if e < 0:
            return None
        return line[j:e].decode("utf-8")

    def _texts_bulk(self, ids, key: bytes, getter) -> List[str]:
        """The records' raw lines, the fast extract, and a full parse of
        the records it does not take."""
        out = []
        for line in self._lines(ids):
            v = self._extract(line, key)
            out.append(getter(json.loads(line)) if v is None else v)
        return out

    def page_lines(self, ids) -> List[bytes]:
        """The raw lines of records `ids`, for the fused extract + encode
        (SubwordTokenizer.encode_jsonl_lines): nothing else on the Python
        side."""
        return self._lines(ids)

    def page_texts(self, ids) -> List[str]:
        return self._texts_bulk(ids, b'"page":', lambda r: r["page"])

    def query_texts(self, ids) -> List[str]:
        return self._texts_bulk(ids, b'"query":',
                                lambda r: r.get("query", ""))

    def page_text(self, i: int) -> str:
        return self.page_texts([i])[0]

    def query_text(self, i: int) -> str:
        return self.query_texts([i])[0]

    def pairs(self, start: int = 0, stop: Optional[int] = None
              ) -> Iterator[Tuple[int, str, str]]:
        stop = self.num_pages if stop is None else min(stop, self.num_pages)
        for i in range(start, stop):
            rec = self._record(i)
            yield i, rec.get("query", ""), rec["page"]

    def all_texts(self, limit: Optional[int] = None) -> Iterator[str]:
        """Page and query texts in record order (a vocab's training
        sample)."""
        stop = self.num_pages if limit is None else min(limit, self.num_pages)
        for i in range(stop):
            rec = self._record(i)
            yield rec["page"]
            if rec.get("query", ""):
                yield rec["query"]


def _first_line(chunk: bytes) -> bytes:
    """`chunk` up to and including its first newline (a record followed by
    blank lines carries them in its byte range)."""
    j = chunk.find(b"\n")
    return chunk if j < 0 or j == len(chunk) - 1 else chunk[:j + 1]
