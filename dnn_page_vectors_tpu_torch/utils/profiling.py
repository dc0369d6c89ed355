"""PipelineProfiler: the seconds of each stage of the host <-> device
pipelines, so a from-text pages/s number says which stage binds (the
host's read and tokenize, the copies, the card, the store's writes).

The bulk embed (infer/bulk_embed.py) and the trainer (train/loop.py) use:
  read          corpus record reads inside the tokenizer workers
  tokenize      encode_batch (or the fused jsonl encode) in the workers
  pack          sequence packing of a train batch (train.pack_pages > 1)
  produce_wait  the consumer blocked waiting for a host batch
  h2d           pinning a batch's tensors and starting their copies
  compute       enqueueing the encode on the card
  device_wait   the host blocked until the card's results reached it
  write         shard concat + write_shard on the writer thread
  write_wait    the device loop blocked on the writer's pending budget

Seconds are cumulative across threads: a pool of N tokenizer workers adds
each worker's time, so ``read`` and ``tokenize`` can exceed the wall
clock. The ratios between stages, and the consumer's ``produce_wait``,
say which stage binds. Thread-safe: workers, the prefetch producer and
the writer thread all add into one instance.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict


class PipelineProfiler:
    """Cumulative seconds and calls per stage."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sec: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._sec[name] = self._sec.get(name, 0.0) + seconds
            self._n[name] = self._n.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def stages(self) -> Dict[str, float]:
        """{stage: cumulative seconds}."""
        with self._lock:
            return dict(self._sec)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)

    def summary(self, prefix: str = "stage_") -> Dict[str, float]:
        """Flat metrics: {f'{prefix}{stage}_s': seconds,
        f'{prefix}{stage}_n': calls}."""
        with self._lock:
            out: Dict[str, float] = {}
            for k in sorted(self._sec):
                out[f"{prefix}{k}_s"] = round(self._sec[k], 4)
                out[f"{prefix}{k}_n"] = self._n.get(k, 0)
            return out


NULL_PROFILER = PipelineProfiler()   # the sink where no profiler is wired
