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

The serving path (infer/serve.py) uses:
  queue_wait    a request sat in the micro-batcher's queue before dispatch
  tokenize      encode_batch over the cache-miss queries of a bucket
  encode        the query tower on the card, through the host copy back
  topk          the top-k over the staged store, the streaming sweep, or
                the IVF index
  merge         the top-k's copy back to the host
  format        page-id mapping and snippet assembly

``LatencyStats`` is the per-request counterpart: what one caller waits,
as count, mean and nearest-rank percentiles over a bounded reservoir.
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


class LatencyStats:
    """Per-request latency samples -> count, mean, p50 and p99. Where
    PipelineProfiler says which stage binds, this says what one caller
    waits under load, where the tail matters more than the mean.
    Thread-safe: concurrent callers add into one instance.

    Memory is bounded: samples land in a seeded reservoir
    (utils/telemetry.Reservoir, Algorithm R) of `cap` slots. Below `cap`
    samples the reservoir holds every observation, so count, mean and the
    nearest-rank percentiles are exact; past it, count and mean stay exact
    and the percentiles come from a uniform sample."""

    def __init__(self, cap: int = 4096, seed: int = 0) -> None:
        from dnn_page_vectors_tpu_torch.utils.telemetry import Reservoir
        self._res = Reservoir(cap=cap, seed=seed)

    def add(self, seconds: float) -> None:
        self._res.add(float(seconds))

    @contextlib.contextmanager
    def timed(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)

    def __len__(self) -> int:
        return self._res.count

    def percentile_ms(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) in milliseconds; 0.0
        with no samples. The p50 of an even count is the lower middle
        sample: a latency the service delivered, not an interpolation."""
        return self._res.percentile(q) * 1000.0

    def summary(self, prefix: str = "lat_") -> Dict[str, float]:
        return {f"{prefix}count": self._res.count,
                f"{prefix}mean_ms": round(self._res.mean * 1000.0, 3),
                f"{prefix}p50_ms": round(self.percentile_ms(50), 3),
                f"{prefix}p99_ms": round(self.percentile_ms(99), 3)}


NULL_PROFILER = PipelineProfiler()   # the sink where no profiler is wired
