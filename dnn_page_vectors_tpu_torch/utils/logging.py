"""MetricsLogger: metric records as jsonl under a workdir, mirrored to
stderr; the port's copy of the JAX package's utils/logging.py.

With a `registry` attached (utils/telemetry.py) every numeric scalar
written also lands as a registry gauge under the same key, so the jsonl
line, the Prometheus exposition and the JSON snapshot read the same
number from the same write. The line's shape ({"ts": ..., sorted keys})
is the JAX package's.

Lifecycle: a context manager (`with MetricsLogger(...) as log:`), and
`write()` after `close()` is tolerated -- the file handle is gone, so the
line goes to stderr and the registry only instead of raising
(SearchService.close() writes its final metrics through it).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, workdir: Optional[str] = None, name: str = "metrics",
                 echo: bool = True, registry=None):
        self.echo = echo
        self.registry = registry
        self._f = None
        self._closed = False
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self._f = open(os.path.join(workdir, f"{name}.jsonl"), "a")

    def write(self, metrics: Dict[str, Any]) -> None:
        rec = {"ts": time.time(), **{
            k: (float(v) if hasattr(v, "item") else v)
            for k, v in metrics.items()}}
        if self.registry is not None:
            for k, v in rec.items():
                if k != "ts" and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    self.registry.gauge(k).set(float(v))
        line = json.dumps(rec, sort_keys=True)
        if self._f is not None and not self._closed:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line, file=sys.stderr)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._f is not None and not self._closed:
            self._f.close()
        self._closed = True

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
