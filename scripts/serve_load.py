#!/usr/bin/env python3
"""chip_smoke.py's phase 16 (serving under load) alone, on one GPU, with
more rate searches than the chip check can afford.

    python3 scripts/serve_load.py [--runs N] [--out PATH]

Writes phase 15's jsonl corpus (1,000,000 pages of ``data/synth.py``,
seed 11) and, in place of phase 15's embedded store, a 1,000,000-row fp16
store of seeded random unit rows; trains phase 4's WordPiece vocab; then
runs ``chip_smoke.run_serving`` with ``SERVE_RUNS`` set to N (default 4):
N rate searches with the query cache on and N with it off, alternating,
each judged on the client's p99, then the burst and closed-loop trials.
Phase 16's checks hold as in the chip check (the top-k against a plain
top-k of the staged rows, streaming, the socket, K1's launches); its time
budget does not, since N searches take longer. The corpus and the store
go into a temporary directory under the working directory, removed at
the end.

Prints phase 16's JSON lines, the card's name and power limit
(nvidia-smi) and a summary line of the rates by run; ``--out`` also
writes phase 16's record as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def random_store(directory: str, rows: int, dim: int, shard: int,
                 seed: int = 0):
    """A float16 store of `rows` seeded random unit rows, page ids
    0..rows-1, stamped at model step 0."""
    import numpy as np

    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    store = VectorStore(directory, dim=dim, shard_size=shard,
                        dtype="float16")
    store.ensure_model_step(0)
    rng = np.random.default_rng(seed)
    for i, lo in enumerate(range(0, rows, shard)):
        hi = min(rows, lo + shard)
        v = rng.standard_normal((hi - lo, dim), dtype=np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        store.write_shard(i, np.arange(lo, hi, dtype=np.int64),
                          v.astype(np.float16))
    return store


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4,
                    help="rate searches with the cache on, and as many off")
    ap.add_argument("--out", default=None, help="phase 16's record as JSON")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.ops import build
    if not torch.cuda.is_available():
        raise SystemExit("serve_load.py needs a CUDA device")
    print(cs.nvidia_smi(), flush=True)
    build.load_library("flash_fwd.cu")
    data = cs.build_data("bert_mini_v5p16", cs.N_PAGES)
    tmp = tempfile.mkdtemp(dir=os.getcwd(), prefix=".chip_smoke_")
    try:
        path = os.path.join(tmp, "corpus_1m.jsonl")
        cs.write_production_corpus(path, cs.PROD_PAGES, cs.PROD_SEED,
                                   cs.PROD_PAGE_WORDS, cs.PROD_QUERY_WORDS)
        random_store(os.path.join(tmp, "store_production"), cs.PROD_PAGES,
                     get_config("bert_mini_v5p16").model.out_dim,
                     cs.PROD_SHARD)
        cs.SERVE_RUNS = args.runs
        cs.SERVE_BUDGET_S = 1e9
        t0 = time.perf_counter()
        rec = cs.run_serving(torch.device("cuda"), data, tmp,
                             {"corpus_path": path})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    load = rec["d_load"]
    print(json.dumps({
        "summary": "serve_load", "runs": args.runs,
        "seconds": time.perf_counter() - t0,
        "qps_at_p99_runs": {k: load[k]["qps_at_p99_runs"]
                            for k in ("on", "off")},
        "nvidia_smi": cs.nvidia_smi()}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
