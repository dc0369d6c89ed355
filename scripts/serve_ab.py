#!/usr/bin/env python3
"""Host and device time of the port's serving encodes, compared across
source trees on one GPU.

    python3 scripts/serve_ab.py TREE [TREE ...] [--out PATH]

For each TREE, in the order given (for two versions A and B: A B B A), one
process imports ``dnn_page_vectors_tpu_torch`` from TREE (its kernels build
into TREE/build/), builds BERT-mini (config bert_mini_v5p16: full width,
flash attention, random weights from the config's seed) on the GPU and,
under ``torch.inference_mode`` as ``BulkEmbedder`` runs it, times:

* one 512-page encode (ids [512, 64], ragged lengths) and one 8-query
  encode (ids [8, 16]) through ``BulkEmbedder.encode_pages`` /
  ``encode_queries``:
  - ``ms``: CUDA events over back-to-back calls, the larger of the host's
    issue time and the device's time per call;
  - ``host_issue_ms``: the host's time to issue one call (perf_counter
    over 5 calls before the synchronize, median of 10 repeats);
  - ``device_kernel_ms``: kernel time per call (torch.profiler);
* where TREE has the ``FlashAttention`` Function: K1 at the two encodes'
  attention shapes, issued through ``FlashAttention.apply`` and through
  the wrapper directly, host microseconds per call.

Prints one JSON line per tree, the card's name and power limit
(nvidia-smi), and a summary line. ``--out`` also writes all of it as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SHAPES = {"page": (512, 64), "query": (8, 16)}


def _host_ms(fn, calls: int = 5, repeats: int = 10) -> float:
    import torch
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def _event_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(fn, iters: int = 5) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total / 1e3 / iters


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    import dnn_page_vectors_tpu_torch as pkg
    if not pkg.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"imported {pkg.__file__}, not from {tree}")
    device = torch.device("cuda")
    cfg = get_config("bert_mini_v5p16", {"model.attention": "flash"})
    m = cfg.model
    model = build_two_tower(cfg, vocab_size=cfg.data.vocab_size,
                            device=device)
    emb = BulkEmbedder(cfg, model, None, device=device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rec = {"tree": tree}
    for name, (B, L) in SHAPES.items():
        ids = torch.randint(1, cfg.data.vocab_size, (B, L), generator=gen)
        lens = torch.randint(1, L + 1, (B,), generator=gen)
        ids[torch.arange(L)[None, :] >= lens[:, None]] = 0
        ids = ids.to(device)
        run = emb.encode_pages if name == "page" else emb.encode_queries
        fn = lambda: run(ids)
        fa.launches = 0
        fn()
        torch.cuda.synchronize()
        if fa.launches != m.num_layers:
            raise AssertionError(f"{name} encode launched K1 {fa.launches} "
                                 f"times, want {m.num_layers}")
        rec[name] = {"shape": [B, L], "ms": _event_ms(fn),
                     "host_issue_ms": _host_ms(fn),
                     "device_kernel_ms": _kernel_ms(fn)}
        if hasattr(fa, "FlashAttention"):
            Dh = m.model_dim // m.num_heads
            q, k, v = (torch.randn(B, L, m.num_heads, Dh, generator=gen)
                       .to(device, torch.bfloat16).transpose(1, 2)
                       for _ in range(3))
            mask = ids > 0
            with torch.inference_mode():
                via_fn = _host_ms(lambda: fa.FlashAttention.apply(
                    q, k, v, mask, None, None), calls=50)
                direct = _host_ms(lambda: fa._forward(
                    q, k, v, mask, None, None), calls=50)
            rec[name]["k1_issue_us"] = {"function_apply": via_fn * 1e3,
                                        "wrapper_direct": direct * 1e3}
    rec["device"] = torch.cuda.get_device_name(0)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0])), flush=True)
        return 0
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True, timeout=600, check=False)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"serve_ab: the run on {tree} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    summary = {}
    for tree in dict.fromkeys(args.trees):
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {
            f"{s}_{key}": [r[s][key] for r in mine]
            for s in SHAPES for key in ("ms", "host_issue_ms",
                                        "device_kernel_ms")}
    print(json.dumps({"summary": summary, "nvidia_smi": smi}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary, "nvidia_smi": smi},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
