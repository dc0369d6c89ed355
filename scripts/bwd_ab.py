#!/usr/bin/env python3
"""Device time of the port's unbiased backward kernels (K2 dq, K3 dk/dv),
compared across source trees on one GPU.

    python3 scripts/bwd_ab.py TREE [TREE ...] [--out PATH]

For each TREE, in the order given (for two versions A and B: A B B A), one
process imports ``dnn_page_vectors_tpu_torch`` from TREE (its kernels build
into TREE/build/) and times ``launch_dq`` (K2) and ``launch_dkv`` (K3)
with CUDA events over 50 back-to-back launches, at BERT-mini's page-tower
training shape: B=8192, H=4, L=S=64, Dh=64, bf16 q/k/v viewed from
[B, L, H, Dh] as the towers pass them, an f32 upstream gradient laid out
the same way, ragged padding. Prints one JSON line per tree, the card's
name and power limit (nvidia-smi), and a summary line; ``--out`` also
writes all of it as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPE = dict(B=8192, H=4, L=64, Dh=64)


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


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import dnn_page_vectors_tpu_torch as pkg
    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    if not pkg.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"imported {pkg.__file__}, not from {tree}")
    device = torch.device("cuda")
    B, H, L, Dh = (SHAPE[n] for n in ("B", "H", "L", "Dh"))
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(B, L, H, Dh, generator=gen)
               .to(device, torch.bfloat16).transpose(1, 2) for _ in range(3))
    g = torch.randn(B, L, H, Dh, generator=gen).to(device).transpose(1, 2)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(device)
    with torch.no_grad():
        out, lse = fa.flash_forward(q, k, v, mask)
    out = out.contiguous()
    _, delta = fa.launch_dq(q, k, v, mask, g, out, lse)
    return {"tree": tree, "shape": [B, H, L, L, Dh],
            "k2_ms": _event_ms(lambda: fa.launch_dq(q, k, v, mask, g, out,
                                                    lse)),
            "k3_ms": _event_ms(lambda: fa.launch_dkv(q, k, v, mask, g, lse,
                                                     delta)),
            "device": torch.cuda.get_device_name(0)}


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
            raise SystemExit(f"bwd_ab: the run on {tree} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    summary = {tree: {key: [r[key] for r in runs if r["tree"] == tree]
                      for key in ("k2_ms", "k3_ms")}
               for tree in dict.fromkeys(args.trees)}
    print(json.dumps({"summary": summary, "nvidia_smi": smi}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary, "nvidia_smi": smi},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
