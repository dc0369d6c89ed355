#!/usr/bin/env python3
"""Phase 22 of chip_smoke.py alone: training across every card of the
machine, one process a card over NCCL, against one process.

    python3 scripts/multicard_check.py [--out PATH]

Builds the kernels and the C++ host library as chip_smoke.py does, makes
phase 4's corpus and vocab (BERT-mini's toy corpus of chip_smoke.N_PAGES
pages), then runs ``chip_smoke.run_multicard``: both cells through
``torchrun --nproc-per-node <cards> -m dnn_page_vectors_tpu_torch.cli
train``, their losses and grad norms against this process's Trainer on
the same batches within chip_smoke's MULTI_LOSS_RTOL and
MULTI_GRAD_NORM_RTOL, and K1/K2/K3's launches on every rank. It prints
chip_smoke's lines of the phase, the card's name and power limit, and
last ``{"ok": true, "world": N}``; with `--out` it also writes the
phase's record to PATH. For a machine of several cards, where the whole
of chip_smoke.py would repeat the one-card phases on one of them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("multicard_check: no CUDA device is available", file=sys.stderr)
        return 2
    from dnn_page_vectors_tpu_torch import native
    from dnn_page_vectors_tpu_torch.ops import build
    from dnn_page_vectors_tpu_torch.utils.device import resolve_device
    device = resolve_device(None)
    smi = cs.nvidia_smi()
    with ThreadPoolExecutor(len(cs.SOURCES) + 1) as pool:
        host_lib = pool.submit(native.build)
        kernels = [pool.submit(build.compile_source, src)
                   for src in cs.SOURCES]
        host_lib.result()
        native.load()
        bert = cs.build_data("bert_mini_v5p16", cs.N_PAGES)
        for f in kernels:
            f.result()
    for src in cs.SOURCES:
        build.load_library(src)
    with tempfile.TemporaryDirectory(prefix="multicard_") as tmp:
        rec = cs.run_multicard(device, bert, os.path.join(tmp, "multicard"),
                               smi)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "world": rec["world"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
