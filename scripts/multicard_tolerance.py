#!/usr/bin/env python3
"""Readings behind the tolerances of chip_smoke.py's phase 22 (training
across cards), rehearsed on the CPU.

    python3 scripts/multicard_tolerance.py [--world 2] [--steps 3]
        [--bert-batch 256] [--long-batch 8] [--vocab 2048]
        [--cells bert_mini_dp,bert_long_ring] [--out PATH]

Phase 22 holds the losses and grad norms of a job over several ranks
against one process's Trainer on the same batches. This script runs both
cells of phase 22 at their model widths (bf16 towers, dropout 0) with
`--world` ranks, spawned processes over gloo with one torch thread each,
and the same config in one process, and reads the largest relative
difference of the logged losses and grad norms over `--steps` steps. It
reads it for the sound job and for jobs with one fault planted at run
time (the package's own functions wrapped inside the ranks; no file is
changed):

* ``mean_all_reduce``: the gradient all-reduce averages instead of
  summing (every gradient over the data x seq size);
* ``local_negatives``: each rank scores its rows against its own pages
  only, and the gradient is averaged, as plain DistributedDataParallel
  over a per-rank loss would do;
* ``no_seq_division`` (the ring cell): each rank of a seq group backs its
  whole loss, not loss / seq (every gradient seq times too large).

A fault that its cell's mesh cannot show (no data axis in the ring cell,
no seq axis in the BERT-mini cell) is not run. The cut from phase 22:
the batch (`--bert-batch` pairs of 64 tokens, `--long-batch` pages of
1,024 tokens), the toy corpus (4 pages a row of the batch) and its
vocab (`--vocab` wordpieces, not 30,522: it sizes the embedding's rows,
not a width), and the kernels: on the CPU every attention runs its
plain version, and the ring its float32 torch ops. Prints one JSON line
a run and, last, a summary of the sound and the faulty readings; with
`--out` also writes them to PATH.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

FAULTS = {"bert_mini_dp": ("mean_all_reduce", "local_negatives"),
          "bert_long_ring": ("mean_all_reduce", "no_seq_division")}


def cells(world: int, bert_batch: int, long_batch: int, vocab: int) -> dict:
    """Phase 22's two cells (chip_smoke.multicard_cells) at this cut."""
    common = {"train.log_every": 1, "model.dropout": 0.0,
              "mesh.model": 1, "mesh.strict": True,
              "data.vocab_size": vocab}
    return {
        "bert_mini_dp": ("bert_mini_v5p16", {
            **common, "data.num_pages": 4 * bert_batch,
            "train.batch_size": bert_batch, "model.attention": "flash",
            "mesh.data": world, "mesh.seq": 1}),
        "bert_long_ring": ("bert_long_sp", {
            **common, "data.num_pages": 4 * long_batch,
            "train.batch_size": long_batch, "model.attention": "ring",
            "mesh.data": 1, "mesh.seq": world})}


def plant(fault: str) -> None:
    """Wraps the package's functions in this process so that its
    Trainer carries `fault` (see the module docstring)."""
    from dnn_page_vectors_tpu_torch.train import loop
    from dnn_page_vectors_tpu_torch.parallel.mesh import group_size
    reduce_ = loop.all_reduce_
    if fault in ("mean_all_reduce", "local_negatives"):
        def mean_reduce(tensors, group):
            tensors = list(tensors)
            reduce_(tensors, group)
            for t in tensors:
                t.div_(group_size(group))
        loop.all_reduce_ = mean_reduce
    if fault == "local_negatives":
        loss_ = loop.cosine_contrastive_loss

        def local_loss(*args, group=None, **kw):
            return loss_(*args, group=None, **kw)
        loop.cosine_contrastive_loss = local_loss
    if fault == "no_seq_division":
        def times_seq(tensors, group):
            tensors = list(tensors)
            reduce_(tensors, group)
            seq = int(os.environ["REHEARSAL_SEQ"])
            for t in tensors:
                t.mul_(seq)
        loop.all_reduce_ = times_seq


def train(config: str, overrides: dict, tok_dir: str, steps: int,
          fault: str | None) -> list:
    """`steps` logged steps of `config` on this process's mesh: the
    history's losses and grad norms."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    if fault:
        plant(fault)
    cfg = get_config(config, overrides)
    corpus = build_corpus(cfg)
    toks = build_tokenizer(cfg, corpus, cache_dir=tok_dir)
    tr = Trainer(cfg, corpus=corpus, tokenizers=toks, device="cpu")
    tr.train(steps)
    return [{"loss": h["loss"], "grad_norm": h["grad_norm"],
             "in_batch_acc": h["in_batch_acc"]} for h in tr.history]


def _rank(rank, world, port, out, args):
    try:
        torch.set_num_threads(1)
        from dnn_page_vectors_tpu_torch.parallel.mesh import multihost_init
        multihost_init(f"tcp://127.0.0.1:{port}", world, rank, "gloo",
                       timeout_s=600)
        result = train(*args)
        with open(out, "w") as f:
            json.dump(result, f)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_job(world: int, args: tuple, timeout: float = 3000.0) -> list:
    """Rank 0's history of `train(*args)` over `world` spawned ranks."""
    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="rehearsal_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [ctx.Process(target=_rank, args=(r, world, port, outs[r],
                                                 args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        for o in outs:
            if os.path.exists(o + ".err"):
                with open(o + ".err") as f:
                    raise RuntimeError(f.read())
        with open(outs[0]) as f:
            return json.load(f)


def rel_err(got: list, want: list, key: str) -> float:
    return max(abs(g[key] - w[key]) / abs(w[key]) for g, w in zip(got, want))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--bert-batch", type=int, default=256)
    ap.add_argument("--long-batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--cells", default="bert_mini_dp,bert_long_ring")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    os.environ["REHEARSAL_SEQ"] = str(a.world)
    all_cells = cells(a.world, a.bert_batch, a.long_batch, a.vocab)
    summary = {}
    with tempfile.TemporaryDirectory(prefix="rehearsal_tok_") as tok_root:
        for cell in a.cells.split(","):
            config, ov = all_cells[cell]
            tok_dir = os.path.join(tok_root, cell)
            os.makedirs(tok_dir)
            t0 = time.perf_counter()
            ref_ov = {**ov, "mesh.data": 1, "mesh.seq": 1,
                      "mesh.strict": False}
            ref = train(config, ref_ov, tok_dir, a.steps, None)
            rows = {}
            for fault in (None,) + FAULTS[cell]:
                got = run_job(a.world, (config, ov, tok_dir, a.steps, fault))
                row = {"cell": cell, "config": config, "world": a.world,
                       "fault": fault or "none",
                       "loss_max_rel_err": rel_err(got, ref, "loss"),
                       "grad_norm_max_rel_err": rel_err(got, ref,
                                                        "grad_norm"),
                       "losses": [g["loss"] for g in got],
                       "reference_losses": [r["loss"] for r in ref],
                       "grad_norms": [g["grad_norm"] for g in got],
                       "reference_grad_norms": [r["grad_norm"] for r in ref],
                       "overrides": ov}
                print(json.dumps(row), flush=True)
                rows[row["fault"]] = {k: row[k] for k in (
                    "loss_max_rel_err", "grad_norm_max_rel_err")}
            rows["seconds"] = time.perf_counter() - t0
            summary[cell] = rows
    summary["torch"] = torch.__version__
    print(json.dumps({"summary": summary}), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
