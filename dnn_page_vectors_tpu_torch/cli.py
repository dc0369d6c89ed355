"""The port's command line: the offline workflows of the JAX package's CLI.

  python -m dnn_page_vectors_tpu_torch.cli configs
  python -m dnn_page_vectors_tpu_torch.cli train --config cdssm_toy --workdir W
  python -m dnn_page_vectors_tpu_torch.cli embed --config cdssm_toy --workdir W
  python -m dnn_page_vectors_tpu_torch.cli eval  --config cdssm_toy --workdir W
  python -m dnn_page_vectors_tpu_torch.cli mine  --config hardneg_v5p64 --workdir W
  python -m dnn_page_vectors_tpu_torch.cli pipeline --config hardneg_v5p64 \\
      --workdir W --rounds 2

Any config field is overridable with ``--set section.field=value``, e.g.
``--set data.corpus=jsonl:/data/pages.jsonl`` for a corpus of
{"query": ..., "page": ...} lines. Every command but ``configs`` works in
``--workdir``: the trained vocab, ``metrics.jsonl``, the checkpoints
(``ckpt/``), the store (``store/``) and the mined table
(``hard_negatives.npy``). Commands run on ``--device`` (default ``cuda``;
``cpu`` runs on the CPU). Each prints one JSON line with the JAX CLI's
keys: ``{"final": ...}``, ``{"embedded": N, ...}``, ``{"recall@k": ...}``,
``{"mined": [N, H], ...}``, ``{"rounds": R, "recalls": [...]}``.

The JAX CLI's other commands exit non-zero with a message naming the
ROADMAP.md item that ports them; none runs anything in their place.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from dnn_page_vectors_tpu_torch.config import CONFIGS, get_config

PORTED = ("configs", "train", "embed", "eval", "mine", "pipeline")
# command -> (ROADMAP.md queue 1 item, what it needs)
NOT_PORTED = {
    "init-store": (5, "writer manifests for manual-fleet embeds"),
    "merge-store": (5, "writer manifests for manual-fleet embeds"),
    "reset-store": (5, "the store administration commands"),
    "append": (5, "store generations, tombstones and attributes"),
    "migrate": (5, "store generations and migrations"),
    "search": (7, "the full serving stack (infer/serve.py)"),
    "index": (7, "the index command and the index's refresh"),
    "refresh": (7, "the serving stack's generation hot-swap"),
    "maintain": (7, "maintenance/"),
    "loadtest": (7, "loadgen/ and the serving fleet"),
    "partition-worker": (7, "partitioned serving"),
    "trace": (8, "tracing (utils/tracing.py)"),
    "serve-metrics": (8, "the telemetry registry"),
    "lint": (8, "graftcheck over the port"),
}


def _parse_overrides(pairs: Optional[List[str]]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for pair in pairs or []:
        key, _, value = pair.partition("=")
        out[key] = value
    return out


def _not_ported(what: str, item: int, need: str) -> SystemExit:
    return SystemExit(
        f"{what} is not ported to the PyTorch package yet: it needs {need} "
        f"(ROADMAP.md queue 1, item {item})")


def _trainer(cfg, workdir: str, device: str):
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    lookup = None
    if cfg.train.hard_negatives > 0:
        negs_path = os.path.join(workdir, "hard_negatives.npy")
        if os.path.exists(negs_path):
            from dnn_page_vectors_tpu_torch.mine.ann import HardNegatives
            lookup = HardNegatives.load(negs_path)
        else:
            print(f"WARNING: train.hard_negatives={cfg.train.hard_negatives} "
                  f"but {negs_path} does not exist: training with in-batch "
                  "negatives only; run 'mine' first (or check --workdir)",
                  file=sys.stderr)
    return Trainer(cfg, hard_negative_lookup=lookup, workdir=workdir,
                   device=device)


def _restore(trainer, workdir: str):
    """The checkpoint manager of `workdir`, with `trainer` restored from
    its newest checkpoint when there is one."""
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    if mgr.latest_step() is not None:
        trainer.restore(mgr)
    return mgr


def _open_index(cfg, store, device):
    """The IVF index for eval and mine when serve.index="ivf", else None
    (exact). An unavailable index is reported and exact retrieval runs,
    as in the JAX CLI."""
    if cfg.serve.index != "ivf":
        return None
    from dnn_page_vectors_tpu_torch.index.ivf import IndexUnavailable, IVFIndex
    try:
        return IVFIndex.open(store, device=device)
    except IndexUnavailable as e:
        print(f"WARNING: IVF index unavailable ({e}); using exact retrieval",
              file=sys.stderr)
        return None


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="dnn_page_vectors_tpu_torch")
    ap.add_argument("command", choices=[*PORTED, *NOT_PORTED])
    ap.add_argument("--config", default="cdssm_toy", choices=sorted(CONFIGS))
    ap.add_argument("--set", dest="overrides", action="append",
                    metavar="section.field=value")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints, vocab, store, metrics and the mined "
                         "table live here (required but for configs)")
    ap.add_argument("--steps", type=int, default=None,
                    help="train: steps to run (default: up to train.steps); "
                         "pipeline: steps a round")
    ap.add_argument("--rounds", type=int, default=2,
                    help="pipeline: train -> embed -> mine -> train rounds")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--start", type=int, default=0,
                    help="embed: first page of a manual-fleet slice (not "
                         "ported)")
    ap.add_argument("--stop", type=int, default=None,
                    help="embed: one past the slice's last page (not "
                         "ported)")
    args = ap.parse_args(argv)

    if args.command == "configs":
        for name in sorted(CONFIGS):
            print(name)
        return
    if args.command in NOT_PORTED:
        item, need = NOT_PORTED[args.command]
        raise _not_ported(f"the '{args.command}' command", item, need)
    if args.command == "embed" and (args.start != 0 or args.stop is not None):
        raise _not_ported("embed --start/--stop", 5,
                          "writer manifests for manual-fleet embeds")
    if not args.workdir:
        ap.error(f"{args.command} needs --workdir")
    cfg = get_config(args.config, _parse_overrides(args.overrides))
    workdir = os.path.abspath(args.workdir)
    store_dir = os.path.join(workdir, "store")
    trainer = _trainer(cfg, workdir, args.device)
    mgr = _restore(trainer, workdir)

    if args.command == "train":
        # a bare re-run after a crash completes to the configured total;
        # --steps N means N more steps
        steps = (max(0, cfg.train.steps - trainer.step) if args.steps is None
                 else args.steps)
        metrics = trainer.train(steps=steps, ckpt_manager=mgr)
        trainer.save(mgr)
        print(json.dumps({"final": metrics}, sort_keys=True))
        return

    if args.command == "pipeline":
        from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline
        steps_per_round = (args.steps if args.steps is not None
                           else max(1, cfg.train.steps // args.rounds))
        out = run_pipeline(cfg, rounds=args.rounds,
                           steps_per_round=steps_per_round, trainer=trainer,
                           ckpt_manager=mgr)
        trainer.save(mgr)
        print(json.dumps({"rounds": args.rounds, "recalls": out["recalls"]},
                         sort_keys=True))
        return

    if mgr.latest_step() is None:
        print(f"WARNING: no checkpoint under {workdir}/ckpt: "
              f"'{args.command}' runs with RANDOM weights; run 'train' "
              "first (or check --workdir)", file=sys.stderr)
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.vector_store import (
        VectorStore, prepare_store)
    embedder = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                            query_tok=trainer.query_tok,
                            device=trainer.device)

    if args.command == "embed":
        # vectors of another checkpoint are stale, not resumable work:
        # prepare_store resets a store stamped for another step
        from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler
        store = prepare_store(store_dir, cfg.model.out_dim,
                              cfg.eval.store_shard_size, cfg.eval.store_dtype,
                              trainer.step)
        prof = PipelineProfiler()
        embedder.embed_corpus(trainer.corpus, store, profiler=prof)
        print(json.dumps({"embedded": store.num_vectors,
                          "model_step": trainer.step,
                          "tokenize_workers": cfg.data.tokenize_workers,
                          "pages_per_sec": embedder.stats["pages_per_sec"],
                          "stages": prof.summary()}, sort_keys=True))
        return

    store = VectorStore(store_dir)
    index = _open_index(cfg, store, trainer.device)
    if args.command == "eval":
        from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
        recall, nq = evaluate_recall(embedder, trainer.corpus, store,
                                     k=cfg.eval.recall_k, index=index,
                                     nprobe=cfg.serve.nprobe)
        print(json.dumps({f"recall@{cfg.eval.recall_k}": recall,
                          "num_queries": nq,
                          "index": "ivf" if index is not None else "exact"},
                         sort_keys=True))
        return

    # mine
    from dnn_page_vectors_tpu_torch.mine.ann import mine_hard_negatives
    out = os.path.join(workdir, "hard_negatives.npy")
    negs = mine_hard_negatives(embedder, trainer.corpus, store,
                               num_negatives=cfg.train.hard_negatives or 7,
                               out_path=out, index=index,
                               nprobe=cfg.serve.nprobe)
    print(json.dumps({"mined": list(negs.table.shape), "path": out,
                      "index": "ivf" if index is not None else "exact"}))


if __name__ == "__main__":
    main()
