"""The mining pipeline: train -> embed -> mine -> train, on one card.

Counterpart of the JAX package's train/pipeline.py (config 4's loop as
one call). Each round trains ``steps_per_round`` steps, embeds the corpus
with the current weights into a store reset for this step, evaluates
Recall@k over it, and mines hard negatives with the current query tower
into ``<workdir>/hard_negatives.npy``, which the next round's batches
read; the last round mines nothing. The embedder shares the trainer's
model (the trainer puts it back into train mode at every step). A
trainer restored from a checkpoint taken mid-pipeline re-enters its round
(``trainer.step // steps_per_round``) with the last mined table.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import prepare_store
from dnn_page_vectors_tpu_torch.mine.ann import (
    HardNegatives, mine_hard_negatives)
from dnn_page_vectors_tpu_torch.train.loop import Trainer


def run_pipeline(cfg: Config, rounds: int = 2,
                 steps_per_round: Optional[int] = None,
                 trainer: Optional[Trainer] = None, ckpt_manager=None,
                 eval_every_round: bool = True) -> Dict[str, Any]:
    """Alternates training and mining for `rounds` rounds on `trainer`
    (which needs a workdir: the store, the table and the metrics live
    there). `steps_per_round` defaults to train.steps // rounds.

    Returns {"recalls": [recall@k per round evaluated], "negatives": the
    last HardNegatives (None before the first mine), "step": the trainer's
    step, "rounds": per round, its step and the host seconds of its train,
    embed (with the embedder's stats), eval and mine (with the table's
    stats)}. Each round also writes a line with ``pipeline_round``,
    ``step`` and ``recall@k`` to the trainer's metrics.jsonl."""
    if cfg.train.hard_negatives <= 0:
        raise ValueError("the pipeline needs train.hard_negatives > 0 "
                         "(otherwise Trainer.train is the right call)")
    if trainer is None or not trainer.workdir:
        raise ValueError("run_pipeline needs trainer=Trainer(cfg, "
                         "workdir=...): its store, mined table and metrics "
                         "live in the workdir")
    steps_per_round = steps_per_round or max(1, cfg.train.steps // rounds)
    store_dir = os.path.join(trainer.workdir, "store")
    negs_path = os.path.join(trainer.workdir, "hard_negatives.npy")

    # resume: a trainer restored mid-pipeline picks up the last mined table
    if os.path.exists(negs_path) and trainer.hard_negative_lookup is None:
        trainer.hard_negative_lookup = HardNegatives.load(negs_path)

    embedder: Optional[BulkEmbedder] = None
    recalls: List[float] = []
    per_round: List[Dict[str, Any]] = []
    negs = trainer.hard_negative_lookup
    k = cfg.eval.recall_k
    for r in range(trainer.step // steps_per_round, rounds):
        t0 = time.perf_counter()
        trainer.train(steps=steps_per_round, ckpt_manager=ckpt_manager)
        rec: Dict[str, Any] = {"round": r, "step": trainer.step,
                               "train_s": time.perf_counter() - t0}
        if embedder is None:
            embedder = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                                    query_tok=trainer.query_tok,
                                    device=trainer.device)
        # vectors of older weights are stale: reset and stamp this step
        store = prepare_store(store_dir, cfg.model.out_dim,
                              cfg.eval.store_shard_size, None, trainer.step)
        embedder.embed_corpus(trainer.corpus, store)
        rec["embed"] = dict(embedder.stats)
        if eval_every_round:
            t0 = time.perf_counter()
            recall, nq = evaluate_recall(embedder, trainer.corpus, store, k=k)
            rec.update(eval_s=time.perf_counter() - t0, recall=recall,
                       eval_queries=nq)
            recalls.append(recall)
            trainer.write_metrics({"pipeline_round": r, "step": trainer.step,
                                   f"recall@{k}": recall})
        if r + 1 < rounds:                # the last round's mine feeds nothing
            negs = mine_hard_negatives(
                embedder, trainer.corpus, store,
                num_negatives=cfg.train.hard_negatives, out_path=negs_path)
            trainer.hard_negative_lookup = negs
            rec["mine"] = dict(negs.stats)
        per_round.append(rec)
    return {"recalls": recalls, "negatives": negs, "step": trainer.step,
            "rounds": per_round}
