"""Contrastive training loop: the counterpart of the JAX package's
train/loop.py, on one card.

One step: encode queries and pages with both towers (dropout masks from a
generator seeded by (train.seed, step)), the cosine-contrastive loss,
the backward (through kernels K2 and K3, or K4 and K3 on the t5 path, when
``model.attention="flash"``), then the global-norm clip and the AdamW
update (train/optimizer.py). With ``train.pack_pages`` > 1 the pages ride
packed into rows with segment ids (sequence packing), and the kernels take
the segments.
PyTorch runs eagerly: there is no compiled step and no donated state.

With ``train.hard_negatives`` > 0 and a ``hard_negative_lookup`` (a
mined table, mine/ann.py ``HardNegatives``), each batch carries
"neg_page" [B, H, page_len] and the page tower encodes the negatives too;
without a lookup the trainer trains on in-batch negatives alone, as round
0 of the mining pipeline (train/pipeline.py) does.

Every step puts the model into train mode before its forward: an embed
between steps (the pipeline's ``BulkEmbedder`` shares the model and sets
eval mode) must not leave the next steps without dropout.

The loop reads metrics off the device only at the log cadence (every
``train.log_every`` steps and at the end), where it writes one jsonl line
with ``loss``, ``in_batch_acc``, ``scale``, ``grad_norm`` and
``pages_per_sec`` to ``<workdir>/metrics.jsonl`` (when a workdir is given)
and keeps it in ``history``.

Batches come from ``TrainBatcher`` with ``data.tokenize_workers`` tokenizer
workers through ``prefetch_to_device`` (a producer thread, pinned host
tensors, non-blocking copies), so the host tokenizes the next batches
while the card runs a step; ``profiler`` holds the host's stage seconds
(read, tokenize, pack, produce_wait, h2d).

Later slices: the telemetry registry and fault counters, ``scan_steps``,
and data parallelism over several cards.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, build_corpus, build_tokenizer, prefetch_to_device)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.models.losses import cosine_contrastive_loss
from dnn_page_vectors_tpu_torch.train.optimizer import make_optimizer
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device
from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler

LOGGED = ("loss", "in_batch_acc", "scale", "grad_norm")


def dropout_generator(seed: int, step: int,
                      device: torch.device) -> torch.Generator:
    """The generator of step `step`'s dropout masks, on `device`: seeded
    from (seed, step) alone (the counterpart of JAX's
    ``fold_in(base_rng, step)``), so a resumed run draws the same masks."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(mixed[0]) << 31 | int(mixed[1]) >> 1)
    return g


class Trainer:
    """Config -> data -> model -> optimizer -> train steps, on one device.

    ``device=None`` means cuda (and raises with no GPU); the tests pass
    ``device="cpu"``. ``tokenizers=(query_tok, page_tok)`` skips
    ``build_tokenizer``: anything with ``vocab_size`` and ``encode_batch``
    works. ``workdir`` (optional) caches the tokenizer and receives
    ``metrics.jsonl``; without it nothing is written.
    ``hard_negative_lookup`` maps [B] gold page ids to [B, H] negative page
    ids (mine/ann.py ``HardNegatives``); it may be set or replaced between
    calls of ``train``."""

    def __init__(self, cfg: Config, corpus=None,
                 hard_negative_lookup: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 workdir: Optional[str] = None,
                 tokenizers: Optional[Tuple[Any, Any]] = None,
                 device: DeviceLike = None):
        if cfg.train.pack_pages > 1 and cfg.model.encoder not in ("bert",
                                                                   "t5"):
            raise ValueError(
                "train.pack_pages needs a transformer page tower "
                f"(bert/t5), not {cfg.model.encoder!r}: segment masks only "
                "exist for attention encoders")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.workdir = workdir
        if workdir:
            os.makedirs(workdir, exist_ok=True)
        self.corpus = corpus if corpus is not None else build_corpus(cfg)
        self.query_tok, self.page_tok = (
            tokenizers if tokenizers is not None
            else build_tokenizer(cfg, self.corpus, cache_dir=workdir))
        self.model = build_two_tower(cfg, self.page_tok.vocab_size,
                                     device=self.device).train()
        self.optimizer = make_optimizer(cfg.train,
                                        self.model.named_parameters())
        self.hard_negative_lookup = hard_negative_lookup
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self.profiler = PipelineProfiler()

    # -- state ------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """What a checkpoint holds: parameters, optimizer moments and
        update count (the schedule's position), and the step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def save(self, ckpt_manager) -> None:
        ckpt_manager.save(self.step, self.state())

    def restore(self, ckpt_manager, step: Optional[int] = None) -> int:
        """Loads a checkpoint (the newest by default); the data stream then
        resumes at its step. Returns the step."""
        self.load_state(ckpt_manager.restore(self.state(), step=step))
        return self.step

    # -- data ---------------------------------------------------------------
    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Device batches from the current step on (packed rows with
        "page_seg" and "page_pos" when train.pack_pages > 1)."""
        batcher = TrainBatcher(
            self.corpus, self.query_tok, self.page_tok,
            batch_size=self.cfg.train.batch_size, seed=self.cfg.train.seed,
            start_step=self.step,
            hard_negative_lookup=self.hard_negative_lookup,
            pack=self.cfg.train.pack_pages,
            workers=self.cfg.data.tokenize_workers, profiler=self.profiler)
        return prefetch_to_device(iter(batcher), self.device,
                                  profiler=self.profiler)

    # -- one step -------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One update on a device batch (with "neg_page" when it carries
        mined negatives, "page_seg" and "page_pos" when its pages are
        packed); returns the step's metrics as device scalars."""
        gen = dropout_generator(self.cfg.train.seed, self.step, self.device)
        self.model.train()
        q, p, neg, scale = self.model(
            batch["query"], batch["page"], batch.get("neg_page"),
            generator=gen, page_seg=batch.get("page_seg"),
            page_pos=batch.get("page_pos"))
        loss, metrics = cosine_contrastive_loss(
            q, p, scale, neg, chunk=self.cfg.train.loss_chunk)
        self.optimizer.zero_grad()
        loss.backward()
        grad_norm = self.optimizer.step()
        self.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = grad_norm
        return out

    # -- training loop ----------------------------------------------------------
    def train(self, steps: Optional[int] = None,
              ckpt_manager=None) -> Dict[str, float]:
        """Runs `steps` more steps (default train.steps) from the current
        step, with the data resumed there. With `ckpt_manager`, saves every
        train.checkpoint_every steps (the final save is the caller's).
        Returns the last logged metrics line."""
        t = self.cfg.train
        steps = t.steps if steps is None else steps
        it = self.batches()
        last: Dict[str, float] = {}
        start = self.step
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            metrics = self.train_step(next(it))
            if i % t.log_every == 0 or i == steps:
                line = {k: float(metrics[k]) for k in LOGGED}   # syncs
                dt = time.perf_counter() - t0
                line["pages_per_sec"] = (self.step - start) * t.batch_size / dt
                line["step"] = self.step
                self._log(line)
                last = line
            if ckpt_manager is not None and i % t.checkpoint_every == 0 \
                    and i < steps:
                self.save(ckpt_manager)
        return last

    def _log(self, line: Dict[str, float]) -> None:
        self.history.append(line)
        self.write_metrics(line)

    def write_metrics(self, line: Dict[str, Any]) -> None:
        """Appends one timestamped line to ``<workdir>/metrics.jsonl``
        (nothing without a workdir)."""
        if self.workdir:
            rec = {"ts": time.time(), **line}
            with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
