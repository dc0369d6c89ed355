"""Contrastive training loop: the counterpart of the JAX package's
train/loop.py, on one card or on a mesh of them.

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
with ``loss``, ``in_batch_acc``, ``scale``, ``grad_norm``,
``pages_per_sec`` (global), ``pages_per_sec_per_chip`` (that over the
mesh's ranks), ``mfu`` (where the card's peak is known, utils/flops.py),
``hbm_gb_in_use`` (on a card) and ``fault_counters`` (when a fault was
counted) to ``<workdir>/metrics.jsonl`` (when a workdir is given; rank 0
alone writes) and keeps it in ``history``. The telemetry registry gets
the ``train.steps`` counter and the ``train.pages_per_sec_per_chip`` and
``train.mfu`` gauges.

On a mesh (``mesh``, by default ``make_mesh(cfg.mesh)`` over the job's
process group, parallel/mesh.py), one process a card:

* a rank's batcher reads its slice of the global batch (data axis); the
  loss scores its rows against every rank's pages and negatives and is
  its share of the global loss; the ranks of a seq group hold the same
  rows, so each backs its loss / seq;
* the gradients are summed over the data x seq group with a bucketed
  all-reduce of the port's own (``parallel.mesh.all_reduce_``), not
  ``DistributedDataParallel``: the loss convention asks for a sum, not
  DDP's mean, and the ring and the model axis already run collectives of
  their own inside the backward, which DDP's hooks would race;
* the clip norm counts a split parameter's shards once (the optimizer);
* dropout masks come from a generator seeded by (train.seed, step, the
  rank's place in the data x seq group): a model group draws the same
  masks, as its activations are the same, and two runs at one world size
  draw the same masks. In one process the seed is (train.seed, step).

Batches come from ``TrainBatcher`` with ``data.tokenize_workers`` tokenizer
workers through ``prefetch_to_device`` (a producer thread, pinned host
tensors, non-blocking copies), so the host tokenizes the next batches
while the card runs a step; ``profiler`` holds the host's stage seconds
(read, tokenize, pack, produce_wait, h2d).

Later slices: ``scan_steps``.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, build_corpus, build_tokenizer, prefetch_to_device)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.models.losses import cosine_contrastive_loss
from dnn_page_vectors_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_, make_mesh)
from dnn_page_vectors_tpu_torch.parallel.multihost import barrier
from dnn_page_vectors_tpu_torch.parallel.sharding import (
    gather_params, shard_params)
from dnn_page_vectors_tpu_torch.train.optimizer import make_optimizer
from dnn_page_vectors_tpu_torch.utils import faults, telemetry
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device
from dnn_page_vectors_tpu_torch.utils.flops import (
    device_peak_flops, train_flops_per_pair)
from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler

LOGGED = ("loss", "in_batch_acc", "scale", "grad_norm")


def dropout_generator(seed: int, step: int, device: torch.device,
                      rank: Optional[int] = None) -> torch.Generator:
    """The generator of step `step`'s dropout masks, on `device`: seeded
    from (seed, step) (the counterpart of JAX's ``fold_in(base_rng,
    step)``), so a resumed run draws the same masks; on a mesh of several
    data x seq ranks, also from `rank`, the rank's place among them."""
    entropy = [seed, step] if rank is None else [seed, step, rank]
    mixed = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(mixed[0]) << 31 | int(mixed[1]) >> 1)
    return g


class Trainer:
    """Config -> data -> model -> optimizer -> train steps, on one device
    or a rank of a mesh (see the module docstring).

    ``device=None`` means cuda (``cuda:LOCAL_RANK`` under torchrun; it
    raises with no GPU); the tests pass ``device="cpu"``. ``mesh``
    defaults to ``make_mesh(cfg.mesh)`` over the process group (one rank
    outside one). ``tokenizers=(query_tok, page_tok)`` skips
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
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        if cfg.train.pack_pages > 1 and cfg.model.encoder not in ("bert",
                                                                   "t5"):
            raise ValueError(
                "train.pack_pages needs a transformer page tower "
                f"(bert/t5), not {cfg.model.encoder!r}: segment masks only "
                "exist for attention encoders")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh)
        m = self.mesh
        if (m.data, m.model, m.seq) != (cfg.mesh.data, cfg.mesh.model,
                                        cfg.mesh.seq):
            print(f"WARNING: mesh {cfg.mesh.data}x{cfg.mesh.model}x"
                  f"{cfg.mesh.seq} shrunk to {m.data}x{m.model}x{m.seq} for "
                  f"{m.size} rank(s); set mesh.strict=true to fail instead",
                  file=sys.stderr)
        if cfg.train.pack_pages > 1 and cfg.model.attention == "ring" \
                and m.seq > 1:
            raise ValueError("train.pack_pages takes model.attention dense "
                             "or flash: the ring splits the sequence itself")
        self.workdir = workdir
        if workdir:
            os.makedirs(workdir, exist_ok=True)
        self.corpus = corpus if corpus is not None else build_corpus(cfg)
        if tokenizers is None:
            # rank 0 trains (and caches) a vocab first, the others load it
            if m.rank == 0:
                tokenizers = build_tokenizer(cfg, self.corpus,
                                             cache_dir=workdir)
            barrier("tokenizer cached")
            if tokenizers is None:
                tokenizers = build_tokenizer(cfg, self.corpus,
                                             cache_dir=workdir)
        self.query_tok, self.page_tok = tokenizers
        self.model = build_two_tower(cfg, self.page_tok.vocab_size,
                                     device=self.device, mesh=m).train()
        self.optimizer = make_optimizer(cfg.train,
                                        self.model.named_parameters(),
                                        m.group("model"))
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

    def full_state(self) -> Dict[str, Any]:
        """``state()`` with the full tensors of every split parameter and
        its moments (a collective on a mesh whose model axis splits them:
        every rank calls it)."""
        st = self.state()
        opt = dict(st["optimizer"])
        for key in ("mu", "nu"):
            opt[key] = gather_params(opt[key], self.mesh)
        return {"model": gather_params(st["model"], self.mesh),
                "optimizer": opt, "step": st["step"]}

    def load_full_state(self, state: Dict[str, Any]) -> None:
        """Loads a full state (``full_state()``'s, at any mesh) as this
        rank's shards."""
        opt = dict(state["optimizer"])
        for key in ("mu", "nu"):
            opt[key] = shard_params(opt[key], self.mesh)
        self.load_state({"model": shard_params(state["model"], self.mesh),
                         "optimizer": opt, "step": state["step"]})

    def save(self, ckpt_manager) -> None:
        """Rank 0 writes the full state (the file of one card, whatever
        the mesh); every rank calls it and waits for the write."""
        state = self.full_state()
        if self.mesh.rank == 0:
            ckpt_manager.save(self.step, state)
        barrier("checkpoint saved")

    def restore(self, ckpt_manager, step: Optional[int] = None) -> int:
        """Loads a checkpoint (the newest by default), saved at any mesh,
        as this rank's shards; the data stream then resumes at its step.
        Returns the step."""
        self.load_full_state(ckpt_manager.restore(self.full_state(),
                                                  step=step))
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
            workers=self.cfg.data.tokenize_workers, profiler=self.profiler,
            process_index=self.mesh.data_index,
            process_count=self.mesh.data)
        return prefetch_to_device(iter(batcher), self.device,
                                  profiler=self.profiler)

    # -- one step -------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One update on a device batch (with "neg_page" when it carries
        mined negatives, "page_seg" and "page_pos" when its pages are
        packed); returns the step's metrics as device scalars."""
        m = self.mesh
        gen = dropout_generator(self.cfg.train.seed, self.step, self.device,
                                m.dp_rank if m.dp_size > 1 else None)
        self.model.train()
        q, p, neg, scale = self.model(
            batch["query"], batch["page"], batch.get("neg_page"),
            generator=gen, page_seg=batch.get("page_seg"),
            page_pos=batch.get("page_pos"))
        loss, metrics = cosine_contrastive_loss(
            q, p, scale, neg, chunk=self.cfg.train.loss_chunk,
            group=m.group("data"))
        self.optimizer.zero_grad()
        (loss / m.seq if m.seq > 1 else loss).backward()
        all_reduce_([p.grad for p in self.optimizer.params.values()],
                    m.group("dp"))
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
        reg = telemetry.default_registry()
        steps_counter = reg.counter("train.steps",
                                    window_s=telemetry.DEFAULT_WINDOW_S)
        peak = device_peak_flops(self.device)
        flops_pair = train_flops_per_pair(self.cfg, t.batch_size)
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            metrics = self.train_step(next(it))
            steps_counter.inc()
            if i % t.log_every == 0 or i == steps:
                line = {k: float(metrics[k]) for k in LOGGED}   # syncs
                dt = time.perf_counter() - t0
                line["pages_per_sec"] = (self.step - start) * t.batch_size / dt
                line["pages_per_sec_per_chip"] = (line["pages_per_sec"]
                                                  / self.mesh.size)
                reg.gauge("train.pages_per_sec_per_chip").set(
                    line["pages_per_sec_per_chip"])
                if peak:
                    line["mfu"] = (line["pages_per_sec_per_chip"]
                                   * flops_pair / peak)
                    reg.gauge("train.mfu").set(line["mfu"])
                if self.device.type == "cuda":
                    line["hbm_gb_in_use"] = round(
                        torch.cuda.memory_allocated(self.device) / 2**30, 3)
                line["step"] = self.step
                fc = faults.counters()
                if fc:
                    line["fault_counters"] = fc
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
        (nothing without a workdir, or on a rank other than 0)."""
        if self.workdir and self.mesh.rank == 0:
            rec = {"ts": time.time(), **line}
            with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
