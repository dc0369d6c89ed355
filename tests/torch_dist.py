"""Runs a function on each rank of a small torch.distributed job, for the
port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_ring_attention.py, tests/test_torch_parallel_cuda.py).

``run_ranks(fn, world, *args)`` spawns `world` processes (the spawn
start method: a fresh interpreter each, which imports this module, torch
and the port, never jax), forms their process group over
``tcp://127.0.0.1:<free port>`` (gloo for the CPU, NCCL with
``backend="nccl"``, one card a rank), calls ``fn(rank, world, *args)`` in
each, and returns the ranks' results in rank order. Each process runs one
torch thread. A rank's exception fails the call with its traceback; a job
that has not ended after `timeout` seconds is killed and fails the call,
and each collective of the group raises after `collective_s` seconds, so
a hang fails a test instead of eating the suite's time limit.

The ``*_rank`` functions below are the bodies the tests hand in: they
must live in a module the spawned interpreter can import without jax.
"""
from __future__ import annotations

import multiprocessing
import os
import socket
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, backend, collective_s, out, args):
    try:
        torch.set_num_threads(1)
        from dnn_page_vectors_tpu_torch.parallel.mesh import multihost_init
        if backend == "nccl":
            os.environ["LOCAL_RANK"] = str(rank)
        multihost_init(f"tcp://127.0.0.1:{port}", world, rank, backend,
                       timeout_s=collective_s)
        result = fn(rank, world, *args)
        torch.save({"result": result}, out)
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()        # no rank tears the group down early
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              timeout: float = 150.0, collective_s: float = 60.0
              ) -> List[Any]:
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="torch_dist_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_entry, args=(
            fn, r, world, port, backend, collective_s, outs[r], args))
            for r in range(world)]
        for p in procs:
            p.start()
        errors = []
        try:
            for r, p in enumerate(procs):
                p.join(timeout)
                if p.is_alive():
                    errors.append(f"rank {r} still running after "
                                  f"{timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        for r, p in enumerate(procs):
            if os.path.exists(outs[r] + ".err"):
                with open(outs[r] + ".err") as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and not errors:
                errors.append(f"rank {r} exited {p.exitcode}")
        if errors:
            raise AssertionError("\n".join(errors))
        return [torch.load(o, weights_only=False)["result"] for o in outs]


# -- rank bodies ---------------------------------------------------------------

def _trainer(cfg, corpus_kw, tok_dir, device="cpu"):
    """A Trainer on the toy corpus of `corpus_kw` (None: the config's),
    with the vocab cached in `tok_dir`."""
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    corpus = (build_corpus(cfg) if corpus_kw is None
              else ToyCorpus(**corpus_kw))
    toks = build_tokenizer(cfg, corpus, cache_dir=tok_dir)
    return Trainer(cfg, corpus=corpus, tokenizers=toks, device=device)


def train_rank(rank, world, config, overrides, corpus_kw, tok_dir,
               init_path, steps, ckpt_dir=None, resume=False,
               device="cpu") -> Dict[str, Any]:
    """`steps` train steps of `config` on this rank's mesh from the full
    state dict at `init_path` (or, with `resume`, from the newest
    checkpoint in `ckpt_dir`); saves to `ckpt_dir` after them when it is
    given. Returns the logged losses and accuracies, the full parameters
    after the steps (numpy) and this rank's mesh coordinates."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.parallel.sharding import (
        gather_params, shard_params)
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    if device == "cuda":
        device = f"cuda:{rank}"
    cfg = get_config(config, {**overrides, "train.log_every": 1})
    tr = _trainer(cfg, corpus_kw, tok_dir, device)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume:
        tr.restore(mgr)
    elif init_path:
        full = torch.load(init_path, weights_only=True)
        tr.model.load_state_dict(shard_params(full, tr.mesh), strict=True)
    tr.train(steps)
    if mgr is not None:
        tr.save(mgr)
    params = gather_params(tr.model.state_dict(), tr.mesh)
    return {"loss": [h["loss"] for h in tr.history],
            "acc": [h["in_batch_acc"] for h in tr.history],
            "grad_norm": [h["grad_norm"] for h in tr.history],
            "params": {k: v.detach().cpu().numpy() for k, v in params.items()},
            "coords": tr.mesh.coords, "step": tr.step}


def grad_rank(rank, world, config, overrides, corpus_kw, tok_dir,
              init_path, neg_shift) -> Dict[str, Any]:
    """One step's gradients after the all-reduce over the data x seq
    group, before the optimizer (with mined negatives when `neg_shift`:
    page i's negatives are i + neg_shift mod N), and the step's metrics."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.models.losses import (
        cosine_contrastive_loss)
    from dnn_page_vectors_tpu_torch.parallel.mesh import all_reduce_
    from dnn_page_vectors_tpu_torch.parallel.sharding import shard_params
    cfg = get_config(config, overrides)
    tr = _trainer(cfg, corpus_kw, tok_dir)
    full = torch.load(init_path, weights_only=True)
    tr.model.load_state_dict(shard_params(full, tr.mesh), strict=True)
    n = cfg.data.num_pages
    if neg_shift:
        tr.hard_negative_lookup = lambda ids: (
            (ids[:, None] + np.asarray(neg_shift)) % n)
    batch = next(iter(tr.batches()))
    m = tr.mesh
    q, p, neg, scale = tr.model(batch["query"], batch["page"],
                                batch.get("neg_page"))
    loss, metrics = cosine_contrastive_loss(
        q, p, scale, neg, chunk=cfg.train.loss_chunk, group=m.group("data"))
    (loss / m.seq).backward()
    params = dict(tr.model.named_parameters())
    all_reduce_([t.grad for t in params.values()], m.group("dp"))
    return {"grads": {k: t.grad.numpy().copy() for k, t in params.items()},
            "loss": float(metrics["loss"].detach()),
            "acc": float(metrics["in_batch_acc"]),
            "local_loss": float(loss.detach()), "coords": m.coords}


def ring_rank(rank, world, q, k, v, mask, table, g, device="cpu"
              ) -> Dict[str, Any]:
    """Ring attention of this rank's block of the [B, H, L, Dh] inputs
    (the whole job is one seq group), and its gradients against
    cotangent `g`: the block's out, dq, dk, dv and the table's gradient
    share (numpy)."""
    from dnn_page_vectors_tpu_torch.models.transformer import (
        relative_position_bucket)
    from dnn_page_vectors_tpu_torch.parallel.mesh import make_mesh
    from dnn_page_vectors_tpu_torch.parallel.ring_attention import (
        local_block, ring_attention)
    from dnn_page_vectors_tpu_torch.config import MeshConfig
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
    mesh = make_mesh(MeshConfig(seq=world))
    L = q.shape[2]
    blk = local_block(L, world, mesh.seq_index)
    t = lambda a: torch.tensor(a[:, :, blk], device=dev, requires_grad=True)
    qb, kb, vb = t(q), t(k), t(v)
    tab = None if table is None else torch.tensor(
        table, device=dev, requires_grad=True)
    dist_b = torch.from_numpy(relative_position_bucket(
        np.arange(-(L - 1), L))).to(dev)
    fn = None if table is None else (lambda rel: dist_b[rel + L - 1])
    out = ring_attention(qb, kb, vb, torch.tensor(mask[:, blk], device=dev),
                         mesh.group("seq"), bias_table=tab, bucket_fn=fn)
    out.backward(torch.tensor(g[:, :, blk], device=dev))
    res = {"out": out.detach().cpu().numpy(),
           "dq": qb.grad.cpu().numpy(), "dk": kb.grad.cpu().numpy(),
           "dv": vb.grad.cpu().numpy()}
    if tab is not None:
        res["dtable"] = tab.grad.cpu().numpy()
    return res


def batch_rank(rank, world, config, overrides, corpus_kw, tok_dir
               ) -> Dict[str, np.ndarray]:
    """This rank's first batch, as the trainer's batcher reads it."""
    from dnn_page_vectors_tpu_torch.config import get_config
    tr = _trainer(get_config(config, overrides), corpus_kw, tok_dir)
    return {k: v.numpy().copy() for k, v in next(iter(tr.batches())).items()}


def refuse_rank(rank, world, config, overrides, corpus_kw, tok_dir
                ) -> Optional[str]:
    """The error a Trainer of this mesh raises, or None."""
    from dnn_page_vectors_tpu_torch.config import get_config
    try:
        _trainer(get_config(config, overrides), corpus_kw, tok_dir)
    except (ValueError, RuntimeError) as e:
        return str(e)
    return None


def hosts_rank(rank, world) -> Dict[str, Any]:
    """multihost's process info, a barrier and a host all-gather."""
    from dnn_page_vectors_tpu_torch.parallel import multihost
    multihost.barrier("start")
    return {"info": multihost.process_info(),
            "gathered": multihost.allgather_hosts(
                np.arange(3, dtype=np.int64) + 10 * rank)}
