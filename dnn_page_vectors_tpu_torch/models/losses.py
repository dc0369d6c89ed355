"""Cosine-contrastive loss with in-batch (and optional mined hard)
negatives, and ``l2_normalize``.

Counterpart of the JAX package's models/losses.py. Two ways to the same
math:

* dense (``chunk=0``): the [B, B(1+H)] logits exist at once;
* chunked (``chunk > 0``, train.loss_chunk): query rows are scored
  against the negative pool ``chunk`` rows at a time, each chunk under
  ``torch.utils.checkpoint``, so only one [chunk, M] logits tile lives at
  a time in the forward and the backward rebuilds it from the [chunk, D]
  inputs. The softmax cross-entropy is exactly lse - positive logit, so
  the two agree to float32 rounding.

Across the mesh's data axis (``group``, parallel/mesh.py), each rank
holds b = B / n rows. As under the JAX package's GSPMD, the loss is the
global batch's: the normalised query, page and negative vectors are
gathered over the group (``all_gather_sum_grad``, whose backward sums
over the ranks), each rank scores its own rows against the global pool,
and returns its rows' share of the global loss (their sum over the B
rows' mean), so the ranks' losses sum to the single card's loss and
their gradients, summed over the ranks, to its gradient. The metrics
("loss", "in_batch_acc") are the global batch's on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dnn_page_vectors_tpu_torch.parallel.mesh import (
    all_gather_sum_grad, group_size)


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + eps) in float32, as the JAX package computes it
    (not F.normalize, which divides by max(norm, eps))."""
    x = x.float()
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _chunk_body(rows: torch.Tensor, pool: torch.Tensor, labels: torch.Tensor,
                scale: torch.Tensor):
    logits = scale * (rows @ pool.T)                    # [chunk, M] f32
    lse = torch.logsumexp(logits, dim=1)
    pos = logits.gather(1, labels[:, None])[:, 0]
    correct = logits.argmax(dim=1) == labels
    return lse, pos, correct


def _chunk_stats(rows: torch.Tensor, pool: torch.Tensor,
                 labels: torch.Tensor, scale: torch.Tensor, chunk: int):
    """Per-row softmax-CE statistics of `rows` scored against `pool`,
    `chunk` rows at a time: (lse [N], pos [N], correct [N]). Each chunk
    runs under torch.utils.checkpoint, so its logits tile is dropped after
    the forward and rebuilt in the backward."""
    n = rows.shape[0]
    if n % chunk:
        raise ValueError(
            f"loss chunk {chunk} must divide the (per-direction) row count "
            f"{n}: pick train.loss_chunk dividing train.batch_size")
    parts = [checkpoint(_chunk_body, rows[i:i + chunk], pool,
                        labels[i:i + chunk], scale, use_reentrant=False)
             for i in range(0, n, chunk)]
    lse, pos, corr = (torch.cat(t) for t in zip(*parts))
    return lse, pos, corr


def cosine_contrastive_loss(
    q: torch.Tensor,                      # [B, D] query vectors
    p: torch.Tensor,                      # [B, D] gold page vectors
    scale: torch.Tensor,                  # scalar inverse temperature
    neg: Optional[torch.Tensor] = None,   # [B, H, D] mined hard negatives
    symmetric: bool = True,
    chunk: int = 0,
    group=None,                           # the mesh's data group
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax contrastive loss over cosine similarities: (loss, {"loss",
    "in_batch_acc", "scale"}).

    Row i's positive is page i; its negatives are every other page of the
    batch plus, if given, all B*H mined negatives. `symmetric` adds the
    page->query direction over the in-batch block (mined negatives have no
    query side). `chunk` > 0 with chunk < B takes the chunked path (see
    the module docstring); it must divide B. With `group` (see the module
    docstring) q, p and neg are this rank's rows, the loss is their share
    of the global loss, and `chunk` must divide the rank's rows."""
    n = group_size(group)
    r = dist.get_rank(group) if n > 1 else 0
    b = q.shape[0]
    B = n * b
    qn = l2_normalize(q)
    pn = l2_normalize(p)
    q_all = all_gather_sum_grad(qn, group)                       # [B, D]
    pool = all_gather_sum_grad(pn, group)                        # [B, D]
    if neg is not None:
        nn_ = l2_normalize(neg.reshape(-1, neg.shape[-1]))       # [b*H, D]
        pool = torch.cat([pool, all_gather_sum_grad(nn_, group)])
    labels = torch.arange(r * b, (r + 1) * b, device=q.device)  # global ids
    if chunk and 0 < chunk < b:
        lse, pos, corr = _chunk_stats(qn, pool, labels, scale, chunk)
        loss = (lse - pos).sum() / B
        if symmetric:
            lse_pq, pos_pq, _ = _chunk_stats(pn, q_all, labels, scale, chunk)
            loss = 0.5 * (loss + (lse_pq - pos_pq).sum() / B)
        correct = corr.float().sum()
    else:
        logits_qp = scale * (qn @ pool.T)                        # [b, B(1+H)]
        loss = F.cross_entropy(logits_qp, labels, reduction="sum") / B
        if symmetric:
            # page -> query: on one rank the transpose of the in-batch block
            logits_pq = (logits_qp[:, :B].T if n == 1
                         else scale * (pn @ q_all.T))            # [b, B]
            loss = 0.5 * (loss + F.cross_entropy(
                logits_pq, labels, reduction="sum") / B)
        correct = (logits_qp.argmax(dim=1) == labels).float().sum()
    total = loss
    if n > 1:
        sums = torch.stack([loss.detach(), correct])
        dist.all_reduce(sums, group=group)
        total, correct = sums[0], sums[1]
    return loss, {"loss": total, "in_batch_acc": correct / B,
                  "scale": scale}
