"""Cosine-contrastive loss with in-batch (and optional mined hard)
negatives, and ``l2_normalize``.

Counterpart of the JAX package's models/losses.py. Two implementations of
the same math:

* dense (``chunk=0``): the [B, B(1+H)] logits exist at once;
* chunked (``chunk > 0``, train.loss_chunk): query rows are scored
  against the negative pool ``chunk`` rows at a time, each chunk under
  ``torch.utils.checkpoint``, so only one [chunk, M] logits tile lives at
  a time in the forward and the backward rebuilds it from the [chunk, D]
  inputs. The softmax cross-entropy is exactly lse - positive logit, so
  the two agree to float32 rounding.

One process, one card: the batch is the whole global batch (data
parallelism with gathered negatives is a later slice).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax contrastive loss over cosine similarities: (loss, {"loss",
    "in_batch_acc", "scale"}).

    Row i's positive is page i; its negatives are every other page of the
    batch plus, if given, all B*H mined negatives. `symmetric` adds the
    page->query direction over the in-batch block (mined negatives have no
    query side). `chunk` > 0 with chunk < B takes the chunked path (see
    the module docstring); it must divide B."""
    qn = l2_normalize(q)
    pn = l2_normalize(p)
    B = q.shape[0]
    labels = torch.arange(B, device=q.device)
    if chunk and 0 < chunk < B:
        pool = pn
        if neg is not None:
            nn_ = l2_normalize(neg.reshape(-1, neg.shape[-1]))    # [B*H, D]
            pool = torch.cat([pn, nn_], dim=0)                    # [B+BH, D]
        lse, pos, corr = _chunk_stats(qn, pool, labels, scale, chunk)
        loss_qp = (lse - pos).mean()
        if symmetric:
            lse_pq, pos_pq, _ = _chunk_stats(pn, qn, labels, scale, chunk)
            loss = 0.5 * (loss_qp + (lse_pq - pos_pq).mean())
        else:
            loss = loss_qp
        in_batch_acc = corr.float().mean()
        return loss, {"loss": loss, "in_batch_acc": in_batch_acc,
                      "scale": scale}
    logits = scale * (qn @ pn.T)                                  # [B, B]
    if neg is not None:
        nn_ = l2_normalize(neg.reshape(-1, neg.shape[-1]))        # [B*H, D]
        extra = scale * (qn @ nn_.T)                              # [B, B*H]
        logits_qp = torch.cat([logits, extra], dim=1)             # [B, B+BH]
    else:
        logits_qp = logits
    loss_qp = F.cross_entropy(logits_qp, labels)
    if symmetric:
        loss = 0.5 * (loss_qp + F.cross_entropy(logits.T, labels))
    else:
        loss = loss_qp
    in_batch_acc = (logits_qp.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss, "in_batch_acc": in_batch_acc,
                  "scale": scale}
