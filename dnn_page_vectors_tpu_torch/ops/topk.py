"""Exact top-k over page vectors.

Counterpart of the JAX package's ops/topk.py: ``chunked_topk`` scores
queries against device-resident pages one chunk at a time with a float32
matmul (TF32 off: ranking fidelity depends on full precision, as the JAX
scorer's Precision.HIGHEST does) and keeps a running top-k with
``torch.topk``, so memory never holds more than one [Bq, chunk] score
block. Pages may be stored narrow (float16); each chunk is widened to
float32 as it is scored, which is exact. ``merge_topk_host`` is the host
merge of two candidate sets, copied from the JAX package.

The sharded and store-streaming variants are later slices.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def chunked_topk(q: torch.Tensor, pages: torch.Tensor, k: int = 10,
                 chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k of q @ pages.T on one device.

    q: [Bq, D] (normalized for cosine); pages: [N, D] on q's device.
    Returns (scores [Bq, k] f32, indices [Bq, k] int64) with indices into
    `pages` rows; slots without a row (N < k) score -inf with index -1."""
    if pages.device != q.device:
        raise ValueError(f"pages on {pages.device}, queries on {q.device}")
    q = q.float()
    Bq = q.shape[0]
    N = pages.shape[0]
    best_s = torch.full((Bq, k), -torch.inf, dtype=torch.float32,
                        device=q.device)
    best_i = torch.full((Bq, k), -1, dtype=torch.int64, device=q.device)
    for c0 in range(0, N, chunk):
        block = pages[c0: c0 + chunk]
        s = q @ block.float().T                                   # [Bq, n]
        ids = torch.arange(c0, c0 + block.shape[0], device=q.device)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids[None].expand(Bq, -1)], dim=1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
    # an empty slot must not report a bogus row id
    best_i = torch.where(torch.isfinite(best_s), best_i,
                         torch.full_like(best_i, -1))
    return best_s, best_i


def merge_topk_host(best_s: np.ndarray, best_i: np.ndarray,
                    new_s: np.ndarray, new_i: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side running-top-k merge of two [Nq, k] candidate sets (ids are
    global page ids; -1 = empty slot).

    O(W) argpartition down to the winning k, then an O(k log k) sort of
    just those. Ties at the selection boundary may admit a different
    equal-scored candidate than a stable full sort would (scores are
    unchanged; only which of the tied ids survives)."""
    k = best_s.shape[1]
    cat_s = np.concatenate([best_s, new_s], axis=1)
    cat_i = np.concatenate([best_i, new_i], axis=1)
    cat_s = np.where(cat_i < 0, -np.inf, cat_s)
    if cat_s.shape[1] > k:
        part = np.argpartition(-cat_s, k - 1, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(cat_s, part, axis=1),
                           axis=1, kind="stable")
        pos = np.take_along_axis(part, order, axis=1)
    else:
        pos = np.argsort(-cat_s, axis=1, kind="stable")
    return (np.take_along_axis(cat_s, pos, axis=1),
            np.take_along_axis(cat_i, pos, axis=1))
