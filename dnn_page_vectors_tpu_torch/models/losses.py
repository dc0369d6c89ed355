"""Loss-side helpers. This slice ports ``l2_normalize`` only; the
cosine-contrastive loss (dense and chunked) comes with the training slice.
"""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + eps) in float32, as the JAX package computes it
    (not F.normalize, which divides by max(norm, eps))."""
    x = x.float()
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)
