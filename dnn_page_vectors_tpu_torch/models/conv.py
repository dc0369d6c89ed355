"""The conv towers' shared pieces: flax's ``nn.Conv`` over words with SAME
padding, and the masked global max-pool (CDSSM and Kim-CNN)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_NEG_INF = -1e9


class Conv(nn.Conv1d):
    """flax ``nn.Conv(out, kernel_size=(width,), padding="SAME",
    dtype=...)``: float32 parameters, compute in ``compute_dtype`` (input,
    kernel and bias cast to it). Tensors are channels-first, [B, C, L].
    SAME pads (width - 1) // 2 positions before and the rest after, as lax
    pads it: width 4 pads 1 before and 2 after."""

    def __init__(self, in_channels: int, out_channels: int, width: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, out_channels, width)
        self.compute_dtype = compute_dtype
        lo = (width - 1) // 2
        self.pads = (lo, width - 1 - lo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        lo, hi = self.pads
        if lo != hi:
            x, lo = F.pad(x, (lo, hi)), 0
        return F.conv1d(x, self.weight.to(dt), self.bias.to(dt), padding=lo)


def masked_max_pool(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """h [B, C, L], mask [B, L] -> [B, C]: the max over the unmasked
    positions, the masked ones filled with -1e9 in h's dtype (in bf16 that
    rounds to -999,817,216). ``amax`` splits the gradient evenly among tied
    maxima, as ``jnp.max`` does (``max(dim)`` would send it to one).
    Rows without a position pool to 0."""
    pooled = torch.amax(h.masked_fill(~mask[:, None, :], _NEG_INF), dim=2)
    return torch.where(mask.any(1, keepdim=True), pooled,
                       torch.zeros_like(pooled))
