"""CDSSM char-trigram tower: the counterpart of the JAX package's
models/cdssm.py.

ids [B, L, K] (hashed trigram ids, 0 = pad) -> the trigram embedding
multiplied by the mask ``ids > 0`` and summed over K in float32, rounded
to ``dtype`` (a gather and a masked sum, whose backward on the card sums
in a fixed order; ``F.embedding_bag``'s does not) -> a SAME conv over
words, tanh -> the masked global max-pool (all-pad rows give 0) ->
``proj``, tanh -> float32 [B, out_dim]. Parameter names follow the flax
tree (``trigram_embed``, ``conv``, ``proj``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dnn_page_vectors_tpu_torch.models.conv import Conv, masked_max_pool
from dnn_page_vectors_tpu_torch.models.transformer import Dense


class CdssmEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 conv_width: int = 3, conv_channels: int = 256,
                 out_dim: int = 128, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.trigram_embed = nn.Embedding(vocab_size, embed_dim)
        self.conv = Conv(embed_dim, conv_channels, conv_width, dtype)
        self.proj = Dense(conv_channels, out_dim, compute_dtype=dtype)

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seg: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                nseg: int = 0) -> torch.Tensor:
        """`generator` is unused (the tower has no dropout); packed rows
        (`seg`) are refused."""
        if seg is not None:
            raise ValueError("the cdssm tower takes no packed rows "
                             "(train.pack_pages needs a bert or t5 tower)")
        tg_mask = ids > 0                                        # [B, L, K]
        emb = self.trigram_embed(ids).to(self.dtype)             # [B, L, K, E]
        word = (emb * tg_mask[..., None].to(self.dtype)).sum(
            2, dtype=torch.float32).to(self.dtype)               # [B, L, E]
        h = torch.tanh(self.conv(word.transpose(1, 2)))          # [B, C, L]
        pooled = masked_max_pool(h, tg_mask.any(-1))             # [B, C]
        return torch.tanh(self.proj(pooled)).float()
