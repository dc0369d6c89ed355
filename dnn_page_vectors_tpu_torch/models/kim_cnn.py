"""Kim-CNN word tower: the counterpart of the JAX package's
models/kim_cnn.py.

ids [B, L] (0 = pad) -> the word embedding (id 0 embeds like any other id:
its row is trained, and the SAME convs at a page's last words see it) ->
one SAME conv per width, each followed by relu and the masked global
max-pool -> the concatenation (all-pad rows give 0) -> dropout -> ``proj``
-> float32 [B, out_dim]. Parameter names follow the flax tree
(``word_embed``, ``conv3``, ``conv4``, ..., ``proj``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dnn_page_vectors_tpu_torch.models.conv import Conv, masked_max_pool
from dnn_page_vectors_tpu_torch.models.transformer import Dense, dropout


class KimCnnEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 conv_widths: Sequence[int] = (3, 4, 5),
                 conv_channels: int = 256, out_dim: int = 256,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout
        self.conv_widths = tuple(conv_widths)
        self.word_embed = nn.Embedding(vocab_size, embed_dim)
        for w in self.conv_widths:
            setattr(self, f"conv{w}", Conv(embed_dim, conv_channels, w, dtype))
        self.proj = Dense(conv_channels * len(self.conv_widths), out_dim,
                          compute_dtype=dtype)

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seg: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                nseg: int = 0) -> torch.Tensor:
        """`generator` draws the dropout mask in training mode; packed rows
        (`seg`) are refused."""
        if seg is not None:
            raise ValueError("the kim_cnn tower takes no packed rows "
                             "(train.pack_pages needs a bert or t5 tower)")
        mask = ids > 0                                           # [B, L]
        x = self.word_embed(ids).to(self.dtype).transpose(1, 2)  # [B, E, L]
        h = torch.cat([masked_max_pool(F.relu(getattr(self, f"conv{w}")(x)),
                                       mask)
                       for w in self.conv_widths], dim=-1)       # [B, C * n]
        h = dropout(h, self.dropout_rate if self.training else 0.0,
                    generator)
        return self.proj(h).float()
