"""Bidirectional LSTM word tower: the counterpart of the JAX package's
models/lstm.py.

ids [B, L] (0 = pad) -> the word embedding -> per layer and direction the
input projection ``in_proj{l}_{dir}`` (a Dense in ``dtype``, then float32)
for all time steps at once, and the float32 recurrence over time with
``rec{l}_{dir}`` [H, 4H] (``lstm_pass``) -> between layers, both
directions' states concatenated, cast to ``dtype``, dropout -> the last
layer's final states of both directions (all-pad rows give 0) -> dropout ->
``proj`` -> float32 [B, out_dim].

The recurrence is a loop of torch ops over the time steps, as the JAX
package's is a ``lax.scan``: gates i, f, g, o, a constant +1 on the forget
gate, and a masked step (id 0, anywhere in the row) carries (h, c) through
unchanged, so the forward pass ends at the last real token and the reverse
pass at the first. cuDNN's LSTM is not this function: it takes no per-step
mask, and it projects the input itself, in its own dtype.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from dnn_page_vectors_tpu_torch.models.transformer import Dense, dropout


def lstm_pass(xp: torch.Tensor, mask: torch.Tensor, u: torch.Tensor,
              reverse: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One direction over time. xp: [B, L, 4H] float32 (input projection
    + bias), mask: [B, L] bool, u: [H, 4H] float32. Returns the final
    hidden state [B, H] and the L per-step hidden states [B, H] in time
    order."""
    B, L, _ = xp.shape
    H = u.shape[0]
    # time-major steps as separate tensors: the backward stacks their L
    # gradients once (indexing one [L, B, 4H] tensor per step would write
    # each step's gradient into a zero-filled [L, B, 4H] and add it up,
    # L^2 traffic)
    xs = xp.transpose(0, 1).contiguous().unbind(0)   # L x [B, 4H]
    ms = mask.t()[..., None].unbind(0)               # L x [B, 1]
    h = xp.new_zeros(B, H)
    c = xp.new_zeros(B, H)
    hs: List[torch.Tensor] = [h] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gates = torch.addmm(xs[t], h, u)          # xp_t + h @ u, float32
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(ms[t], h_new, h)
        c = torch.where(ms[t], c_new, c)
        hs[t] = h
    return h, hs


class LstmEncoder(nn.Module):
    """Stacked BiLSTM; hidden size ``hidden_dim`` a direction (the config's
    model_dim), depth ``num_layers``."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 hidden_dim: int = 256, num_layers: int = 1,
                 out_dim: int = 256, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout
        self.num_layers = num_layers
        H = hidden_dim
        self.word_embed = nn.Embedding(vocab_size, embed_dim)
        for layer in range(num_layers):
            d_in = embed_dim if layer == 0 else 2 * H
            for tag in ("fwd", "bwd"):
                setattr(self, f"in_proj{layer}_{tag}",
                        Dense(d_in, 4 * H, compute_dtype=dtype))
                setattr(self, f"rec{layer}_{tag}",
                        nn.Parameter(torch.zeros(H, 4 * H)))
        self.proj = Dense(2 * H, out_dim, compute_dtype=dtype)

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seg: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                nseg: int = 0) -> torch.Tensor:
        """`generator` draws the dropout masks in training mode; packed
        rows (`seg`) are refused."""
        if seg is not None:
            raise ValueError("the lstm tower takes no packed rows "
                             "(train.pack_pages needs a bert or t5 tower)")
        rate = self.dropout_rate if self.training else 0.0
        mask = ids > 0                                           # [B, L]
        x = self.word_embed(ids).to(self.dtype)                  # [B, L, E]
        for layer in range(self.num_layers):
            finals, states = [], []
            for tag, rev in (("fwd", False), ("bwd", True)):
                xp = getattr(self, f"in_proj{layer}_{tag}")(x).float()
                h, hs = lstm_pass(xp, mask, getattr(self, f"rec{layer}_{tag}"),
                                  rev)
                finals.append(h)
                states.append(hs)
            if layer < self.num_layers - 1:
                x = torch.cat([torch.stack(hs, 1) for hs in states],
                              dim=-1).to(self.dtype)             # [B, L, 2H]
                x = dropout(x, rate, generator)
        h = torch.cat(finals, dim=-1)                            # [B, 2H]
        h = torch.where(mask.any(1, keepdim=True), h, torch.zeros_like(h))
        h = dropout(h, rate, generator)
        return self.proj(h.to(self.dtype)).float()
