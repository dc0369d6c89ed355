"""Transformer encoder of the BERT-mini towers (learned absolute positions,
LayerNorm, GELU MLP, pre-norm blocks, masked mean pooling, f32 projection).

Counterpart of the JAX package's models/transformer.py, variant "bert".
Parameter names follow the flax tree (``block0.attn.wq``, ``ln_final``,
``proj``, ...) so convert.py maps weights one to one. What carries over
from flax, exactly:

* parameters are float32; compute runs in ``dtype`` (bfloat16 by default):
  each Dense casts its input, weight and bias to ``dtype``;
* LayerNorm takes its statistics in float32 (flax's float32 reductions,
  fast variance E[x^2] - E[x]^2 clipped at 0), epsilon 1e-6 (torch's
  default is 1e-5), and returns ``dtype``;
* GELU is the tanh approximation (flax's ``nn.gelu`` default);
* dense attention masks with -1e9 and softmaxes in float32; flash attention
  (kernels K1-K3, ops/flash_attention.py) masks with -1e30 and returns
  float32, which is cast to ``dtype``;
* ``pos_embed`` is [max(query_len, page_len), d] float32, cast to
  ``dtype`` before the add;
* pooling and ``proj`` run in float32;
* dropout (flax ``nn.Dropout``: kept values divided by the keep rate) sits
  after the embedding, after attention and after the MLP. In training mode
  its masks are drawn from the ``torch.Generator`` the caller passes, never
  from the global RNG; the trainer seeds it from (train.seed, step), so a
  resumed run draws the same masks. Eval mode draws none. The masks'
  numbers differ from JAX's, whose generator is another.

The t5 variant, ring attention and the packed-page ``seg`` path are later
slices of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dnn_page_vectors_tpu_torch.ops.flash_attention import flash_attention

_DENSE_MASK = -1e9


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element is kept with probability
    1 - rate and divided by it, else zeroed. The mask comes from
    `generator` (on x's device), which training mode requires."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator "
                         "(masks are never drawn from the global RNG)")
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mask.bernoulli_(keep, generator=generator)
    return x * mask / keep


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 parameters, compute in
    ``compute_dtype``. The weight is stored [out, in] (torch's layout)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` (see the module docstring)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class Attention(nn.Module):
    """kind: 'dense' (materialised scores) or 'flash' (kernel K1)."""

    def __init__(self, num_heads: int, model_dim: int,
                 dtype: torch.dtype = torch.bfloat16, kind: str = "dense"):
        super().__init__()
        if kind not in ("dense", "flash"):
            raise ValueError(f"unknown attention kind {kind!r} (want dense | "
                             "flash; ring attention is a later slice)")
        if model_dim % num_heads:
            raise ValueError(f"model_dim {model_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.model_dim = model_dim
        self.dtype = dtype
        self.kind = kind
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, Dense(model_dim, model_dim,
                                      compute_dtype=dtype))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        head_dim = self.model_dim // self.num_heads
        shape = (B, L, self.num_heads, head_dim)
        q = self.wq(x).view(shape)
        k = self.wk(x).view(shape)
        v = self.wv(x).view(shape)
        if self.kind == "flash":
            # [B, L, H, Dh] -> [B, H, L, Dh] as strided views: the kernel
            # takes the strides, so no copy is made here
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), pad_mask)
            out = out.to(self.dtype).transpose(1, 2)       # [B, L, H, Dh]
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
            scores = scores.float()
            scores = scores.masked_fill(~pad_mask[:, None, None, :],
                                        _DENSE_MASK)
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.wo(out.reshape(B, L, self.model_dim))


class Block(nn.Module):
    """Pre-norm block: x + drop(attn(ln(x))); x + drop(mlp(ln(x)))."""

    def __init__(self, num_heads: int, model_dim: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_kind: str = "dense", dropout: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout
        self.ln_attn = LayerNorm(model_dim, dtype)
        self.attn = Attention(num_heads, model_dim, dtype, attention_kind)
        self.ln_mlp = LayerNorm(model_dim, dtype)
        self.wi = Dense(model_dim, mlp_dim, compute_dtype=dtype)
        self.wo_mlp = Dense(mlp_dim, model_dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout_rate if self.training else 0.0
        x = x + dropout(self.attn(self.ln_attn(x), pad_mask), rate,
                        generator)
        h = F.gelu(self.wi(self.ln_mlp(x)), approximate="tanh")
        return x + dropout(self.wo_mlp(h), rate, generator)


class TransformerEncoder(nn.Module):
    """ids [B, L] (0 = pad) -> [B, out_dim] float32."""

    def __init__(self, vocab_size: int, num_layers: int = 4,
                 num_heads: int = 4, model_dim: int = 256, mlp_dim: int = 1024,
                 out_dim: int = 256, max_len: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_kind: str = "dense", dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout
        self.num_layers = num_layers
        self.tok_embed = nn.Embedding(vocab_size, model_dim)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, model_dim))
        for i in range(num_layers):
            setattr(self, f"block{i}", Block(num_heads, model_dim, mlp_dim,
                                             dtype, attention_kind, dropout))
        self.ln_final = LayerNorm(model_dim, dtype)
        self.proj = Dense(model_dim, out_dim, compute_dtype=torch.float32)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the dropout masks in training mode."""
        L = ids.shape[1]
        pad_mask = ids > 0
        x = self.tok_embed(ids).to(self.dtype)
        x = x + self.pos_embed[:L].to(self.dtype)[None]
        x = dropout(x, self.dropout_rate if self.training else 0.0,
                    generator)
        for blk in self.blocks():
            x = blk(x, pad_mask, generator)
        x = self.ln_final(x)
        # masked mean pool, in float32
        m = pad_mask[..., None].float()
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return self.proj(pooled)
