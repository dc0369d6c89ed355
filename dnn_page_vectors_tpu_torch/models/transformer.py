"""Transformer encoder of the BERT-mini and mT5 towers: pre-norm blocks,
masked mean pooling, f32 projection, in two variants:

* ``bert``: learned absolute positions, LayerNorm, GELU MLP, biases;
* ``t5``: T5 relative-position buckets (one [32, H] table shared by every
  layer), RmsNorm, gated-GELU MLP (``wi_0``, ``wi_1``), no biases in the
  blocks (``proj`` keeps its bias).

Counterpart of the JAX package's models/transformer.py. Parameter names
follow the flax tree (``block0.attn.wq``, ``ln_final``, ``rel_bias``,
``proj``, ...) so convert.py maps weights one to one. What carries over
from flax, exactly:

* parameters are float32; compute runs in ``dtype`` (bfloat16 by default):
  each Dense casts its input, weight and bias to ``dtype``;
* LayerNorm takes its statistics in float32 (flax's float32 reductions,
  fast variance E[x^2] - E[x]^2 clipped at 0), epsilon 1e-6 (torch's
  default is 1e-5), and returns ``dtype``;
* RmsNorm takes its statistics in float32, epsilon 1e-6, and returns
  ``(y * scale)`` cast to ``dtype``;
* GELU is the tanh approximation (flax's ``nn.gelu`` default);
* the t5 bucket of a relative position is computed as the JAX package
  computes it in float32 (``relative_position_bucket``); the bias
  table[bucket] is gathered once per forward into a float32 [H, L, L]
  bias that every layer adds to its scores (dense: before the -1e9 mask;
  flash: inside the kernel). Its gradient reaches the table as a product
  with a one-hot matrix, a sum in a fixed order, so it is bitwise equal
  from run to run on the card;
* dense attention masks with -1e9 and softmaxes in float32; flash attention
  (kernels K1-K4, ops/flash_attention.py) masks with -1e30 and returns
  float32, which is cast to ``dtype``;
* ``pos_embed`` (bert) is [max(query_len, page_len), d] float32, cast to
  ``dtype`` before the add;
* pooling and ``proj`` run in float32;
* dropout (flax ``nn.Dropout``: kept values divided by the keep rate) sits
  after the embedding, after attention and after the MLP. In training mode
  its masks are drawn from the ``torch.Generator`` the caller passes, never
  from the global RNG; the trainer seeds it from (train.seed, step), so a
  resumed run draws the same masks. Eval mode draws none. The masks'
  numbers differ from JAX's, whose generator is another.

Sequence packing (train.pack_pages, data/loader.py ``pack_segments``):
``seg`` [B, L] marks which packed page each token belongs to (0 = pad,
1..nseg = page slot). Attention is restricted to within-segment pairs
(dense builds the [B, 1, L, L] block mask, flash passes ``seg`` to the
kernels), bert adds ``pos_embed[pos]`` at each page's LOCAL positions
(an embedding lookup, whose backward on the card sums in a fixed order as
``tok_embed``'s does), t5 keeps the global [H, L, L] bias (segments are
contiguous, so within a segment relative distance is global distance, and
cross-segment pairs are masked), and pooling runs per segment in float32,
returning [B, nseg, D].

Ring attention is a later slice of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dnn_page_vectors_tpu_torch.ops.flash_attention import flash_attention

_DENSE_MASK = -1e9
NUM_BUCKETS = 32
MAX_DISTANCE = 128
VARIANTS = ("bert", "t5")


def relative_position_bucket(rel_pos: np.ndarray,
                             num_buckets: int = NUM_BUCKETS,
                             max_distance: int = MAX_DISTANCE) -> np.ndarray:
    """T5 bidirectional bucketing of relative positions (key - query), as
    the JAX package computes it: the log term in float32, with its 1e-6,
    truncated toward zero, capped at the last bucket. The float32 log is
    taken as the correctly rounded float64 log, so the table does not
    depend on the machine's float32 log (the value is an exact integer at
    a distance of 64, where a log one unit low would drop a bucket)."""
    rel_pos = np.asarray(rel_pos, np.int64)
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    x = n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-6)
    log = np.log(x.astype(np.float64)).astype(np.float32)
    val = (log / np.float32(np.log(max_distance / max_exact))
           * np.float32(num_buckets - max_exact))
    val_if_large = np.minimum(max_exact + val.astype(np.int64),
                              num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_if_large)


def bucket_table(length: int) -> np.ndarray:
    """[length, length] int64: entry [l, s] is the bucket of s - l."""
    pos = np.arange(length)
    return relative_position_bucket(pos[None, :] - pos[:, None])


class _GatherBias(torch.autograd.Function):
    """table [32, H] -> bias [H, L, L] f32 with bias[h, l, s] =
    table[buckets[l, s], h]. The backward sums the bias gradient into the
    table as a product with a one-hot [L*L, 32] matrix: a fixed order, no
    atomics, so it is bitwise equal from run to run on the card (the
    backward of a plain gather, index_put_ with accumulate, may use
    atomics there)."""

    @staticmethod
    def forward(ctx, table, buckets):
        ctx.save_for_backward(buckets)
        ctx.num_buckets = table.shape[0]
        ctx.table_dtype = table.dtype
        return table[buckets].permute(2, 0, 1).float().contiguous()

    @staticmethod
    def backward(ctx, g):
        buckets, = ctx.saved_tensors
        onehot = F.one_hot(buckets.reshape(-1), ctx.num_buckets).float()
        dtable = g.float().reshape(g.shape[0], -1) @ onehot       # [H, 32]
        return dtable.t().to(ctx.table_dtype), None


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


class RmsNorm(nn.Module):
    """The JAX package's RmsNorm (see the module docstring)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(self.dtype)


class Attention(nn.Module):
    """kind: 'dense' (materialised scores) or 'flash' (kernel K1 forward;
    K2 + K3, or K4 + K3 with a bias, backward). ``use_bias``: the Dense
    layers' biases (bert has them, t5 does not)."""

    def __init__(self, num_heads: int, model_dim: int,
                 dtype: torch.dtype = torch.bfloat16, kind: str = "dense",
                 use_bias: bool = True):
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
            setattr(self, name, Dense(model_dim, model_dim, bias=use_bias,
                                      compute_dtype=dtype))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                rel_bias: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`rel_bias`: optional float32 [H, L, L], added to the scores;
        `seg`: optional [B, L] segment ids (0 = pad), which restrict the
        scores to pairs within one segment."""
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
                                  v.transpose(1, 2), pad_mask, rel_bias, seg)
            out = out.to(self.dtype).transpose(1, 2)       # [B, L, H, Dh]
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim)
            scores = scores.float()
            if rel_bias is not None:
                scores = scores + rel_bias[None]
            if seg is None:
                allowed = pad_mask[:, None, None, :]
            else:
                # block-diagonal segment mask: a token attends only inside
                # its own packed page, never to pad (seg 0)
                allowed = ((seg[:, None, :] == seg[:, :, None])
                           & (seg > 0)[:, None, :]
                           & pad_mask[:, None, :])[:, None]   # [B,1,L,L]
            scores = scores.masked_fill(~allowed, _DENSE_MASK)
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.wo(out.reshape(B, L, self.model_dim))


def _norm(variant: str, dim: int, dtype: torch.dtype) -> nn.Module:
    return RmsNorm(dim, dtype) if variant == "t5" else LayerNorm(dim, dtype)


class Block(nn.Module):
    """Pre-norm block: x + drop(attn(ln(x))); x + drop(mlp(ln(x))). The t5
    MLP is gelu(wi_0 h) * wi_1 h -> wo_mlp, with no biases."""

    def __init__(self, num_heads: int, model_dim: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_kind: str = "dense", dropout: float = 0.0,
                 variant: str = "bert"):
        super().__init__()
        self.dropout_rate = dropout
        self.variant = variant
        use_bias = variant != "t5"
        self.ln_attn = _norm(variant, model_dim, dtype)
        self.attn = Attention(num_heads, model_dim, dtype, attention_kind,
                              use_bias)
        self.ln_mlp = _norm(variant, model_dim, dtype)
        if variant == "t5":
            self.wi_0 = Dense(model_dim, mlp_dim, bias=False,
                              compute_dtype=dtype)
            self.wi_1 = Dense(model_dim, mlp_dim, bias=False,
                              compute_dtype=dtype)
        else:
            self.wi = Dense(model_dim, mlp_dim, compute_dtype=dtype)
        self.wo_mlp = Dense(mlp_dim, model_dim, bias=use_bias,
                            compute_dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rel_bias: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None) -> torch.Tensor:
        rate = self.dropout_rate if self.training else 0.0
        x = x + dropout(self.attn(self.ln_attn(x), pad_mask, rel_bias, seg),
                        rate, generator)
        h = self.ln_mlp(x)
        if self.variant == "t5":
            h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            h = F.gelu(self.wi(h), approximate="tanh")
        return x + dropout(self.wo_mlp(h), rate, generator)


class TransformerEncoder(nn.Module):
    """ids [B, L] (0 = pad) -> [B, out_dim] float32; packed rows with
    ``seg`` -> [B, nseg, out_dim] float32."""

    def __init__(self, vocab_size: int, num_layers: int = 4,
                 num_heads: int = 4, model_dim: int = 256, mlp_dim: int = 1024,
                 out_dim: int = 256, max_len: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_kind: str = "dense", dropout: float = 0.0,
                 variant: str = "bert"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown transformer variant {variant!r} "
                             f"(want {' | '.join(VARIANTS)})")
        self.dtype = dtype
        self.dropout_rate = dropout
        self.num_layers = num_layers
        self.variant = variant
        self.tok_embed = nn.Embedding(vocab_size, model_dim)
        if variant == "t5":
            self.rel_bias = nn.Parameter(torch.zeros(NUM_BUCKETS, num_heads))
            # on the module's device, so a forward copies nothing from the
            # host; [:L, :L] is the table of length L
            self.register_buffer("buckets",
                                 torch.from_numpy(bucket_table(max_len)),
                                 persistent=False)
        else:
            self.pos_embed = nn.Parameter(torch.zeros(max_len, model_dim))
        for i in range(num_layers):
            setattr(self, f"block{i}", Block(num_heads, model_dim, mlp_dim,
                                             dtype, attention_kind, dropout,
                                             variant))
        self.ln_final = _norm(variant, model_dim, dtype)
        self.proj = Dense(model_dim, out_dim, compute_dtype=torch.float32)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def forward(self, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seg: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                nseg: int = 0) -> torch.Tensor:
        """`generator` draws the dropout masks in training mode. Packed
        rows (see the module docstring): `seg` [B, L] segment ids, `pos`
        [B, L] each token's position in its page (bert), `nseg` segments a
        row; returns one vector per segment, [B, nseg, out_dim]."""
        L = ids.shape[1]
        pad_mask = ids > 0
        x = self.tok_embed(ids).to(self.dtype)
        rel_bias = None
        if self.variant == "t5":
            rel_bias = _GatherBias.apply(self.rel_bias,
                                         self.buckets[:L, :L])  # [H, L, L]
        elif pos is None:
            x = x + self.pos_embed[:L].to(self.dtype)[None]
        else:
            x = x + F.embedding(pos, self.pos_embed).to(self.dtype)
        x = dropout(x, self.dropout_rate if self.training else 0.0,
                    generator)
        for blk in self.blocks():
            x = blk(x, pad_mask, generator, rel_bias, seg)
        x = self.ln_final(x)
        if seg is not None:
            # per-segment masked mean pool, in float32: one vector per page
            if nseg <= 0:
                raise ValueError("packed rows (seg) need nseg, the "
                                 "segments a row holds")
            slots = torch.arange(1, nseg + 1, device=seg.device)
            onehot = (seg[:, :, None] == slots).float()       # [B, L, nseg]
            tot = torch.einsum("bld,bls->bsd", x.float(), onehot)
            cnt = onehot.sum(1).clamp_min(1.0)                 # [B, nseg]
            return self.proj(tot / cnt[..., None])             # [B, nseg, D]
        # masked mean pool, in float32
        m = pad_mask[..., None].float()
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return self.proj(pooled)
