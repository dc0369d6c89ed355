"""Ring attention: exact attention over a sequence split across the
mesh's seq group.

Counterpart of the JAX package's parallel/ring_attention.py, whose body
is jnp code (no Pallas kernel): here it is torch ops. Each rank of the
seq group holds a block of L_loc = L / n consecutive tokens of every row
and keeps its query block. The key/value block and its mask travel
around the ring (``dist.batch_isend_irecv``: rank i sends to i + 1 and
receives from i - 1), and the rank folds each block into online-softmax
statistics in float32 (running max m, denominator l, accumulator), as
the JAX body does. After n steps it holds the exact attention of its
queries over the whole sequence.

As in the JAX body, a masked score is -1e30 and the output is acc /
max(l, 1e-30): a row whose keys are all masked, across the whole ring,
gets p = 1 at every key and so the mean of V over every key of the row.

T5's relative-position bias: the global [H, L, L] bias would bring back
the memory the ring saves, so each step rebuilds its [L_loc, L_loc] block
from global positions: at step t rank i holds the block of rank
(i - t) mod n, so both sides' offsets are known, and ``bucket_fn`` maps
their distances to bucket ids, which index the [num_buckets, H] table.

The backward (``torch.autograd.Function``) runs the rotation again with
the forward's final m and l: each step rebuilds p = exp(s - m) / l,
adds this rank's queries' share to the dK/dV accumulators of the block it
holds, and the accumulators travel with their block, one hop past the
last step, which brings each home. The bias table's gradient is this
rank's queries' share, a product with a one-hot matrix (a fixed order).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dnn_page_vectors_tpu_torch.parallel.mesh import group_size

NEG_INF = -1e30


def local_block(length: int, n: int, index: int) -> slice:
    """The tokens [lo, hi) of rank `index` of a seq group of `n` ranks;
    raises, as the JAX package does, where `length` does not divide."""
    if length % n:
        raise ValueError(
            f"ring attention: sequence length {length} must be divisible "
            f"by mesh axis 'seq' of size {n}; pad data.page_len/query_len "
            "to a multiple of mesh.seq")
    width = length // n
    return slice(index * width, (index + 1) * width)


def _rotate(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor of this rank goes to the next rank of the ring; returns
    the previous rank's."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n)
    frm = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group))
        ops.append(dist.P2POp(dist.irecv, o, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _bias_block(table: torch.Tensor, bucket_fn: Callable, me: int,
                src: int, L: int) -> torch.Tensor:
    """[H, L, L] float32 bias of this rank's queries against the keys of
    ring position `src`, and the [L, L] bucket ids behind it."""
    pos = torch.arange(L, device=table.device)
    rel = (src * L + pos)[None, :] - (me * L + pos)[:, None]
    buckets = bucket_fn(rel)
    return table[buckets].permute(2, 0, 1).float(), buckets


def _scores(qf, k, mask, table, bucket_fn, me, src):
    s = qf @ k.float().transpose(-1, -2)                      # [B, H, L, L]
    buckets = None
    if table is not None:
        bias, buckets = _bias_block(table, bucket_fn, me, src, qf.shape[2])
        s = s + bias[None]
    return s.masked_fill(~mask.bool()[:, None, None, :], NEG_INF), buckets


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, table, kv_mask, group, bucket_fn):
        n = group_size(group)
        me = 0 if n == 1 else dist.get_rank(group)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float() * scale
        m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        blocks = [k.contiguous(), v.contiguous(),
                  kv_mask.to(torch.uint8).contiguous()]
        for t in range(n):
            k_cur, v_cur, mask_cur = blocks
            s, _ = _scores(qf, k_cur, mask_cur, table, bucket_fn, me,
                           (me - t) % n)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + p @ v_cur.float()
            m = m_new
            if t < n - 1:
                blocks = _rotate(blocks, group)
        out = acc / l.clamp_min(1e-30)[..., None]
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l,
                              *([] if table is None else [table]))
        ctx.group, ctx.bucket_fn, ctx.has_table = group, bucket_fn, \
            table is not None
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, m, l, *rest = ctx.saved_tensors
        table = rest[0] if ctx.has_table else None
        group, bucket_fn = ctx.group, ctx.bucket_fn
        n = group_size(group)
        me = 0 if n == 1 else dist.get_rank(group)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float() * scale
        dout = g.float()
        delta = (dout * out).sum(-1, keepdim=True)            # [B, H, L, 1]
        inv_l = 1.0 / l.clamp_min(1e-30)[..., None]
        dq = torch.zeros_like(qf)
        dtable = None if table is None else torch.zeros(
            table.shape, dtype=torch.float32, device=table.device)
        blocks = [k.contiguous(), v.contiguous(),
                  kv_mask.to(torch.uint8).contiguous()]
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(n):
            k_cur, v_cur, mask_cur = blocks
            s, buckets = _scores(qf, k_cur, mask_cur, table, bucket_fn, me,
                                 (me - t) % n)
            p = torch.exp(s - m[..., None]) * inv_l
            dv_cur = dv_cur + p.transpose(-1, -2) @ dout
            ds = p * (dout @ v_cur.float().transpose(-1, -2) - delta)
            # the masked scores are constants (jnp.where in JAX)
            ds = ds.masked_fill(~mask_cur.bool()[:, None, None, :], 0.0)
            dq = dq + ds @ k_cur.float()
            dk_cur = dk_cur + ds.transpose(-1, -2) @ qf
            if table is not None:
                onehot = F.one_hot(buckets.reshape(-1),
                                   table.shape[0]).float()    # [L*L, nb]
                dbias = ds.sum(0).reshape(ds.shape[1], -1)     # [H, L*L]
                dtable = dtable + (dbias @ onehot).t()
            if n > 1:
                # the accumulators travel with their block; one hop past
                # the last step brings each home
                moving = [dk_cur, dv_cur] + (blocks if t < n - 1 else [])
                moved = _rotate(moving, group)
                dk_cur, dv_cur = moved[:2]
                if t < n - 1:
                    blocks = moved[2:]
        return (dq * scale).to(q.dtype), dk_cur.to(k.dtype), \
            dv_cur.to(v.dtype), \
            None if table is None else dtable.to(table.dtype), \
            None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, group=None,
                   bias_table: Optional[torch.Tensor] = None,
                   bucket_fn: Optional[Callable] = None) -> torch.Tensor:
    """Exact attention of this rank's queries over the whole sequence.

    q, k, v: [B, H, L_loc, Dh], this rank's blocks of the seq group
    `group` (None: one rank, the whole sequence); kv_mask: [B, L_loc]
    bool. `bias_table` [num_buckets, H] and `bucket_fn` (int64 tensor of
    key - query distances -> bucket ids) give the T5 variant, and come
    together. Returns [B, H, L_loc, Dh] float32."""
    if (bias_table is None) != (bucket_fn is None):
        raise ValueError("bias_table and bucket_fn must be given together")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"ring attention takes blocks of one length: q "
                         f"{q.shape[2]}, k {k.shape[2]}")
    return _RingAttention.apply(q, k, v, bias_table, kv_mask, group,
                                bucket_fn)
