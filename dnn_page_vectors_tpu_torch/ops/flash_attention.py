"""Flash attention for the transformer towers: the wrappers of kernel K1
(forward, ``csrc/flash_fwd.cu``) and kernels K2, K3 and K4 (backward,
``csrc/flash_bwd.cu``), the ``torch.autograd.Function`` that joins them,
and their plain PyTorch versions.

K1 replaces the JAX package's Pallas TPU kernel ``_flash_kernel``
(dnn_page_vectors_tpu/ops/flash_attention.py, ``_flash_forward``):
bidirectional, padding-masked attention with an optional additive bias
(T5 relative positions) and optional packed-page segment ids, returning
out [B,H,L,Dh] f32 and the row log-sum-exp [B,H,L] f32. A fully masked
row returns mean(V) (scores are masked with the finite -1e30).

The backward rebuilds the probabilities from the saved lse, so no
[B,H,L,S] array exists in it either. Without a bias it is K2 (dq,
replacing ``_flash_dq_kernel``) then K3 (dk and dv, replacing
``_flash_dkv_kernel``); with a bias it is K4 (dq and dbias[h,l,s] =
sum_b ds[b,h,l,s], replacing ``_flash_dq_dbias_kernel``) then K3 with the
bias, as the JAX package does. At a fully masked row they give the
gradient of the forward above (dv gets g/S for every key, and the row
adds nothing to dq, dk or dbias), not the TPU kernels' p = 1. All four
take the packed pages' segment ids ``seg`` (sequence packing); a pad row
of a packed row (seg 0) sees no key, so it is such a fully masked row.
With segment ids the bf16 K1, K2, K3 and K4 visit only the tiles that
share a segment: in the forward a small kernel first writes each batch
row's segment summary (``seg_summary``: the range of segment ids > 0 in
every 16 positions), which the backward takes over, and the mean of V
over every key (``value_mean``), which K1 writes at its fully masked
rows instead of visiting every KV tile for them; in the backward another
writes the sum of g over the fully masked rows (``dead_rows_sum``),
whose dv term K3 adds once instead of visiting every Q tile for it.

Routing is by the tensors' device: a CUDA tensor goes to a kernel (or
the wrapper raises), a CPU tensor goes to the plain version
``reference_forward`` / ``reference_backward``. On the card each of K1,
K2, K3 and K4 has two kernels, chosen by the dtype of q, k and v: bf16
(every launch of the serving and training paths) takes the tensor-core
kernel (``mma.sync``, bf16 tiles filled by ``cp.async``), f32 the
CUDA-core one, whose f32 arithmetic the f32 tolerances need. (One shape
rule: the bf16 K4 holds a [Q tile, S] bias tile and partial dbias in
shared memory, so a bf16 backward with a bias over more than
``MAX_TC_DBIAS_KEYS`` keys runs the f32 K4 on f32 copies of q, k and v.)
Each wrapper launches with the tensors' card made the current device, so
a tower on a card that is not the current one launches there. Nothing
catches a kernel failure and carries on.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# lse of a fully masked row is -1e30 + log(S), which rounds to -1e30 in f32
MASKED_ROW_LSE = -1e29
MAX_HEAD_DIM = 128
_SOURCE = "flash_fwd.cu"
_BWD_SOURCE = "flash_bwd.cu"

# batch rows whose ds one K4 block sums into its partial dbias (K4's
# second launch sums the partials in order)
DBIAS_GROUP = 8
# positions of one entry of the segment summary, and the range of an entry
# that holds no segment id > 0 (it overlaps no range)
SEG_GRANULE = 16
NO_SEG = (2 ** 31 - 1, 0)
# the warps of the summary kernel, each summing every 4th key of V for the
# dead rows' mean (csrc/flash_fwd.cu, tc::kSumWarps)
VMEAN_WARPS = 4
# the longest S the bf16 K4 takes (csrc/flash_bwd.cu, tcq::kMaxBiasKeys)
MAX_TC_DBIAS_KEYS = 512

# Launches of K1, K2, K3 and K4 since the last reset: each wrapper adds one
# where it launches its kernel and nowhere else. chip_smoke.py sets them to
# 0 before driving a path and reads them after. Each also counts by kernel:
# `_tc` the bf16 tensor-core kernel, `_f32` the CUDA-core one; and `_seg`
# the launches with segment ids, of either.
launches = 0
launches_tc = 0
launches_f32 = 0
launches_seg = 0
dq_launches = 0
dq_launches_tc = 0
dq_launches_f32 = 0
dq_launches_seg = 0
dkv_launches = 0
dkv_launches_tc = 0
dkv_launches_f32 = 0
dkv_launches_seg = 0
dq_dbias_launches = 0
dq_dbias_launches_tc = 0
dq_dbias_launches_f32 = 0
dq_dbias_launches_seg = 0
# launches of the segment summary kernel (once per bf16 K1 with seg, whose
# summary the backward takes over) and of the dead rows' g sum (once per
# bf16 backward with seg)
seg_summary_launches = 0
gdead_launches = 0
COUNTERS = ("launches", "launches_tc", "launches_f32", "launches_seg",
            "dq_launches", "dq_launches_tc", "dq_launches_f32",
            "dq_launches_seg", "dkv_launches", "dkv_launches_tc",
            "dkv_launches_f32", "dkv_launches_seg", "dq_dbias_launches",
            "dq_dbias_launches_tc", "dq_dbias_launches_f32",
            "dq_dbias_launches_seg", "seg_summary_launches",
            "gdead_launches")


def _count(name: str, tensor_cores: bool, seg) -> None:
    """One launch of the kernel counted by `name`: the total, the kernel
    (`_tc` or `_f32`) and, with segment ids, `_seg`."""
    counts = globals()
    counts[name] += 1
    counts[name + ("_tc" if tensor_cores else "_f32")] += 1
    if seg is not None:
        counts[name + "_seg"] += 1


def allowed_pairs(kv_mask: torch.Tensor, seg: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """[B, 1, 1 or L, S] bool: the (row, key) pairs a score counts at: a
    real key and, with segment ids, a key of the row's own segment
    (> 0)."""
    allowed = kv_mask.bool()[:, None, None, :]
    if seg is not None:
        allowed = allowed & ((seg[:, :, None] == seg[:, None, :])
                             & (seg > 0)[:, None, :])[:, None]
    return allowed


def seg_summary(seg: torch.Tensor) -> torch.Tensor:
    """Plain version of the segment summary: [B, ceil(L / 16), 2] int32,
    for every 16 positions of every batch row the smallest and largest
    segment id > 0 there, or NO_SEG where there is none. Two ranges that
    do not overlap hold no equal id, whatever order the ids come in."""
    B, L = seg.shape
    n = -(-L // SEG_GRANULE)
    ids = torch.nn.functional.pad(seg.long(), (0, n * SEG_GRANULE - L))
    ids = ids.view(B, n, SEG_GRANULE)
    live = ids > 0
    lo = torch.where(live, ids, torch.full_like(ids, NO_SEG[0])).amin(-1)
    hi = torch.where(live, ids, torch.full_like(ids, NO_SEG[1])).amax(-1)
    return torch.stack([lo, hi], -1).to(torch.int32)


def value_mean(v: torch.Tensor, kv_mask: torch.Tensor, seg: torch.Tensor
               ) -> torch.Tensor:
    """Plain version of vmean [B, H, Dh] f32, what K1 with segment ids
    writes at a fully masked row (whose scores are all -1e30, so its
    softmax is uniform over the S keys): the mean of v [B, H, S, Dh] over
    every key, where the batch row can hold such a row (seg [B, S] holds a
    0 there, or kv_mask a masked key: a segment whose keys are all masked
    sees no key), else 0. Summed as the summary kernel sums it, in f32:
    VMEAN_WARPS partial sums, the i-th over keys i, i + VMEAN_WARPS, ...
    in order, added in that order and divided by S, so the two agree
    exactly (up to the sign of a zero)."""
    S = v.shape[2]
    parts = []
    for w in range(VMEAN_WARPS):
        acc = torch.zeros(v.shape[:2] + v.shape[3:], device=v.device)
        for key in range(w, S, VMEAN_WARPS):
            acc = acc + v[:, :, key].float()
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    # a tensor divisor: CUDA takes a CPU scalar divisor as a reciprocal
    mean = total / torch.tensor(float(S), device=v.device)
    can_die = ((seg <= 0) | ~kv_mask.bool()).any(-1)[:, None, None]
    return torch.where(can_die, mean, torch.zeros((), device=v.device))


def dead_rows_sum(g: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Plain version of gdead [B, H, Dh] f32: the sum of g [B, H, L, Dh]
    over the fully masked rows (lse <= MASKED_ROW_LSE), whose p = 1/S at
    every key gives each key's dv gdead / S. Summed in f32 in row order,
    as the kernel sums it, so the two agree exactly (up to the sign of a
    zero)."""
    dead = (lse <= MASKED_ROW_LSE)[..., None]
    zero = torch.zeros((), device=g.device)
    acc = torch.zeros(g.shape[:2] + g.shape[3:], device=g.device)
    for row in range(g.shape[2]):
        acc = acc + torch.where(dead[:, :, row], g[:, :, row].float(), zero)
    return acc


def tile_shapes(L: int, S: int, bias: bool) -> dict:
    """The tiles the bf16 kernels take at this shape, as csrc/flash_fwd.cu
    and csrc/flash_bwd.cu choose them (``kernel_tile_shapes`` reads the
    libraries' choice; the two are held equal on the card): {"k1": (query
    rows, keys) of K1's Q tile and KV tile, "k2": the same of K2's (absent
    with a bias), "k4": of K4's (with a bias only: K4 replaces K2), "k3":
    (query rows, keys) of K3's Q tile and key block}."""
    k3_rows = 32 if bias and L > 32 else (64 if L >= 64 else -(-L // 16) * 16)
    k1_keys = 32 if bias and S > 32 else (64 if S >= 64 else -(-S // 16) * 16)
    shapes = {"k1": (16 if L <= 16 else (32 if L <= 32 else 64), k1_keys),
              "k3": (k3_rows, 16 if S <= 16 else (32 if S <= 32 else 64))}
    dq_keys = 16 if S <= 16 else 32
    if bias:
        shapes["k4"] = (16 if L <= 16 else 32, dq_keys)
    else:
        shapes["k2"] = (16 if L <= 16 else (32 if L <= 32 else 64), dq_keys)
    return shapes


def _spans(summary: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(lo, hi) [B, tiles] of the tiles of n positions (a multiple of
    16): the union of their granules' ranges."""
    B, g = summary.shape[:2]
    per = n // SEG_GRANULE
    pad = -g % per
    lo = torch.nn.functional.pad(summary[..., 0], (0, pad), value=NO_SEG[0])
    hi = torch.nn.functional.pad(summary[..., 1], (0, pad), value=NO_SEG[1])
    return lo.view(B, -1, per).amin(-1), hi.view(B, -1, per).amax(-1)


def visited_tiles(summary: torch.Tensor, rows: int, keys: int
                  ) -> torch.Tensor:
    """[B, query tiles, key tiles] bool: the tiles of `rows` query rows by
    `keys` keys that the skipping kernels visit, by their rule: the two
    tiles' ranges overlap. At rows = keys = 16 these are the 16 x 16
    chunks that the warps compute inside a visited tile."""
    rlo, rhi = _spans(summary, rows)
    klo, khi = _spans(summary, keys)
    return ((rlo[:, :, None] <= khi[:, None, :])
            & (klo[:, None, :] <= rhi[:, :, None]))


def reference_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      seg: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention, the kernel's oracle: (out [B,H,L,Dh] f32, lse
    [B,H,L] f32). Follows the JAX package's ``reference_attention``: scores
    in f32, bias added, disallowed pairs set to -1e30, softmax in f32, and
    the probabilities cast to v's dtype before the product with v.

    q: [B,H,L,Dh]; k, v: [B,H,S,Dh]; kv_mask: [B,S] (True = real token);
    bias: optional [H,L,S]; seg: optional [B,L] (L == S) segment ids,
    0 = pad, which restrict scores to within-segment pairs."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[None].float()
    s = torch.where(allowed_pairs(kv_mask, seg), s,
                    torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhls,bhsd->bhld", p.to(v.dtype).float(), v.float())
    return out, lse


def reference_attention(q, k, v, kv_mask, bias=None, seg=None) -> torch.Tensor:
    """Plain attention output [B,H,L,Dh] f32 (see reference_forward)."""
    return reference_forward(q, k, v, kv_mask, bias, seg)[0]


def reference_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_mask: torch.Tensor, g: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       seg: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Plain backward of ``reference_forward`` with an optional bias and
    optional segment ids, the oracle of K2, K3 and K4: (dq, dk, dv, dbias)
    in the dtypes of q, k, v and the bias (dbias is None without a bias).

    It computes what the kernels compute: p is rebuilt from the saved
    ``lse`` as exp(scale * q.k + bias - lse), zero at a masked key (with
    ``seg``, also at a key of another segment or a pad key);
    delta = sum(g * out) per row; ds = p * (g.v - delta); dq = scale *
    ds.k, dk = scale * ds^T.q, dv = p^T.g, dbias = sum over the batch of
    ds, all in float32. A fully masked row (lse <= -1e29: every score was
    -1e30, so the forward's softmax was uniform) gets p = 1/S for every key
    and ds = 0, which is the gradient of the forward (``jax.grad`` of the
    reference attention agrees), not the TPU kernels' p = 1. With ``seg``
    every pad row of a packed row (seg 0) is such a row."""
    S = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = (gf * out.float()).sum(-1)                        # [B,H,L]
    s = torch.einsum("bhld,bhsd->bhls", qf, kf) * scale
    if bias is not None:
        s = s + bias[None].float()
    allowed = allowed_pairs(kv_mask, seg)
    masked_row = (lse <= MASKED_ROW_LSE)[..., None]           # [B,H,L,1]
    p = torch.where(allowed, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    p = torch.where(masked_row, torch.full_like(p, 1.0 / S), p)
    dp = torch.einsum("bhld,bhsd->bhls", gf, vf)
    ds = torch.where(allowed & ~masked_row, p * (dp - delta[..., None]),
                     torch.zeros_like(p))
    dq = torch.einsum("bhls,bhsd->bhld", ds, kf) * scale
    dk = torch.einsum("bhls,bhld->bhsd", ds, qf) * scale
    dv = torch.einsum("bhls,bhld->bhsd", p, gf)
    dbias = None if bias is None else ds.sum(0).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check(q, k, v, kv_mask, bias, seg):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, len, Dh]")
    B, H, L, Dh = q.shape
    S = k.shape[2]
    if k.shape != (B, H, S, Dh) or v.shape != (B, H, S, Dh):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [{B}, {H}, S, {Dh}]")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, "
                        f"bfloat16 or float32 (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if Dh % 8 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {Dh} must be a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    if min(B, H, L, S) <= 0 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: unsupported shape B={B} H={H} "
                         f"L={L} S={S}")
    if kv_mask.shape != (B, S):
        raise ValueError(f"flash_attention: kv_mask is "
                         f"{tuple(kv_mask.shape)}, want ({B}, {S})")
    if bias is not None and bias.shape != (H, L, S):
        raise ValueError(f"flash_attention: bias is {tuple(bias.shape)}, "
                         f"want ({H}, {L}, {S})")
    if seg is not None and (L != S or seg.shape != (B, L)):
        raise ValueError(f"flash_attention: seg is {tuple(seg.shape)}, want "
                         f"({B}, {L}) with L == S")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_mask", kv_mask),
                    ("bias", bias), ("seg", seg)):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on "
                             "the head dim")


def _mask_bytes(kv_mask: torch.Tensor) -> torch.Tensor:
    """The kv mask as one byte per key, nonzero = a real key, as the
    kernels read it: a contiguous bool or uint8 mask as it is (a bool is
    stored as the byte 0 or 1), any other one converted. Serving and
    training pass a bool mask, so no call converts it on the card."""
    if kv_mask.dtype in (torch.bool, torch.uint8) and kv_mask.is_contiguous():
        return kv_mask
    return kv_mask.to(torch.uint8).contiguous()


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a contiguous copy of it when its base or one of its (batch,
    head, row) strides is not a multiple of 16 bytes: the tensor-core
    kernels copy rows in 16-byte pieces."""
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(st % per16 == 0
                                      for st in t.stride()[:-1]):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format
                            ).copy_(t)


def _seg_ids(seg: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Segment ids as the kernels read them: int32, contiguous (the batcher
    makes them so; anything else is converted)."""
    return None if seg is None else seg.to(torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch_forward(q, k, v, kv_mask, bias=None, seg=None, summary=None,
                   vmean=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the current stream (CUDA tensors only): (out [B,H,L,Dh] f32,
    lse [B,H,L] f32). bf16 q/k/v take the tensor-core kernel, f32 the
    CUDA-core one. With `seg` the bf16 kernel visits only the KV tiles
    that share a segment with its Q tile, by `summary`, and its fully
    masked rows take `vmean` (``launch_seg_summary``'s, for the same seg,
    kv_mask and v, which it requires)."""
    lib = _library()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
        if seg is not None and (summary is None or vmean is None):
            raise ValueError("launch_forward: bf16 q/k/v with seg need the "
                             "segment summary and vmean (launch_seg_summary)")
    B, H, L, Dh = q.shape
    S = k.shape[2]
    mask_u8 = _mask_bytes(kv_mask)
    bias_f = None if bias is None else bias.float().contiguous()
    seg_i = _seg_ids(seg)
    out = torch.empty((B, H, L, Dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    # the bf16 kernel also takes the summary and vmean
    extra = (_ptr(summary), _ptr(vmean)) if tensor_cores else ()
    fn = lib.flash_fwd_bf16 if tensor_cores else lib.flash_fwd_f32
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
                 _ptr(bias_f), _ptr(seg_i), *extra, out.data_ptr(),
                 lse.data_ptr(), B, H, L, S, Dh, 1.0 / math.sqrt(Dh), strides,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    _count("launches", tensor_cores, seg)
    return out, lse


def launch_seg_summary(seg, kv_mask, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The segment summary kernel on the current stream (CUDA tensors
    only): (summary [B, ceil(L/16), 2] int32, as ``seg_summary``, which
    the bf16 K1, K2 and K3 take with segment ids `seg` [B, L]; vmean [B,
    H, Dh] f32, as ``value_mean`` of bf16 `v` [B, H, L, Dh] and `kv_mask`
    [B, L], which K1 writes at its fully masked rows)."""
    lib = _library()
    seg_i = _seg_ids(seg)
    v, mask_u8 = _aligned16(v), _mask_bytes(kv_mask)
    B, H, L, Dh = v.shape
    summary = torch.empty((B, -(-L // SEG_GRANULE), 2), dtype=torch.int32,
                          device=v.device)
    vmean = torch.empty((B, H, Dh), dtype=torch.float32, device=v.device)
    strides = (ctypes.c_longlong * 3)(*v.stride()[:3])
    with torch.cuda.device(v.device):
        err = lib.flash_fwd_seg_summary(
            seg_i.data_ptr(), mask_u8.data_ptr(), v.data_ptr(),
            summary.data_ptr(), vmean.data_ptr(), B, H, L, Dh, strides,
            torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_seg_summary kernel launch failed: "
                           f"CUDA error {err}")
    global seg_summary_launches
    seg_summary_launches += 1
    return summary, vmean


def _launch(q, k, v, kv_mask, bias, seg):
    """K1 (after the segment summary kernel for bf16 q/k/v with seg):
    (out, lse, the summary or None)."""
    summary = vmean = None
    if seg is not None and q.dtype == torch.bfloat16:
        summary, vmean = launch_seg_summary(seg, kv_mask, v)
    out, lse = launch_forward(q, k, v, kv_mask, bias, seg, summary, vmean)
    return out, lse, summary


def _library():
    from dnn_page_vectors_tpu_torch.ops.build import load_library
    lib = load_library(_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    tail = [I] * 5 + [ctypes.c_float, strides, P]
    for fn, nptr in ((lib.flash_fwd_bf16, 10), (lib.flash_fwd_f32, 8)):
        if fn.argtypes is None:
            fn.argtypes = [P] * nptr + tail
            fn.restype = ctypes.c_int
    fn = lib.flash_fwd_seg_summary
    if fn.argtypes is None:      # seg, kv_mask, v, summary, vmean, B, H, L, Dh
        fn.argtypes = [P] * 5 + [I] * 4 + [strides, P]
        fn.restype = I
    fn = lib.flash_fwd_tc_tiles
    if fn.argtypes is None:      # L, S, bias, tiles[2]
        fn.argtypes = [I] * 3 + [ctypes.POINTER(I)]
        fn.restype = None
    return lib


def _bwd_library():
    from dnn_page_vectors_tpu_torch.ops.build import load_library
    lib = load_library(_BWD_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    # (B, H, L, S, Dh, scale), then K4's group
    tail = [I, I, I, I, I, ctypes.c_float]
    strides = ctypes.POINTER(ctypes.c_longlong)
    for fn, nptr, tail_ in ((lib.flash_bwd_dq_bf16, 11, tail),
                            (lib.flash_bwd_dq_f32, 10, tail),
                            (lib.flash_bwd_dkv_bf16, 13, tail),
                            (lib.flash_bwd_dkv_f32, 11, tail),
                            (lib.flash_bwd_dq_dbias_bf16, 14, tail + [I]),
                            (lib.flash_bwd_dq_dbias_f32, 13, tail + [I])):
        if fn.argtypes is None:
            fn.argtypes = [P] * nptr + tail_ + [strides, P]
            fn.restype = ctypes.c_int
    fn = lib.flash_bwd_dq_tc_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [I] * 5
        fn.restype = I
    fn = lib.flash_bwd_gdead
    if fn.argtypes is None:      # lse, g, gdead, B, H, L, Dh
        fn.argtypes = [P] * 3 + [I] * 4 + [strides, P]
        fn.restype = I
    fn = lib.flash_bwd_tc_tiles
    if fn.argtypes is None:      # L, S, bias, tiles[6]
        fn.argtypes = [I] * 3 + [ctypes.POINTER(I)]
        fn.restype = None
    return lib


def kernel_tile_shapes(L: int, S: int, bias: bool) -> dict:
    """``tile_shapes`` as the compiled libraries choose the tiles (it needs
    the CUDA build)."""
    tiles = (ctypes.c_int * 6)()
    _library().flash_fwd_tc_tiles(L, S, int(bias), tiles)
    shapes = {"k1": (tiles[0], tiles[1])}
    _bwd_library().flash_bwd_tc_tiles(L, S, int(bias), tiles)
    shapes["k3"] = (tiles[0], tiles[1])
    if bias:
        shapes["k4"] = (tiles[4], tiles[5])
    else:
        shapes["k2"] = (tiles[2], tiles[3])
    return shapes


def dq_blocks_per_sm(dbias: bool, seg: bool, L: int, S: int, Dh: int,
                     device) -> int:
    """Blocks of the bf16 K2 (or K4 with `dbias`, with segment ids with
    `seg`) that one SM of `device` holds at this shape (the occupancy
    query; 0 when it fails)."""
    with torch.cuda.device(device):
        return _bwd_library().flash_bwd_dq_tc_blocks_per_sm(
            int(dbias), int(seg), L, S, Dh)


def _bwd_common(q, k):
    """(B, H, L, S, Dh, scale) as K2, K3 and K4 take them."""
    B, H, L, Dh = q.shape
    return B, H, L, k.shape[2], Dh, 1.0 / math.sqrt(Dh)


def _bwd_strides(*tensors):
    return (ctypes.c_longlong * 21)(
        *(st for t in tensors for st in t.stride()[:3]))


def launch_dead_rows_sum(lse, g) -> torch.Tensor:
    """The dead rows' g sum on the current stream (CUDA tensors only):
    gdead [B, H, Dh] f32, as ``dead_rows_sum`` (summed in row order), which
    the bf16 K3 takes with segment ids, for K1's lse [B, H, L] and the
    upstream gradient g [B, H, L, Dh]."""
    lib = _bwd_library()
    lse = lse.float().contiguous()
    g = g.float()
    B, H, L, Dh = g.shape
    gdead = torch.empty((B, H, Dh), dtype=torch.float32, device=g.device)
    strides = (ctypes.c_longlong * 3)(*g.stride()[:3])
    with torch.cuda.device(g.device):
        err = lib.flash_bwd_gdead(
            lse.data_ptr(), g.data_ptr(), gdead.data_ptr(), B, H, L, Dh,
            strides, torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_gdead kernel launch failed: CUDA "
                           f"error {err}")
    global gdead_launches
    gdead_launches += 1
    return gdead


def launch_dq(q, k, v, kv_mask, g, out, lse, seg=None, summary=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the current stream (CUDA tensors only, as ``flash_backward``
    passes them): (dq in q's dtype, laid out like q; delta [B,H,L] f32 for
    K3). bf16 q/k/v take the tensor-core kernel (g is split into bf16 hi
    and lo halves as it is staged), f32 the CUDA-core one; `seg` [B, L]
    restricts the pairs to segments, as in K1. With `seg` the bf16 kernel
    visits only the KV tiles that share a segment with its Q tile, by
    `summary` (``launch_seg_summary``'s, which it requires)."""
    lib = _bwd_library()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        q, k, v, g = (_aligned16(t) for t in (q, k, v, g))
    B, H, L = q.shape[:3]
    mask_u8 = _mask_bytes(kv_mask)
    seg_i = _seg_ids(seg)
    if tensor_cores and seg is not None and summary is None:
        raise ValueError("launch_dq: bf16 q/k/v with seg need the segment "
                         "summary (launch_seg_summary)")
    out, lse = out.contiguous(), lse.contiguous()
    # like q: the towers' transposed views get gradients laid out as they
    # are, so autograd needs no copy on the way back
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    strides = _bwd_strides(q, k, v, g, dq, k, v)
    # the bf16 kernel also takes the summary
    extra = (_ptr(summary),) if tensor_cores else ()
    fn = lib.flash_bwd_dq_bf16 if tensor_cores else lib.flash_bwd_dq_f32
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
                 _ptr(seg_i), *extra, g.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 *_bwd_common(q, k), strides,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error "
                           f"{err}")
    _count("dq_launches", tensor_cores, seg)
    return dq, delta


def launch_dq_dbias(q, k, v, kv_mask, bias, g, out, lse, seg=None,
                    summary=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on the current stream (CUDA tensors only): (dq in q's dtype,
    laid out like q; delta [B,H,L] f32 for K3; dbias [H,L,S] f32). Its
    first launch writes one partial dbias per group of DBIAS_GROUP batch
    rows, its second sums the partials in order: no atomics, so dbias is
    bitwise equal from run to run. bf16 q/k/v with S up to
    MAX_TC_DBIAS_KEYS take the tensor-core kernel; f32 q/k/v, and bf16
    ones over more keys (as f32 copies, dq rounded back to bf16), the
    CUDA-core one. `seg` and `summary` as in ``launch_dq``: with `seg` the
    tensor-core kernel visits, for each batch row, only the KV tiles that
    share a segment with its Q tile, and requires the summary."""
    lib = _bwd_library()
    B, H, L = q.shape[:3]
    S = k.shape[2]
    dtype = q.dtype
    tensor_cores = dtype == torch.bfloat16 and S <= MAX_TC_DBIAS_KEYS
    if tensor_cores:
        q, k, v, g = (_aligned16(t) for t in (q, k, v, g))
        if seg is not None and summary is None:
            raise ValueError("launch_dq_dbias: bf16 q/k/v with seg need the "
                             "segment summary (launch_seg_summary)")
    elif dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
    dq = torch.empty_like(q)
    mask_u8 = _mask_bytes(kv_mask)
    seg_i = _seg_ids(seg)
    out, lse = out.contiguous(), lse.contiguous()
    bias_f = bias.float().contiguous()
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    groups = -(-B // DBIAS_GROUP)
    part = torch.empty((groups, H, L, S), dtype=torch.float32,
                       device=q.device)
    dbias = torch.empty((H, L, S), dtype=torch.float32, device=q.device)
    strides = _bwd_strides(q, k, v, g, dq, k, v)
    # the bf16 kernel also takes the summary
    extra = (_ptr(summary),) if tensor_cores else ()
    fn = (lib.flash_bwd_dq_dbias_bf16 if tensor_cores
          else lib.flash_bwd_dq_dbias_f32)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
                 bias_f.data_ptr(), _ptr(seg_i), *extra, g.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), part.data_ptr(), dbias.data_ptr(),
                 *_bwd_common(q, k),
                 DBIAS_GROUP, strides,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq_dbias kernel launch failed: CUDA "
                           f"error {err}")
    _count("dq_dbias_launches", tensor_cores, seg)
    return dq.to(dtype), delta, dbias


def launch_dkv(q, k, v, kv_mask, g, lse, delta, bias=None, seg=None,
               summary=None, gdead=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the current stream, after K2 or K4 wrote `delta`: (dk, dv) in
    the dtypes of k and v, laid out like them. With `bias` [H,L,S] the
    scores are rebuilt with it, as K1 built them; `seg` as in
    ``launch_dq``. bf16 q/k/v take the tensor-core kernel (g is split into
    bf16 hi and lo halves as it is staged), f32 the CUDA-core one. With
    `seg` the bf16 kernel visits only the Q tiles that share a segment
    with its keys, by `summary` (``launch_seg_summary``'s), and adds the
    fully masked rows' dv from `gdead` (``launch_dead_rows_sum``'s); it
    requires both."""
    lib = _bwd_library()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        q, k, v, g = (_aligned16(t) for t in (q, k, v, g))
    mask_u8 = _mask_bytes(kv_mask)
    seg_i = _seg_ids(seg)
    if tensor_cores and seg is not None and (summary is None
                                             or gdead is None):
        raise ValueError("launch_dkv: bf16 q/k/v with seg need the segment "
                         "summary and gdead (launch_seg_summary, "
                         "launch_dead_rows_sum)")
    lse = lse.contiguous()
    bias_f = None if bias is None else bias.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = _bwd_strides(q, k, v, g, q, dk, dv)
    # the bf16 kernel also takes the summary and gdead
    extra = (_ptr(summary), _ptr(gdead)) if tensor_cores else ()
    fn = lib.flash_bwd_dkv_bf16 if tensor_cores else lib.flash_bwd_dkv_f32
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
                 _ptr(bias_f), _ptr(seg_i), *extra, g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), *_bwd_common(q, k), strides,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error "
                           f"{err}")
    _count("dkv_launches", tensor_cores, seg)
    return dk, dv


def _forward(q, k, v, kv_mask, bias, seg):
    """(out, lse, the segment summary of a bf16 K1 with seg or None)."""
    _check(q, k, v, kv_mask, bias, seg)
    if q.device.type == "cpu":
        return (*reference_forward(q, k, v, kv_mask, bias, seg), None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_mask, bias, seg)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   seg: Optional[torch.Tensor] = None,
                   summary: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """(dq, dk, dv, dbias) in the dtypes of q, k, v and the bias (dbias is
    None without a bias) for the upstream gradient g [B,H,L,Dh] of
    ``out``, given the forward's out and lse (and its segment ids and
    segment summary, if it had them). CUDA tensors launch K2 then K3, or
    with a bias K4 then K3, on the current stream; with segment ids and
    bf16 q/k/v, the dead rows' g sum first, which K3 takes, and K2 (or
    K4) and K3 take `summary` (the segment summary kernel runs first when
    it is not given). CPU tensors take the plain version
    ``reference_backward``."""
    _check(q, k, v, kv_mask, bias, seg)
    want = (q.shape[0], q.shape[1], q.shape[2])
    if g.shape != q.shape or out.shape != q.shape or lse.shape != want:
        raise ValueError(f"flash_backward: g {tuple(g.shape)}, out "
                         f"{tuple(out.shape)} and lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    g = g.float()
    if g.stride(-1) != 1:         # e.g. an expanded gradient: stride 0
        g = g.contiguous()
    if q.device.type == "cpu":
        return reference_backward(q, k, v, kv_mask, g, out, lse, bias, seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out, lse = out.float(), lse.float()
    gdead = None
    if seg is not None and q.dtype == torch.bfloat16:
        if summary is None:
            summary = launch_seg_summary(seg, kv_mask, v)[0]
        gdead = launch_dead_rows_sum(lse, g)
    if bias is None:
        dq, delta = launch_dq(q, k, v, kv_mask, g, out, lse, seg, summary)
        dbias = None
    else:
        dq, delta, dbias = launch_dq_dbias(q, k, v, kv_mask, bias, g, out,
                                           lse, seg, summary)
        dbias = dbias.to(bias.dtype)
    dk, dv = launch_dkv(q, k, v, kv_mask, g, lse, delta, bias, seg, summary,
                        gdead)
    return dq, dk, dv, dbias


class FlashAttention(torch.autograd.Function):
    """K1 forward; K2 + K3 backward, or K4 + K3 with a bias, with the
    forward's segment ids and segment summary if it had them (plain
    versions on CPU tensors). Returns (out, lse); lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, bias, seg):
        out, lse, summary = _forward(q, k, v, kv_mask, bias, seg)
        ctx.save_for_backward(q, k, v, kv_mask, bias, seg, out, lse, summary)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, kv_mask, bias, seg, out, lse, summary = ctx.saved_tensors
        dq, dk, dv, dbias = flash_backward(q, k, v, kv_mask, g_out, out, lse,
                                           bias, seg, summary)
        if not ctx.needs_input_grad[4]:
            dbias = None
        return dq, dk, dv, None, dbias, None


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  seg: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,H,L,Dh] f32, lse [B,H,L] f32), differentiable in q, k, v
    and the bias through ``FlashAttention``. CUDA tensors launch K1 on the
    current stream (and K2 + K3, or K4 + K3 with a bias, in the backward);
    CPU tensors take the plain versions. With segment ids and bf16 q/k/v
    the segment summary kernel runs first (its summary also serves the
    backward). q/k/v may be strided (the towers pass ``x.transpose(1, 2)``)
    as long as Dh has unit stride. With no
    gradient to record (inference mode, ``no_grad``, or inputs that need
    none) the forward is called directly, without the Function's
    bookkeeping."""
    wants_grad = (q.requires_grad or k.requires_grad or v.requires_grad
                  or (bias is not None and bias.requires_grad))
    if torch.is_grad_enabled() and wants_grad:
        return FlashAttention.apply(q, k, v, kv_mask, bias, seg)
    return _forward(q, k, v, kv_mask, bias, seg)[:2]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output [B,H,L,Dh] f32 (see flash_forward)."""
    return flash_forward(q, k, v, kv_mask, bias, seg)[0]
