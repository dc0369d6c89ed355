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
adds nothing to dq, dk or dbias), not the TPU kernels' p = 1. The
backward of the segment path is slice 4 of the port: the forward takes
``seg``, and a backward through it raises NotImplementedError.

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
Nothing catches a kernel failure and carries on.
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
# the longest S the bf16 K4 takes (csrc/flash_bwd.cu, tcq::kMaxBiasKeys)
MAX_TC_DBIAS_KEYS = 512

# Launches of K1, K2, K3 and K4 since the last reset: each wrapper adds one
# where it launches its kernel and nowhere else. chip_smoke.py sets them to
# 0 before driving a path and reads them after. Each also counts by kernel:
# `_tc` the bf16 tensor-core kernel, `_f32` the CUDA-core one.
launches = 0
launches_tc = 0
launches_f32 = 0
dq_launches = 0
dq_launches_tc = 0
dq_launches_f32 = 0
dkv_launches = 0
dkv_launches_tc = 0
dkv_launches_f32 = 0
dq_dbias_launches = 0
dq_dbias_launches_tc = 0
dq_dbias_launches_f32 = 0


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
    allowed = kv_mask.bool()[:, None, None, :]
    if seg is not None:
        allowed = allowed & ((seg[:, :, None] == seg[:, None, :])
                             & (seg > 0)[:, None, :])[:, None]
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
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
                       bias: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Plain backward of ``reference_forward`` with an optional bias and
    no seg, the oracle of K2, K3 and K4: (dq, dk, dv, dbias) in the dtypes
    of q, k, v and the bias (dbias is None without a bias).

    It computes what the kernels compute: p is rebuilt from the saved
    ``lse`` as exp(scale * q.k + bias - lse), zero at a masked key;
    delta = sum(g * out) per row; ds = p * (g.v - delta); dq = scale *
    ds.k, dk = scale * ds^T.q, dv = p^T.g, dbias = sum over the batch of
    ds, all in float32. A fully masked row (lse <= -1e29: every score was
    -1e30, so the forward's softmax was uniform) gets p = 1/S for every key
    and ds = 0, which is the gradient of the forward (``jax.grad`` of the
    reference attention agrees), not the TPU kernels' p = 1."""
    S = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = (gf * out.float()).sum(-1)                        # [B,H,L]
    s = torch.einsum("bhld,bhsd->bhls", qf, kf) * scale
    if bias is not None:
        s = s + bias[None].float()
    allowed = kv_mask.bool()[:, None, None, :]
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


def _launch(q, k, v, kv_mask, bias, seg):
    global launches, launches_tc, launches_f32
    lib = _library()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    B, H, L, Dh = q.shape
    S = k.shape[2]
    mask_u8 = _mask_bytes(kv_mask)
    bias_f = None if bias is None else bias.float().contiguous()
    seg_i = None if seg is None else seg.to(torch.int32).contiguous()
    out = torch.empty((B, H, L, Dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = lib.flash_fwd_bf16 if tensor_cores else lib.flash_fwd_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
             None if bias_f is None else bias_f.data_ptr(),
             None if seg_i is None else seg_i.data_ptr(),
             out.data_ptr(), lse.data_ptr(), B, H, L, S, Dh,
             1.0 / math.sqrt(Dh), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    if tensor_cores:
        launches_tc += 1
    else:
        launches_f32 += 1
    return out, lse


def _library():
    from dnn_page_vectors_tpu_torch.ops.build import load_library
    lib = load_library(_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32):
        if fn.argtypes is None:
            fn.argtypes = [P] * 8 + [I] * 5 + [
                ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), P]
            fn.restype = ctypes.c_int
    return lib


def _bwd_library():
    from dnn_page_vectors_tpu_torch.ops.build import load_library
    lib = load_library(_BWD_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    # (B, H, L, S, Dh, scale), then K4's group
    tail = [I, I, I, I, I, ctypes.c_float]
    strides = ctypes.POINTER(ctypes.c_longlong)
    for fn, nptr, tail_ in ((lib.flash_bwd_dq_bf16, 9, tail),
                            (lib.flash_bwd_dq_f32, 9, tail),
                            (lib.flash_bwd_dkv_bf16, 10, tail),
                            (lib.flash_bwd_dkv_f32, 10, tail),
                            (lib.flash_bwd_dq_dbias_bf16, 12, tail + [I]),
                            (lib.flash_bwd_dq_dbias_f32, 12, tail + [I])):
        if fn.argtypes is None:
            fn.argtypes = [P] * nptr + tail_ + [strides, P]
            fn.restype = ctypes.c_int
    return lib


def _bwd_common(q, k):
    """(B, H, L, S, Dh, scale) as K2, K3 and K4 take them."""
    B, H, L, Dh = q.shape
    return B, H, L, k.shape[2], Dh, 1.0 / math.sqrt(Dh)


def _bwd_strides(*tensors):
    return (ctypes.c_longlong * 21)(
        *(st for t in tensors for st in t.stride()[:3]))


def launch_dq(q, k, v, kv_mask, g, out, lse
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the current stream (CUDA tensors only, as ``flash_backward``
    passes them): (dq in q's dtype, laid out like q; delta [B,H,L] f32 for
    K3). bf16 q/k/v take the tensor-core kernel (g is split into bf16 hi
    and lo halves as it is staged), f32 the CUDA-core one."""
    global dq_launches, dq_launches_tc, dq_launches_f32
    lib = _bwd_library()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        q, k, v, g = (_aligned16(t) for t in (q, k, v, g))
    B, H, L = q.shape[:3]
    mask_u8 = _mask_bytes(kv_mask)
    out, lse = out.contiguous(), lse.contiguous()
    # like q: the towers' transposed views get gradients laid out as they
    # are, so autograd needs no copy on the way back
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    strides = _bwd_strides(q, k, v, g, dq, k, v)
    fn = lib.flash_bwd_dq_bf16 if tensor_cores else lib.flash_bwd_dq_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
             g.data_ptr(), out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), *_bwd_common(q, k), strides,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error "
                           f"{err}")
    dq_launches += 1
    if tensor_cores:
        dq_launches_tc += 1
    else:
        dq_launches_f32 += 1
    return dq, delta


def launch_dq_dbias(q, k, v, kv_mask, bias, g, out, lse
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on the current stream (CUDA tensors only): (dq in q's dtype,
    laid out like q; delta [B,H,L] f32 for K3; dbias [H,L,S] f32). Its
    first launch writes one partial dbias per group of DBIAS_GROUP batch
    rows, its second sums the partials in order: no atomics, so dbias is
    bitwise equal from run to run. bf16 q/k/v with S up to
    MAX_TC_DBIAS_KEYS take the tensor-core kernel; f32 q/k/v, and bf16
    ones over more keys (as f32 copies, dq rounded back to bf16), the
    CUDA-core one."""
    global dq_dbias_launches, dq_dbias_launches_tc, dq_dbias_launches_f32
    lib = _bwd_library()
    B, H, L = q.shape[:3]
    S = k.shape[2]
    dtype = q.dtype
    tensor_cores = dtype == torch.bfloat16 and S <= MAX_TC_DBIAS_KEYS
    if tensor_cores:
        q, k, v, g = (_aligned16(t) for t in (q, k, v, g))
    elif dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
    dq = torch.empty_like(q)
    mask_u8 = _mask_bytes(kv_mask)
    out, lse = out.contiguous(), lse.contiguous()
    bias_f = bias.float().contiguous()
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    groups = -(-B // DBIAS_GROUP)
    part = torch.empty((groups, H, L, S), dtype=torch.float32,
                       device=q.device)
    dbias = torch.empty((H, L, S), dtype=torch.float32, device=q.device)
    strides = _bwd_strides(q, k, v, g, dq, k, v)
    fn = (lib.flash_bwd_dq_dbias_bf16 if tensor_cores
          else lib.flash_bwd_dq_dbias_f32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
             bias_f.data_ptr(), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), part.data_ptr(),
             dbias.data_ptr(), *_bwd_common(q, k), DBIAS_GROUP, strides,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq_dbias kernel launch failed: CUDA "
                           f"error {err}")
    dq_dbias_launches += 1
    if tensor_cores:
        dq_dbias_launches_tc += 1
    else:
        dq_dbias_launches_f32 += 1
    return dq.to(dtype), delta, dbias


def launch_dkv(q, k, v, kv_mask, g, lse, delta, bias=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the current stream, after K2 or K4 wrote `delta`: (dk, dv) in
    the dtypes of k and v, laid out like them. With `bias` [H,L,S] the
    scores are rebuilt with it, as K1 built them. bf16 q/k/v take the
    tensor-core kernel (g is split into bf16 hi and lo halves as it is
    staged), f32 the CUDA-core one."""
    global dkv_launches, dkv_launches_tc, dkv_launches_f32
    lib = _bwd_library()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        q, k, v, g = (_aligned16(t) for t in (q, k, v, g))
    mask_u8 = _mask_bytes(kv_mask)
    lse = lse.contiguous()
    bias_f = None if bias is None else bias.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = _bwd_strides(q, k, v, g, q, dk, dv)
    fn = lib.flash_bwd_dkv_bf16 if tensor_cores else lib.flash_bwd_dkv_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
             None if bias_f is None else bias_f.data_ptr(),
             g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), *_bwd_common(q, k), strides,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error "
                           f"{err}")
    dkv_launches += 1
    if tensor_cores:
        dkv_launches_tc += 1
    else:
        dkv_launches_f32 += 1
    return dk, dv


def _forward(q, k, v, kv_mask, bias, seg):
    _check(q, k, v, kv_mask, bias, seg)
    if q.device.type == "cpu":
        return reference_forward(q, k, v, kv_mask, bias, seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_mask, bias, seg)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """(dq, dk, dv, dbias) in the dtypes of q, k, v and the bias (dbias is
    None without a bias) for the upstream gradient g [B,H,L,Dh] of
    ``out``, given the forward's out and lse (no seg). CUDA tensors launch
    K2 then K3, or with a bias K4 then K3, on the current stream; CPU
    tensors take the plain version ``reference_backward``."""
    _check(q, k, v, kv_mask, bias, None)
    want = (q.shape[0], q.shape[1], q.shape[2])
    if g.shape != q.shape or out.shape != q.shape or lse.shape != want:
        raise ValueError(f"flash_backward: g {tuple(g.shape)}, out "
                         f"{tuple(out.shape)} and lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    g = g.float()
    if g.stride(-1) != 1:         # e.g. an expanded gradient: stride 0
        g = g.contiguous()
    if q.device.type == "cpu":
        return reference_backward(q, k, v, kv_mask, g, out, lse, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out, lse = out.float(), lse.float()
    if bias is None:
        dq, delta = launch_dq(q, k, v, kv_mask, g, out, lse)
        dbias = None
    else:
        dq, delta, dbias = launch_dq_dbias(q, k, v, kv_mask, bias, g, out,
                                           lse)
        dbias = dbias.to(bias.dtype)
    dk, dv = launch_dkv(q, k, v, kv_mask, g, lse, delta, bias)
    return dq, dk, dv, dbias


class FlashAttention(torch.autograd.Function):
    """K1 forward; K2 + K3 backward, or K4 + K3 with a bias (plain
    versions on CPU tensors). Returns (out, lse); lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, bias, seg):
        out, lse = _forward(q, k, v, kv_mask, bias, seg)
        ctx.save_for_backward(q, k, v, kv_mask, bias, out, lse)
        ctx.has_seg = seg is not None
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if ctx.has_seg:
            raise NotImplementedError(
                "flash_attention backward with segment ids (sequence "
                "packing) comes with slice 4 of the port (the seg variants "
                "of K2, K3 and K4)")
        q, k, v, kv_mask, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_backward(q, k, v, kv_mask, g_out, out, lse,
                                           bias)
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
    CPU tensors take the plain versions. q/k/v may be strided (the towers
    pass ``x.transpose(1, 2)``) as long as Dh has unit stride. With no
    gradient to record (inference mode, ``no_grad``, or inputs that need
    none) the forward is called directly, without the Function's
    bookkeeping."""
    wants_grad = (q.requires_grad or k.requires_grad or v.requires_grad
                  or (bias is not None and bias.requires_grad))
    if torch.is_grad_enabled() and wants_grad:
        return FlashAttention.apply(q, k, v, kv_mask, bias, seg)
    return _forward(q, k, v, kv_mask, bias, seg)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output [B,H,L,Dh] f32 (see flash_forward)."""
    return flash_forward(q, k, v, kv_mask, bias, seg)[0]
