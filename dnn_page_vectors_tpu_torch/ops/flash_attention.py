"""Flash-attention forward for the transformer towers: the wrapper of kernel
K1 (``csrc/flash_fwd.cu``) and its plain PyTorch version.

K1 replaces the JAX package's Pallas TPU kernel ``_flash_kernel``
(dnn_page_vectors_tpu/ops/flash_attention.py, ``_flash_forward``):
bidirectional, padding-masked attention with an optional additive bias
(T5 relative positions) and optional packed-page segment ids, returning
out [B,H,L,Dh] f32 and the row log-sum-exp [B,H,L] f32. A fully masked
row returns mean(V) (scores are masked with the finite -1e30).

Routing is by the tensors' device and nothing else: a CUDA tensor goes to
the kernel (or the wrapper raises), a CPU tensor goes to the plain version
``reference_forward``. Nothing catches a kernel failure and carries on.

The backward kernels (dq, dk/dv, dq+dbias) belong to training and are
later slices of the port.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_SOURCE = "flash_fwd.cu"

# Launches of K1 since the last reset: the wrapper adds one where it
# launches the kernel and nowhere else. chip_smoke.py sets it to 0 before
# driving the serving path and reads it after.
launches = 0


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


def _launch(q, k, v, kv_mask, bias, seg):
    global launches
    lib = _library()
    B, H, L, Dh = q.shape
    S = k.shape[2]
    mask_u8 = kv_mask.to(torch.uint8).contiguous()
    bias_f = None if bias is None else bias.float().contiguous()
    seg_i = None if seg is None else seg.to(torch.int32).contiguous()
    out = torch.empty((B, H, L, Dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
        None if bias_f is None else bias_f.data_ptr(),
        None if seg_i is None else seg_i.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, L, S, Dh,
        1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def _library():
    from dnn_page_vectors_tpu_torch.ops.build import load_library
    lib = load_library(_SOURCE)
    fn = lib.flash_fwd
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, P, P, P, P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), P]
        fn.restype = ctypes.c_int
    return lib


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  seg: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,H,L,Dh] f32, lse [B,H,L] f32). CUDA tensors launch K1 on the
    current stream; CPU tensors take the plain version. q/k/v may be
    strided (the towers pass ``x.transpose(1, 2)``) as long as Dh has unit
    stride."""
    _check(q, k, v, kv_mask, bias, seg)
    if q.device.type == "cpu":
        return reference_forward(q, k, v, kv_mask, bias, seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_mask, bias, seg)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output [B,H,L,Dh] f32 through K1 (see flash_forward)."""
    return flash_forward(q, k, v, kv_mask, bias, seg)[0]
