"""The port's flash-attention forward (ops/flash_attention.py) against the
JAX package's Pallas kernel, run in interpret mode on the CPU, and its
reference. On a CPU tensor the port's wrapper takes its plain version, so
here the plain version is held to the TPU kernel's contract: padding,
ragged L=37/S=53, T5 bias, packed-page segment ids, bf16, and a fully
masked row that returns mean(V). Tolerances are the JAX tests': 2e-5 for
float32, 2e-2 for bfloat16.

The CUDA kernel itself runs only on the card: tests/test_torch_kernels_cuda.py
holds it against the plain version (skipping without a GPU), and
chip_smoke.py does so at the serving path's shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.ops.flash_attention import (
    _flash_forward, flash_attention as jax_flash,
    reference_attention as jax_reference)
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _mk(B=2, H=2, L=48, S=48, Dh=16, seed=0, pad_tail=5, bias=False,
        seg=False):
    rng = np.random.default_rng(seed)
    arrs = {
        "q": rng.normal(size=(B, H, L, Dh)).astype(np.float32),
        "k": rng.normal(size=(B, H, S, Dh)).astype(np.float32),
        "v": rng.normal(size=(B, H, S, Dh)).astype(np.float32),
    }
    mask = np.ones((B, S), bool)
    if pad_tail:
        mask[:, -pad_tail:] = False
    arrs["kv_mask"] = mask
    arrs["bias"] = (rng.normal(size=(H, L, S)).astype(np.float32)
                    if bias else None)
    if seg:
        # two packed pages per row, then a pad tail (segment 0)
        ids = np.zeros((B, L), np.int32)
        cut = L // 2
        ids[:, :cut] = 1
        ids[:, cut:L - pad_tail] = 2
        arrs["seg"] = ids
    else:
        arrs["seg"] = None
    return arrs


def _jax(arrs, dtype=jnp.float32):
    # default blocks (128): for lengths <= 128 the Pallas wrapper pads
    # nothing, so a fully masked row averages V over exactly S keys, as the
    # port's kernel does (zero-padded keys would join that average)
    q, k, v = (jnp.asarray(arrs[n], dtype) for n in ("q", "k", "v"))
    bias = None if arrs["bias"] is None else jnp.asarray(arrs["bias"])
    seg = None if arrs["seg"] is None else jnp.asarray(arrs["seg"])
    out, lse = _flash_forward(q, k, v, jnp.asarray(arrs["kv_mask"]), bias,
                              seg, 128, 128, None)
    want = jax_flash(q, k, v, jnp.asarray(arrs["kv_mask"]), bias, seg=seg)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    return np.asarray(out), np.asarray(lse)


def _torch(arrs, dtype=torch.float32):
    q, k, v = (torch.from_numpy(arrs[n]).to(dtype) for n in ("q", "k", "v"))
    t = lambda x: None if x is None else torch.from_numpy(x)
    out, lse = fa.flash_forward(q, k, v, t(arrs["kv_mask"]), t(arrs["bias"]),
                                t(arrs["seg"]))
    assert out.dtype == lse.dtype == torch.float32
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("case", [
    dict(),                                   # padding mask
    dict(L=37, S=53, pad_tail=7),             # ragged lengths
    dict(H=3, L=32, S=32, pad_tail=3, bias=True),   # T5 bias
    dict(L=40, S=40, pad_tail=6, seg=True),   # packed-page segments
    dict(L=37, S=53, pad_tail=7, bias=True),  # bias on ragged lengths
], ids=["padding", "ragged", "t5_bias", "seg", "bias_ragged"])
def test_forward_matches_jax_kernel_f32(case):
    arrs = _mk(**case)
    want_out, want_lse = _jax(arrs)
    got_out, got_lse = _torch(arrs)
    np.testing.assert_allclose(got_out, want_out, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse, want_lse, rtol=F32_TOL, atol=F32_TOL)


def test_forward_matches_jax_kernel_bf16():
    arrs = _mk()
    want_out, want_lse = _jax(arrs, jnp.bfloat16)
    got_out, got_lse = _torch(arrs, torch.bfloat16)
    np.testing.assert_allclose(got_out, want_out, rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(got_lse, want_lse, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_reference_matches_jax_reference():
    for case in (dict(), dict(L=37, S=53, pad_tail=7, bias=True),
                 dict(L=40, S=40, pad_tail=6, seg=True)):
        arrs = _mk(**case)
        j = lambda x: None if x is None else jnp.asarray(x)
        want = jax_reference(j(arrs["q"]), j(arrs["k"]), j(arrs["v"]),
                             j(arrs["kv_mask"]), j(arrs["bias"]),
                             j(arrs["seg"]))
        t = lambda x: None if x is None else torch.from_numpy(x)
        got = fa.reference_attention(t(arrs["q"]), t(arrs["k"]),
                                     t(arrs["v"]), t(arrs["kv_mask"]),
                                     t(arrs["bias"]), t(arrs["seg"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_fully_masked_row_returns_mean_v():
    arrs = _mk(B=2, H=2, L=24, S=24, pad_tail=0)
    arrs["kv_mask"][1] = False                 # batch row 1: nothing to see
    want_out, want_lse = _jax(arrs)
    got_out, got_lse = _torch(arrs)
    mean_v = arrs["v"][1].mean(axis=1)         # [H, Dh]
    for out in (want_out, got_out):
        np.testing.assert_allclose(out[1], np.broadcast_to(
            mean_v[:, None], out[1].shape), rtol=F32_TOL, atol=F32_TOL)
    assert np.isfinite(got_out).all()
    np.testing.assert_allclose(got_out, want_out, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse, want_lse, rtol=F32_TOL)


def test_strided_inputs_as_the_towers_pass_them():
    # Attention hands the wrapper x.transpose(1, 2): [B, L, H, Dh] viewed
    # as [B, H, L, Dh], not contiguous
    arrs = _mk()
    x = {n: torch.from_numpy(arrs[n]).transpose(1, 2).contiguous()
         .transpose(1, 2) for n in ("q", "k", "v")}
    assert not x["q"].is_contiguous()
    got = fa.flash_attention(x["q"], x["k"], x["v"],
                             torch.from_numpy(arrs["kv_mask"]))
    want, _ = _jax(arrs)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "mask_shape",
                                 "bias_shape", "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = {n: torch.from_numpy(v) for n, v in _mk().items() if v is not None}
    q, k, v, mask, bias = a["q"], a["k"], a["v"], a["kv_mask"], None
    if bad == "dtype":
        q, k, v = (x.to(torch.float16) for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (x[..., :12] for x in (q, k, v))
    elif bad == "mask_shape":
        mask = mask[:, :-1]
    elif bad == "bias_shape":
        bias = torch.zeros(2, 48, 47)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_forward(q, k, v, mask, bias)


def test_cpu_path_never_counts_a_launch():
    before = fa.launches
    arrs = _mk()
    _torch(arrs)
    assert fa.launches == before
