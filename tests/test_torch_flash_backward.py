"""The port's flash-attention backward (ops/flash_attention.py:
``reference_backward``, the plain version of kernels K2, K3 and K4, and
the ``FlashAttention`` autograd Function) against the JAX package: its
Pallas backward ``_flash_backward`` run in interpret mode with blocks of
16, and ``jax.grad`` of its ``reference_attention``, without and with a
T5 bias (then dbias too). On CPU tensors the port's
Function takes the plain versions, so this holds the plain backward to
the TPU kernels' contract; tests/test_torch_kernels_cuda.py holds the CUDA
kernels to the plain backward on the card.

Tolerances: 1e-4 relative / 1e-5 absolute on float32 gradients (the JAX
flash tests', tests/test_flash_attention.py:72) and 2e-2 on bfloat16
gradients.

At a fully masked query row the port gives the gradient of its forward
(which is what ``jax.grad`` of the reference gives), not the JAX kernel's:
the kernel rebuilds p = exp(s - lse) = 1 there instead of 1/S, and with a
bias its unmasked ds there also reaches dbias. Both differences are
pinned here.

With segment ids (sequence packing) every pad row of a packed row (seg 0)
is such a fully masked row. The seg tests hold the port against
``jax.grad`` with the upstream gradient as drawn, and against the Pallas
backward with the upstream gradient zeroed at the pad rows, as a packed
model's is (nothing reads a pad row's output: pooling skips it and no
other row attends to it), so that the Pallas kernels' p = 1 there does not
enter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.ops.flash_attention import (
    _flash_backward, _flash_forward, reference_attention as jax_reference)
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _mk(B=2, H=2, L=48, S=48, Dh=16, seed=0, pad_tail=5):
    rng = np.random.default_rng(seed)
    arrs = {
        "q": rng.normal(size=(B, H, L, Dh)).astype(np.float32),
        "k": rng.normal(size=(B, H, S, Dh)).astype(np.float32),
        "v": rng.normal(size=(B, H, S, Dh)).astype(np.float32),
        "g": rng.normal(size=(B, H, L, Dh)).astype(np.float32),
    }
    mask = np.ones((B, S), bool)
    if pad_tail:
        mask[:, -pad_tail:] = False
    arrs["kv_mask"] = mask
    return arrs


def _jax_kernel_grads(arrs, dtype):
    """The Pallas backward (interpret mode, blocks 16) on the Pallas
    forward's out and lse: [dq, dk, dv], and dbias when `arrs` has a
    bias (with segment ids when it has "seg")."""
    q, k, v = (jnp.asarray(arrs[n], dtype) for n in ("q", "k", "v"))
    mask = jnp.asarray(arrs["kv_mask"])
    bias = arrs.get("bias")
    bias = None if bias is None else jnp.asarray(bias)
    seg = arrs.get("seg")
    seg = None if seg is None else jnp.asarray(seg)
    out, lse = _flash_forward(q, k, v, mask, bias, seg, 16, 16, True)
    dq, dk, dv, db = _flash_backward(q, k, v, mask, bias, seg,
                                     jnp.asarray(arrs["g"]), out, lse, 16,
                                     16, True)
    grads = (dq, dk, dv) if bias is None else (dq, dk, dv, db)
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _jax_autodiff_grads(arrs, dtype):
    q, k, v = (jnp.asarray(arrs[n], dtype) for n in ("q", "k", "v"))
    mask = jnp.asarray(arrs["kv_mask"])
    g = jnp.asarray(arrs["g"])
    seg = arrs.get("seg")
    seg = None if seg is None else jnp.asarray(seg)
    if arrs.get("bias") is None:
        _, vjp = jax.vjp(lambda q, k, v: jax_reference(q, k, v, mask,
                                                       seg=seg), q, k, v)
    else:
        _, vjp = jax.vjp(lambda q, k, v, b: jax_reference(q, k, v, mask, b,
                                                          seg), q, k, v,
                         jnp.asarray(arrs["bias"]))
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(g)]


def _port_grads(arrs, dtype, strided=False):
    """reference_backward on the port's own forward: [dq, dk, dv], and
    dbias when `arrs` has a bias; with `strided`, q, k, v and g are [B, L,
    H, Dh] tensors viewed as [B, H, L, Dh], as the towers hand them
    over."""
    t = {n: torch.from_numpy(arrs[n]) for n in ("q", "k", "v", "g")}
    if strided:
        t = {n: x.transpose(1, 2).contiguous().transpose(1, 2)
             for n, x in t.items()}
        assert not t["q"].is_contiguous()
    q, k, v = (t[n].to(dtype) for n in ("q", "k", "v"))
    mask = torch.from_numpy(arrs["kv_mask"])
    bias = arrs.get("bias")
    bias = None if bias is None else torch.from_numpy(bias)
    seg = arrs.get("seg")
    seg = None if seg is None else torch.from_numpy(seg)
    out, lse = fa.reference_forward(q, k, v, mask, bias, seg)
    *grads, dbias = fa.reference_backward(q, k, v, mask, t["g"], out, lse,
                                          bias, seg)
    for x, want in zip(grads, (q, k, v)):
        assert x.dtype == want.dtype and x.shape == want.shape
    # the Function routes a CPU tensor to the same plain backward
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    if bias is None:
        assert dbias is None
    else:
        assert dbias.dtype == bias.dtype and dbias.shape == bias.shape
        grads.append(dbias)
        inputs.append(bias.detach().requires_grad_(True))
    o = fa.flash_attention(*inputs[:3], mask, *inputs[3:], seg=seg)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    via_fn = torch.autograd.grad(o, inputs, t["g"])
    for a, b in zip(grads, via_fn, strict=True):
        assert torch.equal(a, b)
    return [x.float().numpy() for x in grads]


CASES = {
    "pad_tail": dict(),
    "ragged_L37_S53": dict(L=37, S=53, pad_tail=7),
    "strided": dict(strided=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_backward_matches_jax(case, dtype):
    c = dict(CASES[case])
    strided = c.pop("strided", False)
    arrs = _mk(**c)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = F32 if dtype == "float32" else BF16
    got = _port_grads(arrs, td, strided=strided)
    for want in (_jax_kernel_grads(arrs, jd), _jax_autodiff_grads(arrs, jd)):
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, b, err_msg=f"{case} {name}", **tol)


def test_fully_masked_row_follows_the_gradient_not_the_jax_kernel():
    # B=2, H=1, L=S=16, Dh=8; batch row 1 has no allowed key, so its
    # forward is mean(V) and its true dv is g summed over rows / S
    arrs = _mk(B=2, H=1, L=16, S=16, Dh=8, pad_tail=0, seed=3)
    arrs["kv_mask"][1] = False
    got = _port_grads(arrs, torch.float32)
    want = _jax_autodiff_grads(arrs, jnp.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **F32)
    sum_g = arrs["g"][1].sum(axis=1, keepdims=True)              # [H,1,Dh]
    np.testing.assert_allclose(got[2][1], np.broadcast_to(
        sum_g / 16, got[2][1].shape), **F32)
    assert not got[0][1].any() and not got[1][1].any()
    # the JAX kernel rebuilds p = 1 at that row: dv 16x (S x) too large,
    # and dq/dk off; the rows with an allowed key agree
    kern = _jax_kernel_grads(arrs, jnp.float32)
    np.testing.assert_allclose(kern[2][1], 16 * want[2][1], **F32)
    assert np.abs(kern[0][1] - want[0][1]).max() > 1.0
    assert np.abs(kern[1][1] - want[1][1]).max() > 1.0
    for a, b in zip(kern, want):
        np.testing.assert_allclose(a[0], b[0], **F32)


# the shapes of tests/test_flash_attention.py's biased gradient tests
BIAS_CASES = {
    "B3_L32": dict(B=3, H=2, L=32, S=32, pad_tail=4, bias_seed=2),
    "ragged_L37_S53": dict(B=2, H=2, L=37, S=53, pad_tail=6, bias_seed=5),
}


def _mk_bias(bias_seed, **shape):
    arrs = _mk(**shape)
    H, L, S = shape["H"], shape["L"], shape["S"]
    arrs["bias"] = np.random.default_rng(bias_seed).normal(
        size=(H, L, S)).astype(np.float32)
    return arrs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_biased_reference_backward_matches_jax(case, dtype):
    """dq, dk, dv and dbias of the plain backward (K4 + K3's oracle), and
    of the Function through it, against the Pallas biased backward (K4's
    batch-innermost dbias) and jax.grad of the reference with the bias."""
    arrs = _mk_bias(**BIAS_CASES[case])
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = F32 if dtype == "float32" else BF16
    got = _port_grads(arrs, td)
    assert len(got) == 4
    for want in (_jax_kernel_grads(arrs, jd), _jax_autodiff_grads(arrs, jd)):
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want,
                              strict=True):
            np.testing.assert_allclose(a, b, err_msg=f"{case} {name}", **tol)


def test_fully_masked_row_adds_nothing_to_dbias_unlike_the_jax_kernel():
    # B=2, H=2, L=S=16, Dh=8; batch row 1 sees no key. Its ds is 0 (the
    # masked scores do not depend on the bias), so dbias is batch row 0's
    # ds alone, as jax.grad of the reference gives.
    arrs = _mk_bias(B=2, H=2, L=16, S=16, Dh=8, pad_tail=0, seed=3,
                    bias_seed=4)
    arrs["kv_mask"][1] = False
    got = _port_grads(arrs, torch.float32)
    want = _jax_autodiff_grads(arrs, jnp.float32)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want,
                          strict=True):
        np.testing.assert_allclose(a, b, err_msg=name, **F32)
    alone = dict(arrs, **{n: arrs[n][:1] for n in ("q", "k", "v", "g",
                                                   "kv_mask")})
    np.testing.assert_allclose(got[3], _port_grads(alone, torch.float32)[3],
                               **F32)
    # the Pallas kernels rebuild p = 1 at that row and keep its ds: their
    # dbias takes in row 1's sum_l g.v - delta terms, off by more than 1
    kern = _jax_kernel_grads(arrs, jnp.float32)
    assert np.abs(kern[3] - want[3]).max() > 1.0
    np.testing.assert_allclose(kern[2][1], 16 * want[2][1], **F32)
    for a, b in zip(kern[:3], want[:3]):
        np.testing.assert_allclose(a[0], b[0], **F32)


def test_bias_needing_a_gradient_takes_the_function():
    """A learned bias gets its gradient even when q, k and v need none
    (flash_forward's shortcut around the Function looks at the bias
    too)."""
    arrs = _mk_bias(B=2, H=2, L=24, S=24, pad_tail=3, bias_seed=1)
    q, k, v, g = (torch.from_numpy(arrs[n]) for n in ("q", "k", "v", "g"))
    mask = torch.from_numpy(arrs["kv_mask"])
    bias = torch.from_numpy(arrs["bias"]).requires_grad_(True)
    out, lse = fa.flash_forward(q, k, v, mask, bias)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (dbias,) = torch.autograd.grad(out, bias, g)
    want = fa.reference_backward(q, k, v, mask, g, out.detach(), lse, bias)
    assert torch.equal(dbias, want[3])
    assert dbias.abs().max() > 0
    # and with nothing needing a gradient, the Function is skipped
    out, _ = fa.flash_forward(q, k, v, mask, bias.detach())
    assert out.grad_fn is None


def _packed_seg(B, L):
    """[B, L] int32 segment ids of packed rows: segments of one token, of
    16 tokens straddling the tiles of 16, several pages a row, a pad tail,
    and the last batch row all pad (seg 0 everywhere)."""
    seg = np.zeros((B, L), np.int32)
    cuts = [(0, 13), (13, 14), (14, 34), (34, L - 6)]     # batch row 0
    for s, (a, b) in enumerate(cuts):
        seg[0, a:b] = s + 1
    if B > 2:
        seg[1, :7], seg[1, 7:L - 2] = 1, 2
    return seg


def _mk_seg(B=3, H=2, L=48, Dh=16, seed=0, bias=False, mask="packed"):
    """Inputs of a packed batch: kv_mask = seg > 0, as the towers pass
    it, or with `mask` "holes" also three real keys masked inside a
    segment."""
    arrs = (_mk_bias(bias_seed=seed + 7, B=B, H=H, L=L, S=L, Dh=Dh,
                     seed=seed, pad_tail=0)
            if bias else _mk(B=B, H=H, L=L, S=L, Dh=Dh, seed=seed,
                             pad_tail=0))
    arrs["seg"] = _packed_seg(B, L)
    arrs["kv_mask"] = arrs["seg"] > 0
    if mask == "holes":
        arrs["kv_mask"][:, 20:23] = False
    return arrs


def _zero_pad_rows(arrs):
    """The inputs with g zeroed at every pad row (seg 0), as a packed
    model's upstream gradient is there."""
    g = arrs["g"] * (arrs["seg"] > 0)[:, None, :, None]
    return dict(arrs, g=g.astype(np.float32))


SEG_CASES = {
    "packed": dict(),
    "packed_holes": dict(mask="holes"),
    "packed_bias": dict(bias=True),
    "packed_holes_bias": dict(bias=True, mask="holes"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_reference_backward_matches_jax(case, dtype):
    """reference_backward with segment ids (the oracle of the seg variants
    of K2, K3 and K4), and the Function through it, against jax.grad of the
    JAX reference with seg, and against the Pallas backward with seg in
    interpret mode on a packed model's upstream gradient (zero at the pad
    rows)."""
    arrs = _mk_seg(**SEG_CASES[case])
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = F32 if dtype == "float32" else BF16
    got = _port_grads(arrs, td)
    names = ("dq", "dk", "dv", "dbias")[:len(got)]
    for name, a, b in zip(names, got, _jax_autodiff_grads(arrs, jd),
                          strict=True):
        np.testing.assert_allclose(a, b, err_msg=f"{case} {name} jax.grad",
                                   **tol)
    packed = _zero_pad_rows(arrs)
    got = _port_grads(packed, td)
    for name, a, b in zip(names, got, _jax_kernel_grads(packed, jd),
                          strict=True):
        np.testing.assert_allclose(a, b, err_msg=f"{case} {name} Pallas",
                                   **tol)


def test_seg_pad_rows_and_pages_are_independent():
    """At the pad rows (seg 0) the plain backward gives the fully masked
    row's gradient (dv gets g/S at every key, no dq); where the Pallas
    kernels rebuild p = 1 instead, their dv there is S times too large.
    And a page's gradients do not depend on another page of its row."""
    arrs = _mk_seg(mask="packed", seed=5)
    got = _port_grads(arrs, torch.float32)
    pad = arrs["seg"] == 0                                  # [B, L]
    assert not got[0].transpose(0, 2, 1, 3)[pad].any()      # dq at pad rows
    kern = _jax_kernel_grads(arrs, jnp.float32)
    want = _jax_autodiff_grads(arrs, jnp.float32)
    # the all-pad batch row: true dv = sum_l g / S at every key
    last = arrs["g"][-1].sum(axis=1, keepdims=True) / arrs["seg"].shape[1]
    np.testing.assert_allclose(got[2][-1], np.broadcast_to(
        last, got[2][-1].shape), **F32)
    np.testing.assert_allclose(kern[2][-1], 48 * want[2][-1], **F32)
    # moving page 3 of batch row 0 leaves page 1's dq, dk and dv alone
    other = {n: a.copy() for n, a in arrs.items() if a is not None}
    for n in ("q", "k", "v"):
        other[n][0, :, 14:34] += 1.0
    again = _port_grads(other, torch.float32)
    for a, b in zip(got, again):
        np.testing.assert_allclose(a[0, :, :13], b[0, :, :13], **F32)


def test_cpu_flash_tower_gets_gradients_through_the_function():
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    ov = {"model.num_layers": 2, "model.model_dim": 32, "model.num_heads": 4,
          "model.mlp_dim": 64, "model.out_dim": 16, "model.dtype": "float32",
          "model.dropout": 0.0}
    ids = np.random.default_rng(0).integers(1, 128, size=(6, 24))
    ids[:, 17:] = 0
    ids[-1] = 0                                     # one all-pad page
    ids = torch.from_numpy(ids)
    grads = {}
    for att in ("flash", "dense"):
        cfg = get_config("bert_mini_v5p16", {**ov, "model.attention": att})
        model = build_two_tower(cfg, vocab_size=128, device="cpu").train()
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        out = model.encode_page(ids)
        out.square().sum().backward()
        # the CPU path counts no kernel launch
        assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
        grads[att] = {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}
    for i in range(2):
        for w in ("wq", "wk", "wv"):
            name = f"page_tower.block{i}.attn.{w}.weight"
            assert grads["flash"][name].abs().max() > 0, name
    # same weights (same seed), f32: flash and dense towers agree
    assert grads["flash"].keys() == grads["dense"].keys()
    for name, gf in grads["flash"].items():
        torch.testing.assert_close(gf, grads["dense"][name], msg=name, **F32)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_grad"])
def test_forward_without_gradients_skips_the_function(mode):
    """Serving calls the forward with nothing to record: it goes straight
    to the kernel's wrapper (no grad_fn), with the Function's values."""
    arrs = _mk(L=40, S=40, pad_tail=6)
    q, k, v = (torch.from_numpy(arrs[n]) for n in ("q", "k", "v"))
    mask = torch.from_numpy(arrs["kv_mask"])
    want_out, want_lse = fa.FlashAttention.apply(q, k, v, mask, None, None)
    if mode == "no_grad":
        with torch.no_grad():
            out, lse = fa.flash_forward(q, k, v, mask)
    elif mode == "inference_mode":
        with torch.inference_mode():
            out, lse = fa.flash_forward(q, k, v, mask)
    else:
        out, lse = fa.flash_forward(q, k, v, mask)
    assert out.grad_fn is None and lse.grad_fn is None
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    # and with an input that needs a gradient, the Function records it
    out = fa.flash_attention(q.requires_grad_(True), k, v, mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
