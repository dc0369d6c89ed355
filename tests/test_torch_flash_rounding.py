"""A CPU rehearsal of the numerics of the port's tensor-core flash kernels
(``csrc/flash_fwd.cu``'s bf16 K1 and ``csrc/flash_bwd.cu``'s bf16 K2, K3
and K4), held against the JAX package.

The kernels cannot run here, so this file emulates them in plain PyTorch,
rounding exactly where they round and accumulating in float32 where they
do (``mma.sync`` takes bf16 operands and sums in f32):

* K1: scores q.k^T in f32 from the bf16 q and k, scaled, plus the f32
  bias, masked with -1e30; an online softmax in f32 (running max,
  running sum) over the kernel's key tiles (32 keys with the bias when
  S > 32, else 64, or S rounded up to 16 when that is less); the tile's
  unnormalised probabilities
  rounded to bf16 before the product with the bf16 v; out divided by the
  row sum at the end; lse = max + log(sum).
* K3: p rebuilt in f32 from the saved lse; g, p and ds each as a pair of
  bf16 values (hi = bf16(x), lo = bf16(x - hi): about 16 bits of x
  together), each product taken on the pairs and summed in f32:
  dp = (g_hi + g_lo).v^T, dv = p_hi.g_hi + p_lo.g_hi + p_hi.g_lo,
  dk = scale * (ds_hi + ds_lo)^T.q. delta comes from K2 or K4, which are
  unchanged: sum(g * out) in f32 from the f32 g. With each operand
  rounded once, the rounding of g stays in dp - delta, which cancels
  where p is peaked (at S=1 the true dk is 0 and dk is off by 4e-2,
  test_k3_needs_hi_lo_pairs), and the rounding of p adds up over the
  query rows in dv (at BERT-mini's training shape on the card, four dv
  elements of 134 M fell outside the tolerance).
* K2 (K4 with a bias): p rebuilt in f32 from the saved lse; delta =
  sum(g * out) in f32 from the f32 g; g as a hi + lo pair in dp =
  (g_hi + g_lo).v^T; ds = p (dp - delta) in f32; dq = scale * (ds_hi +
  ds_lo).k, summed over 16-key steps in order; K4's dbias from the f32 ds,
  summed in batch-row order inside each group of DBIAS_GROUP rows and then
  over the groups in order. With g or ds rounded once, dq leaves the
  tolerance where attention is peaked (test_k2_needs_hi_lo_pairs).

With segment ids (sequence packing) every kernel rounds as above; only the
set of allowed pairs changes (a real key of the row's own segment > 0).

The emulations are held against ``reference_attention`` and ``jax.grad``
of it, and against the Pallas kernels in interpret mode (as
tests/test_flash_attention.py runs them), at mT5's and BERT-mini's head
shapes (Dh=64; L=S=128 with the T5 bias, L=S=64 without; a ragged case;
packed rows with segment ids, with and without the bias), with the
tolerances of the JAX flash tests for bf16: 2e-2 on the output and the
lse, 2e-2 relative + 2e-2 absolute on gradients. Against the Pallas
backward the packed cases zero the upstream gradient at the pad rows, as a
packed model's is: the Pallas kernels rebuild p = 1 at a fully masked
row (tests/test_torch_flash_backward.py)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.ops.flash_attention import (
    _flash_backward, _flash_forward, reference_attention as jax_reference)
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

FWD_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = dict(rtol=2e-2, atol=2e-2)
KEY_TILE = 64
BIAS_KEY_TILE = 32
BF16 = torch.bfloat16


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), back in f32."""
    return x.to(BF16).float()


def _scores(q, k, kv_mask, bias, seg=None):
    """[B,H,L,S] f32 scores as the kernels build them: allowed (a real
    key, of the row's own segment with `seg`), and masked with -1e30 where
    not."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[None].float()
    allowed = fa.allowed_pairs(kv_mask, seg).expand_as(s)
    return torch.where(allowed, s, torch.full_like(s, fa.NEG_INF)), allowed


def k1_key_tile(S: int, bias) -> int:
    """The bf16 K1's key tile, chosen as ``flash_fwd_bf16`` chooses it."""
    if bias is not None and S > BIAS_KEY_TILE:
        return BIAS_KEY_TILE
    return min(KEY_TILE, -(-S // 16) * 16)


def emulate_k1(q, k, v, kv_mask, bias=None, seg=None):
    """(out, lse) as the bf16 K1 computes them (see the module
    docstring)."""
    s, _ = _scores(q, k, kv_mask, bias, seg)
    B, H, L, S = s.shape
    tile = k1_key_tile(S, bias)
    m = torch.full((B, H, L), -math.inf)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(B, H, L, q.shape[-1])
    for c0 in range(0, S, tile):
        st = s[..., c0:c0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhls,bhsd->bhld", _bf16(p), v[:, :, c0:c0 + tile].float())
        m = m_new
    return acc / l[..., None], m + torch.log(l)


def _split(x):
    """(hi, lo): x as two bf16 values, hi = bf16(x), lo = bf16(x - hi)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def emulate_k3(q, k, v, kv_mask, g, lse, delta, bias=None, split=True,
               seg=None):
    """(dk, dv) in f32 as the bf16 K3 computes them (see the module
    docstring); a fully masked row (lse <= -1e29) gets p = 1/S, ds = 0.
    `split=False` rounds g, p and ds once instead."""
    S = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s, allowed = _scores(q, k, kv_mask, bias, seg)
    masked_row = (lse <= fa.MASKED_ROW_LSE)[..., None]
    p = torch.where(allowed, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    p = torch.where(masked_row, torch.full_like(p, 1.0 / S), p)
    g_hi, g_lo = _split(g.float())
    zero = torch.zeros_like
    if not split:
        g_lo = zero(g_lo)
    # each product on hi + lo (exact in f32): the sum of two products
    dp = torch.einsum("bhld,bhsd->bhls", g_hi + g_lo, v.float())
    ds = torch.where(allowed & ~masked_row, p * (dp - delta[..., None]),
                     torch.zeros_like(p))
    (p_hi, p_lo), (ds_hi, ds_lo) = _split(p), _split(ds)
    if not split:
        p_lo, ds_lo = zero(p_lo), zero(ds_lo)
    dv = (torch.einsum("bhls,bhld->bhsd", p_hi, g_hi + g_lo)
          + torch.einsum("bhls,bhld->bhsd", p_lo, g_hi))
    dk = torch.einsum("bhls,bhld->bhsd", ds_hi + ds_lo, q.float()) * scale
    return dk, dv


def emulate_k2(q, k, v, kv_mask, g, out, lse, bias=None, split_g=True,
               split_ds=True, seg=None):
    """(dq, delta, dbias) in f32 as the bf16 K2 computes them, or K4 with a
    bias (dbias is None without one; see the module docstring); a fully
    masked row (lse <= -1e29) adds nothing to dq or dbias. `split_g=False`
    rounds g once instead of pairing it, `split_ds=False` ds."""
    B, S = k.shape[0], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s, allowed = _scores(q, k, kv_mask, bias, seg)
    live = allowed & (lse > fa.MASKED_ROW_LSE)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (g.float() * out).sum(-1)
    g_hi, g_lo = _split(g.float())
    if not split_g:
        g_lo = torch.zeros_like(g_lo)
    dp = torch.einsum("bhld,bhsd->bhls", g_hi + g_lo, v.float())
    ds = torch.where(live, p * (dp - delta[..., None]), torch.zeros_like(p))
    ds_hi, ds_lo = _split(ds)
    if not split_ds:
        ds_lo = torch.zeros_like(ds_lo)
    dq = torch.zeros(q.shape)
    for c0 in range(0, S, 16):               # the kernels' 16-key steps
        dq += torch.einsum("bhls,bhsd->bhld", (ds_hi + ds_lo)[..., c0:c0 + 16],
                           k[:, :, c0:c0 + 16].float())
    dbias = None
    if bias is not None:
        dbias = torch.zeros(ds.shape[1:])
        for b0 in range(0, B, fa.DBIAS_GROUP):
            part = torch.zeros(ds.shape[1:])
            for b in range(b0, min(B, b0 + fa.DBIAS_GROUP)):
                part = part + ds[b]
            dbias = dbias + part
    return dq * scale, delta, dbias


def _mk(B, H, L, S, Dh=64, pad_tail=5, bias=False, seed=0, peak=1.0):
    """numpy inputs; `peak` scales q and k (a larger one peaks the softmax,
    as trained attention is)."""
    rng = np.random.default_rng(seed)
    arrs = {n: rng.normal(size=(B, H, ln, Dh)).astype(np.float32)
            for n, ln in (("q", L), ("k", S), ("v", S), ("g", L))}
    arrs["q"] *= peak
    arrs["k"] *= peak
    mask = np.ones((B, S), bool)
    mask[:, S - pad_tail:] = False
    mask[0, S // 2:] = False          # a second, shorter page
    arrs["kv_mask"] = mask
    arrs["bias"] = (rng.normal(size=(H, L, S)).astype(np.float32)
                    if bias else None)
    return arrs


CASES = {
    "bert_mini_L64": dict(B=2, H=4, L=64, S=64),
    "bert_query_L16": dict(B=2, H=4, L=16, S=16, pad_tail=3),
    "mt5_L128_bias": dict(B=2, H=2, L=128, S=128, bias=True),
    "mt5_query_L16_bias": dict(B=2, H=2, L=16, S=16, pad_tail=3, bias=True),
    "ragged_L37_S53_bias": dict(B=2, H=2, L=37, S=53, pad_tail=7, bias=True),
    "one_key_S1": dict(B=2, H=2, L=64, S=1, pad_tail=0),
}


def _torch_inputs(arrs):
    t = {n: torch.from_numpy(arrs[n]) for n in ("q", "k", "v", "g")}
    q, k, v = (t[n].to(BF16) for n in ("q", "k", "v"))
    bias = None if arrs["bias"] is None else torch.from_numpy(arrs["bias"])
    return q, k, v, torch.from_numpy(arrs["kv_mask"]), bias, t["g"]


def _jax_inputs(arrs):
    q, k, v = (jnp.asarray(arrs[n], jnp.bfloat16) for n in ("q", "k", "v"))
    bias = None if arrs["bias"] is None else jnp.asarray(arrs["bias"])
    return q, k, v, jnp.asarray(arrs["kv_mask"]), bias, jnp.asarray(arrs["g"])


@pytest.mark.parametrize("case", list(CASES))
def test_k1_rounding_matches_jax(case):
    arrs = _mk(**CASES[case])
    q, k, v, mask, bias, _ = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask, bias)
    jq, jk, jv, jmask, jbias, _ = _jax_inputs(arrs)
    want = np.asarray(jax_reference(jq, jk, jv, jmask, jbias))
    np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
    # the Pallas forward in interpret mode, blocks of 16
    k_out, k_lse = _flash_forward(jq, jk, jv, jmask, jbias, None, 16, 16,
                                  True)
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(k_lse), **FWD_TOL)
    # and the port's plain version, which rounds the normalised p instead
    p_out, p_lse = fa.reference_forward(q, k, v, mask, bias)
    np.testing.assert_allclose(out.numpy(), p_out.numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), p_lse.numpy(), **FWD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_k3_rounding_matches_jax(case):
    arrs = _mk(**CASES[case])
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask, bias)
    delta = (g * out).sum(-1)                  # K2's (or K4's) delta, f32
    dk, dv = emulate_k3(q, k, v, mask, g, lse, delta, bias)
    jq, jk, jv, jmask, jbias, jg = _jax_inputs(arrs)
    if jbias is None:
        _, vjp = jax.vjp(lambda q, k, v: jax_reference(q, k, v, jmask),
                         jq, jk, jv)
    else:
        _, vjp = jax.vjp(lambda q, k, v: jax_reference(q, k, v, jmask, jbias),
                         jq, jk, jv)
    _, want_dk, want_dv = (np.asarray(x.astype(jnp.float32))
                           for x in vjp(jg))
    np.testing.assert_allclose(dk.numpy(), want_dk, err_msg="dk", **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, err_msg="dv", **GRAD_TOL)
    # the Pallas backward in interpret mode, blocks of 16, on its forward
    k_out, k_lse = _flash_forward(jq, jk, jv, jmask, jbias, None, 16, 16,
                                  True)
    kern = _flash_backward(jq, jk, jv, jmask, jbias, None, jg, k_out, k_lse,
                           16, 16, True)
    for name, a, b in (("dk", dk, kern[1]), ("dv", dv, kern[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(
            b.astype(jnp.float32)), err_msg=name, **GRAD_TOL)
    # and the port's plain backward (K3's oracle on the card)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    for name, a, b in (("dk", dk, want[1]), ("dv", dv, want[2])):
        torch.testing.assert_close(a, b.float(), msg=name, **GRAD_TOL)


def test_k3_rounding_at_a_fully_masked_row():
    """A batch row with no allowed key: the emulated K3 gives dv = g/S for
    every key and no dk, as jax.grad of the reference does."""
    arrs = _mk(B=2, H=2, L=16, S=16, pad_tail=0, seed=3)
    arrs["kv_mask"][1] = False
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask)
    torch.testing.assert_close(out[1], v[1].float().mean(1, keepdim=True)
                               .expand_as(out[1]), **FWD_TOL)
    dk, dv = emulate_k3(q, k, v, mask, g, lse, (g * out).sum(-1))
    jq, jk, jv, jmask, _, jg = _jax_inputs(arrs)
    _, vjp = jax.vjp(lambda q, k, v: jax_reference(q, k, v, jmask),
                     jq, jk, jv)
    _, want_dk, want_dv = (np.asarray(x.astype(jnp.float32))
                           for x in vjp(jg))
    np.testing.assert_allclose(dk.numpy(), want_dk, **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, **GRAD_TOL)
    assert not dk[1].any()


def test_k3_needs_hi_lo_pairs():
    """At S=1 every row's p is 1, so dp = delta and the true dk is 0; with
    g rounded once to bf16, dk holds the rounding of g.v (about 4e-2),
    past the tolerance against the plain backward. This is why K3 keeps
    its operands as hi + lo pairs."""
    arrs = _mk(**CASES["one_key_S1"])
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask, bias)
    delta = (g * out).sum(-1)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    dk, _ = emulate_k3(q, k, v, mask, g, lse, delta, bias, split=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(dk, want[1].float(), **GRAD_TOL)
    dk, dv = emulate_k3(q, k, v, mask, g, lse, delta, bias)
    torch.testing.assert_close(dk, want[1].float(), **GRAD_TOL)
    torch.testing.assert_close(dv, want[2].float(), **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_k2_k4_rounding_matches_jax(case):
    """The emulated K2 (K4 with a bias): dq, and dbias, against jax.grad of
    the reference attention, the Pallas backward in interpret mode, and the
    port's plain backward; delta as the JAX backward computes it."""
    c = CASES[case]
    arrs = _mk(**{**c, "B": max(c["B"], 3)})     # K4's group order over 3 rows
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask, bias)
    dq, delta, dbias = emulate_k2(q, k, v, mask, g, out, lse, bias)
    assert (dbias is None) == (bias is None)
    jq, jk, jv, jmask, jbias, jg = _jax_inputs(arrs)
    if jbias is None:
        _, vjp = jax.vjp(lambda q: jax_reference(q, jk, jv, jmask), jq)
        (want_dq,) = vjp(jg)
    else:
        _, vjp = jax.vjp(lambda q, b: jax_reference(q, jk, jv, jmask, b),
                         jq, jbias)
        want_dq, want_db = vjp(jg)
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want_db),
                                   err_msg="dbias", **GRAD_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(
        want_dq.astype(jnp.float32)), err_msg="dq", **GRAD_TOL)
    # the Pallas backward in interpret mode, blocks of 16, on its forward
    k_out, k_lse = _flash_forward(jq, jk, jv, jmask, jbias, None, 16, 16,
                                  True)
    kern = _flash_backward(jq, jk, jv, jmask, jbias, None, jg, k_out, k_lse,
                           16, 16, True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(
        kern[0].astype(jnp.float32)), err_msg="dq", **GRAD_TOL)
    if bias is not None:
        np.testing.assert_allclose(dbias.numpy(), np.asarray(kern[3]),
                                   err_msg="dbias", **GRAD_TOL)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jnp.einsum(
        "bhld,bhld->bhl", jg, k_out)), **FWD_TOL)
    # and the port's plain backward (K2's and K4's oracle on the card)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    torch.testing.assert_close(dq, want[0].float(), msg="dq", **GRAD_TOL)
    if bias is not None:
        torch.testing.assert_close(dbias, want[3], msg="dbias", **GRAD_TOL)


def test_k2_k4_rounding_at_a_fully_masked_row():
    """A batch row with no allowed key adds nothing to dq or dbias in the
    emulated K2 and K4, as jax.grad of the reference agrees."""
    arrs = _mk(B=3, H=2, L=16, S=16, pad_tail=0, bias=True, seed=4)
    arrs["kv_mask"][1] = False
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask, bias)
    jq, jk, jv, jmask, jbias, jg = _jax_inputs(arrs)
    _, vjp = jax.vjp(lambda q, b: jax_reference(q, jk, jv, jmask, b),
                     jq, jbias)
    want_dq, want_db = (np.asarray(x.astype(jnp.float32)) for x in vjp(jg))
    for b in (None, bias):
        dq, _, dbias = emulate_k2(q, k, v, mask, g, out, lse, b)
        assert not dq[1].any()
        if b is not None:
            np.testing.assert_allclose(dbias.numpy(), want_db, **GRAD_TOL)
            np.testing.assert_allclose(dq.numpy(), want_dq, **GRAD_TOL)
    rest = emulate_k2(q[::2], k[::2], v[::2], mask[::2], g[::2], out[::2],
                      lse[::2], bias)[2]
    torch.testing.assert_close(dbias, rest, **GRAD_TOL)


@pytest.mark.parametrize("operand", ["g", "ds"])
def test_k2_needs_hi_lo_pairs(operand):
    """Where attention is peaked (q and k scaled by 4, BERT-mini's head
    shape), dp - delta cancels and ds holds large terms that nearly cancel
    in dq: with g or ds rounded once to bf16, dq leaves the tolerance
    against the plain backward (by 3.1x and 2.7x here); with both as hi +
    lo pairs it stays at a fifth of it. This is why K2 and K4 keep both as
    pairs."""
    arrs = _mk(B=8, H=4, L=64, S=64, peak=4.0, seed=0)
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    out, lse = emulate_k1(q, k, v, mask, bias)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)[0].float()
    once = emulate_k2(q, k, v, mask, g, out, lse, bias,
                      split_g=operand != "g", split_ds=operand != "ds")[0]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(once.to(BF16).float(), want, **GRAD_TOL)
    dq = emulate_k2(q, k, v, mask, g, out, lse, bias)[0]
    torch.testing.assert_close(dq.to(BF16).float(), want, **GRAD_TOL)


def _mk_packed(B, H, L, bias=False, seed=0, pack=4):
    """numpy inputs of packed rows: `pack` pages a row of random lengths
    (one of them a single token), a pad tail, kv_mask = seg > 0 as the
    towers pass it, and the last batch row all pad."""
    arrs = _mk(B, H, L, L, pad_tail=0, bias=bias, seed=seed)
    rng = np.random.default_rng(seed + 1)
    seg = np.zeros((B, L), np.int32)
    for b in range(B - 1):
        lens = rng.integers(1, L // pack, size=pack)
        lens[b % pack] = 1
        c = 0
        for s, n in enumerate(lens):
            seg[b, c:c + n] = s + 1
            c += n
    arrs["seg"] = seg
    arrs["kv_mask"] = seg > 0
    return arrs


SEG_CASES = {
    "packed_L64": dict(B=3, H=4, L=64),
    "packed_L128_bias": dict(B=3, H=2, L=128, bias=True),
    "packed_L96_bias": dict(B=4, H=2, L=96, bias=True, pack=2),
}


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_rounding_matches_jax(case):
    """The emulated bf16 K1, K2 (K4 with the bias) and K3 with segment ids:
    out and lse against the JAX reference and the Pallas forward with seg;
    dq, dk, dv (and dbias) against jax.grad of the reference with seg, the
    Pallas backward with seg (g zeroed at the pad rows, as a packed model's
    is) and the port's plain backward with seg."""
    arrs = _mk_packed(**SEG_CASES[case])
    q, k, v, mask, bias, g = _torch_inputs(arrs)
    seg = torch.from_numpy(arrs["seg"])
    out, lse = emulate_k1(q, k, v, mask, bias, seg)
    jq, jk, jv, jmask, jbias, jg = _jax_inputs(arrs)
    jseg = jnp.asarray(arrs["seg"])
    want = np.asarray(jax_reference(jq, jk, jv, jmask, jbias, jseg))
    np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
    k_out, k_lse = _flash_forward(jq, jk, jv, jmask, jbias, jseg, 16, 16,
                                  True)
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(k_lse), **FWD_TOL)

    def grads(g):
        dq, delta, dbias = emulate_k2(q, k, v, mask, g, out, lse, bias,
                                      seg=seg)
        dk, dv = emulate_k3(q, k, v, mask, g, lse, delta, bias, seg=seg)
        got = [dq, dk, dv] + ([] if bias is None else [dbias])
        return [x.numpy() for x in got]

    names = ("dq", "dk", "dv", "dbias")
    leaves = (jq, jk, jv) + (() if jbias is None else (jbias,))
    _, vjp = jax.vjp(lambda *t: jax_reference(
        *t[:3], jmask, t[3] if len(t) > 3 else None, jseg), *leaves)
    for name, a, b in zip(names, grads(g), vjp(jg)):
        np.testing.assert_allclose(a, np.asarray(b.astype(jnp.float32)),
                                   err_msg=f"{name} jax.grad", **GRAD_TOL)
    live = torch.from_numpy(arrs["seg"] > 0)[:, None, :, None]
    g0 = g * live
    kern = _flash_backward(jq, jk, jv, jmask, jbias, jseg, jnp.asarray(
        g0.numpy()), k_out, k_lse, 16, 16, True)
    got = grads(g0)
    for name, a, b in zip(names, got, kern):
        np.testing.assert_allclose(a, np.asarray(b.astype(jnp.float32)),
                                   err_msg=f"{name} Pallas", **GRAD_TOL)
    plain = fa.reference_backward(q, k, v, mask, g0, out, lse, bias, seg)
    for name, a, b in zip(names, got, plain):
        np.testing.assert_allclose(a, b.float().numpy(),
                                   err_msg=f"{name} plain", **GRAD_TOL)
