"""Ring attention (parallel/ring_attention.py) against the JAX package's
``ring_attention`` and ``reference_attention`` on the CPU.

The JAX side runs on its 8 fake CPU devices (a (1, 1, seq) mesh), the
port in `seq` spawned processes over gloo (tests/torch_dist.py), each
holding its block of the sequence; the blocks are put back together
here. Bars, the JAX package's (tests/test_ring_attention.py): values and
gradients (q, k, v and the T5 table) within 2e-5, at seq 2 and 4, with
the T5 bias, at seq 1 (one rank: the whole sequence), and at a row whose
keys are all masked across the ring (the JAX carry's mean of V over
every key)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.models.transformer import _relative_position_bucket
from dnn_page_vectors_tpu.ops.flash_attention import reference_attention
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu.parallel.ring_attention import (
    ring_attention as jax_ring)
from dnn_page_vectors_tpu_torch.models.transformer import (
    relative_position_bucket)
from dnn_page_vectors_tpu_torch.parallel.ring_attention import (
    local_block, ring_attention)

from torch_dist import ring_rank, run_ranks

TOL = 2e-5


def _inputs(B=2, H=2, L=32, Dh=16, seed=0, pad_tail=5, all_pad_row=None):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, L, Dh)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, L), bool)
    mask[:, -pad_tail:] = False
    if all_pad_row is not None:
        mask[all_pad_row] = False
    table = rng.normal(size=(32, H)).astype(np.float32)
    return q, k, v, mask, table, g


def _jax(q, k, v, mask, table, g, seq):
    """JAX ring attention's out and its gradients against cotangent g
    (w.r.t. q, k, v and the table), and the reference's out."""
    mesh = make_mesh(MeshConfig(1, 1, seq))
    L = q.shape[2]
    kw = {}
    if table is not None:
        kw = dict(bucket_fn=_relative_position_bucket)

    def f(q, k, v, t):
        extra = dict(kw, bias_table=t) if table is not None else {}
        return jax_ring(mesh, q, k, v, jnp.asarray(mask), **extra)

    t = jnp.asarray(table if table is not None else np.zeros((32, 2)))
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)), t)
    grads = vjp(jnp.asarray(g))
    pos = jnp.arange(L)
    bias = (None if table is None else
            t[_relative_position_bucket(pos[None, :] - pos[:, None])
              ].transpose(2, 0, 1))
    ref = reference_attention(*map(jnp.asarray, (q, k, v)),
                              jnp.asarray(mask), bias=bias)
    names = ("dq", "dk", "dv", "dtable")
    return np.asarray(out), np.asarray(ref), {
        n: np.asarray(x) for n, x in zip(names, grads)}


def _port(q, k, v, mask, table, g, seq):
    ranks = run_ranks(ring_rank, seq, q, k, v, mask, table, g)
    cat = lambda key: np.concatenate([r[key] for r in ranks], axis=2)
    grads = {n: cat(n) for n in ("dq", "dk", "dv")}
    if table is not None:
        grads["dtable"] = sum(r["dtable"] for r in ranks)
    return cat("out"), grads


def _check(got, got_grads, want, ref, want_grads):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    for n, x in got_grads.items():
        np.testing.assert_allclose(x, want_grads[n], rtol=TOL, atol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_matches_jax_values_and_gradients(eight_devices, seq):
    q, k, v, mask, _, g = _inputs()
    want, ref, wg = _jax(q, k, v, mask, None, g, seq)
    got, gg = _port(q, k, v, mask, None, g, seq)
    _check(got, gg, want, ref, wg)


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_t5_bias_matches_jax(eight_devices, seq):
    q, k, v, mask, table, g = _inputs(L=64, seed=7)
    want, ref, wg = _jax(q, k, v, mask, table, g, seq)
    got, gg = _port(q, k, v, mask, table, g, seq)
    _check(got, gg, want, ref, wg)
    assert np.abs(gg["dtable"]).max() > 0


def test_ring_all_pad_row_is_the_mean_of_v(eight_devices):
    q, k, v, mask, table, g = _inputs(seed=3, all_pad_row=1)
    want, _, wg = _jax(q, k, v, mask, table, g, 2)
    got, gg = _port(q, k, v, mask, table, g, 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for n in gg:
        np.testing.assert_allclose(gg[n], wg[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    # every query of the all-pad row: the mean of V over the row's keys
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), v[1].shape), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_ring_of_one_rank_matches_jax(eight_devices, bias):
    """seq=1 (no group): the whole sequence in this process."""
    q, k, v, mask, table, g = _inputs(seed=5)
    table = table if bias else None
    want, ref, wg = _jax(q, k, v, mask, table, g, 1)
    t = lambda a: torch.tensor(a, requires_grad=True)
    tq, tk, tv = t(q), t(k), t(v)
    tt = None if table is None else t(table)
    L = q.shape[2]
    dist_b = torch.from_numpy(relative_position_bucket(np.arange(-(L - 1),
                                                                  L)))
    out = ring_attention(tq, tk, tv, torch.tensor(mask), None,
                         bias_table=tt, bucket_fn=None if tt is None
                         else (lambda rel: dist_b[rel + L - 1]))
    out.backward(torch.tensor(g))
    grads = {"dq": tq.grad.numpy(), "dk": tk.grad.numpy(),
             "dv": tv.grad.numpy()}
    if tt is not None:
        grads["dtable"] = tt.grad.numpy()
    _check(out.detach().numpy(), grads, want, ref, wg)


def test_ring_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="must be divisible"):
        local_block(30, 4, 0)
    assert local_block(32, 4, 3) == slice(24, 32)
    x = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="given together"):
        ring_attention(x, x, x, torch.ones(1, 8, dtype=torch.bool),
                       bias_table=torch.zeros(32, 1))
    with pytest.raises(ValueError, match="given together"):
        ring_attention(x, x, x, torch.ones(1, 8, dtype=torch.bool),
                       bucket_fn=lambda r: r)
