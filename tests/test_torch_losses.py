"""The port's cosine-contrastive loss (models/losses.py), dense and
chunked, against the JAX package's ``cosine_contrastive_loss``: the loss,
its metrics, and its gradients with respect to q, p, neg and the scale, on
the same numpy-seeded float32 vectors, within 1e-5. The port's chunked
loss is held against JAX's dense loss as well as its chunked one (the JAX
chunked train-step test fails on bf16 noise, not on the math)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.models.losses import (
    cosine_contrastive_loss as jax_loss)
from dnn_page_vectors_tpu_torch.models.losses import cosine_contrastive_loss

TOL = dict(rtol=1e-5, atol=1e-5)
B, D, H = 32, 24, 3


def _inputs(seed, with_neg):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    # pages near their queries, so the in-batch accuracy is not trivial
    p = (q + 0.8 * rng.normal(size=(B, D))).astype(np.float32)
    neg = (rng.normal(size=(B, H, D)).astype(np.float32) if with_neg
           else None)
    return q, p, neg, np.float32(17.5)


def _jax(q, p, neg, scale, chunk, symmetric):
    def f(q, p, neg, scale):
        return jax_loss(q, p, scale, neg, symmetric=symmetric, chunk=chunk)
    argnums = (0, 1, 3) if neg is None else (0, 1, 2, 3)
    (loss, m), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(q), jnp.asarray(p),
        None if neg is None else jnp.asarray(neg), jnp.asarray(scale))
    return (float(loss), float(m["in_batch_acc"]),
            [np.asarray(g) for g in grads])


def _port(q, p, neg, scale, chunk, symmetric):
    t = [None if x is None else torch.tensor(x, requires_grad=True)
         for x in (q, p, neg, scale)]
    loss, m = cosine_contrastive_loss(t[0], t[1], t[3], t[2],
                                      symmetric=symmetric, chunk=chunk)
    assert set(m) == {"loss", "in_batch_acc", "scale"}
    assert m["loss"] is loss and float(m["scale"].detach()) == float(scale)
    loss.backward()
    grads = [x.grad.numpy() for x in t if x is not None]
    return float(loss.detach()), float(m["in_batch_acc"]), grads


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("with_neg", [False, True], ids=["in_batch", "neg"])
@pytest.mark.parametrize("chunk", [0, 8], ids=["dense", "chunked"])
def test_loss_and_grads_match_jax(chunk, with_neg, symmetric):
    q, p, neg, scale = _inputs(1, with_neg)
    got = _port(q, p, neg, scale, chunk, symmetric)
    # the JAX loss of the same kind, and JAX's dense loss
    for want in (_jax(q, p, neg, scale, chunk, symmetric),
                 _jax(q, p, neg, scale, 0, symmetric)):
        np.testing.assert_allclose(got[0], want[0], **TOL)
        assert got[1] == want[1]
        assert 0.0 < got[1] < 1.0
        for a, b in zip(got[2], want[2]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **TOL)


def test_chunk_equal_to_batch_is_the_dense_loss():
    q, p, neg, scale = _inputs(2, True)
    a = _port(q, p, neg, scale, 0, True)
    b = _port(q, p, neg, scale, B, True)
    assert a[0] == b[0]
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)


def test_chunk_must_divide_the_batch():
    q, p, _, scale = _inputs(3, False)
    with pytest.raises(ValueError, match="must divide"):
        _port(q, p, None, scale, 5, True)
    with pytest.raises(ValueError, match="must divide"):
        jax_loss(jnp.asarray(q), jnp.asarray(p), jnp.asarray(scale), chunk=5)
