"""The port's CDSSM, Kim-CNN and BiLSTM towers (models/cdssm.py,
models/kim_cnn.py, models/lstm.py, models/conv.py, their factory and
convert.py paths) against the JAX package's TwoTower on the CPU, at small
widths, on the same flax-initialised weights carried over by
convert.params_from_flax and the same numpy-seeded ids. The inputs hold
ragged pad tails, an all-pad row, a word whose trigrams are all pad
(CDSSM) and an interior id 0 (Kim-CNN, LSTM). Dropout is 0.

Tolerances, each with its reason:
* towers at float32: 1e-5 (the same float32 formulas, summed in other
  orders); at bfloat16: 2e-2 (bf16 rounds at other places in the two
  frameworks, as for BERT in test_torch_models.py);
* parameter gradients of the contrastive loss at float32: 1e-4 relative +
  1e-5 absolute (the JAX flash tests' gradient bar);
* the SAME conv against flax's nn.Conv: 1e-5; the max-pool's gradient
  with ties: exact (both split it evenly);
* the weight round trip: exact."""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.models.losses import (
    cosine_contrastive_loss as jax_contrastive)
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import (
    flax_from_state_dict, params_from_flax)
from dnn_page_vectors_tpu_torch.models.conv import Conv, masked_max_pool
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.models.losses import cosine_contrastive_loss
from dnn_page_vectors_tpu_torch.train.loop import Trainer

VOCAB = 97
B = 6
TOWERS = {
    "cdssm": ("cdssm_toy", {"model.embed_dim": 16, "model.conv_channels": 24,
                            "model.out_dim": 12, "data.trigrams_per_word": 4,
                            "data.query_len": 6, "data.page_len": 10}),
    "kim_cnn": ("kim_cnn_v5e8", {"model.embed_dim": 16,
                                 "model.conv_channels": 12,
                                 "model.out_dim": 10, "data.query_len": 6,
                                 "data.page_len": 11}),
    "lstm": ("lstm_words", {"model.embed_dim": 16, "model.model_dim": 16,
                            "model.num_layers": 2, "model.out_dim": 10,
                            "data.query_len": 6, "data.page_len": 11}),
}
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


def _ids(rng, tower, L, K=4):
    """[B, L] (or [B, L, K] trigram) ids: ragged pad tails, an interior
    id 0 (a word of pad trigrams), and a last row of pad only."""
    shape = (B, L, K) if tower == "cdssm" else (B, L)
    ids = rng.integers(1, VOCAB, size=shape).astype(np.int32)
    for r in range(B):
        ids[r, L - (2 * r) % L:] = 0
    ids[0, 2] = 0
    if tower == "cdssm":
        for r in range(B):                   # words of fewer trigrams
            ids[r, :, K - 1 - r % K:] *= (r % 2)
    ids[-1] = 0
    return ids


def _pair(tower, dtype, overrides=None):
    name, ov = TOWERS[tower]
    ov = {**ov, "model.dtype": dtype, "model.dropout": 0.0,
          **(overrides or {})}
    jcfg = jax_get_config(name, ov)
    tcfg = get_config(name, ov)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    rng = np.random.default_rng(0)
    q_ids = _ids(rng, tower, jcfg.data.query_len)
    p_ids = _ids(rng, tower, jcfg.data.page_len)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(q_ids),
                         jnp.asarray(p_ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel, q_ids, p_ids


@pytest.mark.parametrize("tower", list(TOWERS))
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_towers_match_jax(tower, dtype, atol):
    jmodel, params, tmodel, q_ids, p_ids = _pair(tower, dtype)
    for method, ids in (("encode_query", q_ids), ("encode_page", p_ids)):
        want = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                       method=method))
        with torch.no_grad():
            got = getattr(tmodel, method)(torch.from_numpy(ids))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                   err_msg=f"{tower} {method} {dtype}")
        assert not got[-1].any()             # the all-pad row
    # the conv widths really were (3, 4, 5) for Kim-CNN: width 4 pads
    # 1 position before and 2 after
    if tower == "kim_cnn":
        assert tmodel.page_tower.conv_widths == (3, 4, 5)
        assert tmodel.page_tower.conv4.pads == (1, 2)


def _saturate(params):
    """The CDSSM conv kernels scaled up so tanh saturates to exactly +-1
    at most positions: the max-pool then sees tied maxima."""
    out = jax.tree_util.tree_map(lambda a: a, params)
    for tower in ("query_tower", "page_tower"):
        conv = dict(out["params"][tower]["conv"])
        conv["kernel"] = conv["kernel"] * 50.0
        out["params"][tower] = {**out["params"][tower], "conv": conv}
    return out


@pytest.mark.parametrize("tower,saturated", [
    ("cdssm", False), ("cdssm", True), ("kim_cnn", False), ("lstm", False)])
def test_gradients_match_jax_grad(tower, saturated):
    """Every parameter's gradient of the contrastive loss through both
    towers against jax.grad at float32. Embedding row 0 is trained by
    Kim-CNN (no padding_idx: the SAME convs see it beside a page's last
    words); the LSTM carries its state through id 0 and CDSSM masks it, so
    neither reaches it."""
    jmodel, params, tmodel, q_ids, p_ids = _pair(tower, "float32")
    if saturated:
        params = _saturate(params)
        tmodel.load_state_dict(params_from_flax(params), strict=True)

    def jax_loss(p):
        q, pg, _, scale = jmodel.apply(p, jnp.asarray(q_ids),
                                       jnp.asarray(p_ids))
        return jax_contrastive(q, pg, scale)[0]

    want_loss, want = jax.value_and_grad(jax_loss)(params)
    want_sd = params_from_flax(jax.tree_util.tree_map(np.asarray, want))
    tmodel.train()
    q, p, _, scale = tmodel(torch.from_numpy(q_ids), torch.from_numpy(p_ids))
    if saturated:
        h = torch.tanh(tmodel.page_tower.conv(
            tmodel.page_tower.trigram_embed(torch.from_numpy(p_ids))
            .sum(2).transpose(1, 2)))
        assert (h.abs() == 1.0).float().mean() > 0.5    # ties are real
    loss, _ = cosine_contrastive_loss(q, p, scale)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    loss.backward()
    for name, t in tmodel.named_parameters():
        torch.testing.assert_close(t.grad, want_sd[name], msg=name,
                                   **F32_GRAD)
    embed = "trigram_embed" if tower == "cdssm" else "word_embed"
    row0 = tmodel.page_tower.get_submodule(embed).weight.grad[0]
    assert (row0.abs().max() > 0) == (tower == "kim_cnn")


@pytest.mark.parametrize("tower", list(TOWERS))
def test_params_round_trip(tower):
    _, params, tmodel, _, _ = _pair(tower, "float32")
    back = flax_from_state_dict(tmodel.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    again = params_from_flax(back)
    for key, val in tmodel.state_dict().items():
        assert torch.equal(again[key], val), key


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
def test_same_conv_matches_flax(width):
    """Odd and even widths: SAME pads as lax pads."""
    x = np.random.default_rng(width).normal(size=(3, 9, 5)).astype(np.float32)
    conv = fnn.Conv(7, kernel_size=(width,), padding="SAME",
                    dtype=jnp.float32)
    params = conv.init(jax.random.PRNGKey(width), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1, params)       # a nonzero bias too
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    mine = Conv(5, 7, width, compute_dtype=torch.float32)
    mine.load_state_dict(params_from_flax(params))
    got = mine(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_masked_max_pool_splits_ties_like_jax():
    h = np.array([[[1.0, 3.0, 3.0, 2.0, 3.0], [0.5, 0.5, -1.0, 0.5, 0.5]],
                  [[2.0, 2.0, 9.0, 1.0, 1.0], [4.0, 4.0, 4.0, 4.0, 4.0]],
                  [[1.0, 1.0, 1.0, 1.0, 1.0], [2.0, 2.0, 2.0, 2.0, 2.0]]],
                 np.float32)                          # [B=3, C=2, L=5]
    mask = np.array([[1, 1, 1, 0, 1], [1, 0, 1, 1, 0], [0, 0, 0, 0, 0]],
                    bool)
    w = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)

    def jax_pool(h):
        pooled = jnp.where(mask[:, None, :], h, -1e9).max(axis=2)
        return jnp.where(mask.any(1, keepdims=True), pooled, 0.0)

    want = np.asarray(jax_pool(jnp.asarray(h)))
    want_g = np.asarray(jax.grad(lambda h: (jax_pool(h) * w).sum())(
        jnp.asarray(h)))
    th = torch.from_numpy(h).requires_grad_()
    got = masked_max_pool(th, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(th.grad.numpy(), want_g)
    assert th.grad[0, 0, 1] == th.grad[0, 0, 2] == th.grad[0, 0, 4] == 1 / 3


@pytest.mark.parametrize("tower", list(TOWERS))
def test_padding_invariance(tower):
    """Vectors do not depend on how long the pad tail is (the recurrent
    carry passes through pad steps untouched; pad positions never win the
    max-pool)."""
    _, _, tmodel, _, p_ids = _pair(tower, "float32")
    longer = np.concatenate(
        [p_ids, np.zeros((B, 8) + p_ids.shape[2:], np.int32)], axis=1)
    with torch.no_grad():
        v1 = tmodel.encode_page(torch.from_numpy(p_ids))
        v2 = tmodel.encode_page(torch.from_numpy(longer))
    # rows whose last position is real have another right neighbour in
    # Kim-CNN's SAME conv once the tail grows (id 0's trained row, not
    # zero padding), so only rows that already end in pad are invariant
    rows = (p_ids.reshape(B, p_ids.shape[1], -1)[:, -1] == 0).all(-1)
    assert rows.sum() >= 3
    np.testing.assert_allclose(v1.numpy()[rows], v2.numpy()[rows],
                               rtol=1e-5, atol=1e-6)


def test_lstm_order_sensitivity():
    """Unlike the max-pooled CNNs, the recurrent tower distinguishes word
    order."""
    _, _, tmodel, _, p_ids = _pair("lstm", "float32")
    with torch.no_grad():
        fwd = tmodel.encode_page(torch.from_numpy(p_ids))
        rev = tmodel.encode_page(torch.from_numpy(p_ids[:, ::-1].copy()))
    assert (fwd - rev).abs().max() > 1e-4


@pytest.mark.parametrize("tower", list(TOWERS))
def test_packed_rows_and_default_device_refused(tower):
    _, _, tmodel, _, p_ids = _pair(tower, "float32")
    ids = torch.from_numpy(p_ids)
    seg = (ids.reshape(B, ids.shape[1], -1) > 0).any(-1).int()
    with pytest.raises(ValueError, match="packed rows"):
        tmodel.encode_page(ids, seg=seg, nseg=1)
    name, ov = TOWERS[tower]
    with pytest.raises(ValueError, match="transformer page tower"):
        Trainer(get_config(name, {**ov, "train.pack_pages": 4}),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_two_tower(get_config(name, ov), vocab_size=VOCAB)


@pytest.mark.parametrize("name", [n for n, _ in TOWERS.values()])
def test_presets_equal_jax(name):
    """Every field the port's preset has equals the JAX preset's."""
    mine, want = get_config(name), jax_get_config(name)
    assert mine.name == want.name
    for section in ("data", "model", "train", "eval"):
        a, b = getattr(mine, section), getattr(want, section)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), \
                f"{name} {section}.{f.name}"


def test_conv_widths_override_coerces_a_string():
    cfg = get_config("cdssm_toy", {"model.conv_widths": "3,4,5"})
    assert cfg.model.conv_widths == (3, 4, 5)
    assert get_config("cdssm_toy", {"model.conv_widths": [2, 4]}
                      ).model.conv_widths == (2, 4)
    assert get_config("cdssm_toy", {"model.conv_widths": "7"}
                      ).model.conv_widths == (7,)
    assert jax_get_config("cdssm_toy", {"model.conv_widths": "3,4,5"}
                          ).model.conv_widths == (3, 4, 5)
