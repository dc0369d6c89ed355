"""The port's BERT-mini towers against the JAX package's TwoTower: the same
flax-initialized weights carried over by convert.params_from_flax, the same
token ids (made with numpy from a seed), dense and flash attention, at
float32 (atol 1e-4) and at bfloat16 (atol 2e-2: bf16 rounds at different
places in the two frameworks). Small geometry: 2 layers, d=64, 4 heads,
mlp 128, vocab 512."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.models.losses import l2_normalize as jax_l2
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import (
    flax_from_state_dict, params_from_flax)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.models.losses import l2_normalize

VOCAB = 512
SMALL = {"model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
         "model.mlp_dim": 128, "model.out_dim": 32}


def _ids(rng, B, L):
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    for r in range(B):                   # ragged pad tails
        ids[r, L - (3 * r) % L:] = 0
    ids[-1] = 0                          # one all-pad row: fully masked
    return ids


def _pair(attention, dtype):
    ov = {**SMALL, "model.attention": attention, "model.dtype": dtype}
    jcfg = jax_get_config("bert_mini_v5p16", {**ov, "model.dropout": 0.0})
    tcfg = get_config("bert_mini_v5p16", ov)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    rng = np.random.default_rng(0)
    q_ids = _ids(rng, 6, jcfg.data.query_len)
    p_ids = _ids(rng, 6, jcfg.data.page_len)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(q_ids),
                         jnp.asarray(p_ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel, q_ids, p_ids


def test_params_round_trip():
    _, params, tmodel, _, _ = _pair("dense", "float32")
    back = flax_from_state_dict(tmodel.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # and forward again: state dict -> flax -> state dict is the identity
    again = params_from_flax(back)
    for key, val in tmodel.state_dict().items():
        assert torch.equal(again[key], val), key


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_towers_match_jax(attention, dtype, atol):
    jmodel, params, tmodel, q_ids, p_ids = _pair(attention, dtype)
    for method, ids in (("encode_query", q_ids), ("encode_page", p_ids)):
        want = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                       method=method))
        with torch.no_grad():
            got = getattr(tmodel, method)(torch.from_numpy(ids))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                   err_msg=f"{method} {attention} {dtype}")
    want_scale = float(jmodel.apply(params, method="scale"))
    assert float(tmodel.scale().detach()) == pytest.approx(want_scale, rel=1e-6)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    x[0] = 0.0                            # eps keeps the zero row finite
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_factory_refuses_unported_encoders():
    cfg = get_config("bert_mini_v5p16", {"model.encoder": "cdssm"})
    with pytest.raises(NotImplementedError, match="slice 5"):
        build_two_tower(cfg, vocab_size=VOCAB, device="cpu")
