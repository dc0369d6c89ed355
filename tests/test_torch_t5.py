"""The port's mT5 slice (config mt5_multilingual: the t5 variant of
models/transformer.py, its init in models/factory.py, convert.py, the
biased flash path and evals/recall.py) against the JAX package on the CPU,
at a small size: 2 layers (1 for the trainer), d=64, 4 heads, mlp 128,
page_len 48, query_len 12, the same numpy-seeded inputs and flax weights
carried over by convert.params_from_flax.

Tolerances, each with its reason:
* the relative-position bucket table: exactly equal (an integer table);
* RmsNorm in float32: 1e-6 (the same float32 formula);
* the towers at float32: 1e-5; at bfloat16: 2e-2 (bf16 rounds at other
  places in the two frameworks, as for BERT in test_torch_models.py);
* parameter gradients at float32, the rel_bias table included: 1e-4
  relative + 1e-5 absolute (the JAX flash tests' gradient bar);
* the 3-step loss curve against the JAX Trainer: 1e-5 at float32, 5e-3
  at bfloat16 (as test_torch_train.py holds BERT);
* store rows: 1e-3 (float16 rows of the same vectors); Recall@10: equal
  up to one query (a score tie may order two pages either way)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import build_corpus as jax_build_corpus
from dnn_page_vectors_tpu.data.loader import (
    build_tokenizer as jax_build_tokenizer)
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu.evals.recall import (
    evaluate_recall as jax_evaluate_recall)
from dnn_page_vectors_tpu.infer.bulk_embed import BulkEmbedder as JaxEmbedder
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.models.transformer import RmsNorm as JaxRmsNorm
from dnn_page_vectors_tpu.models.transformer import (
    _relative_position_bucket as jax_bucket)
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu.train.loop import Trainer as JaxTrainer
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import (
    flax_from_state_dict, params_from_flax)
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.models.transformer import (
    RmsNorm, _GatherBias, bucket_table)
from dnn_page_vectors_tpu_torch.train.loop import Trainer

VOCAB = 512
SMALL = {"model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
         "model.mlp_dim": 128, "model.out_dim": 32, "data.page_len": 48,
         "data.query_len": 12}
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("length", [16, 37, 128, 300])
def test_bucket_table_equals_jax(length):
    pos = jnp.arange(length)
    want = np.asarray(jax_bucket(pos[None, :] - pos[:, None]))
    got = bucket_table(length)
    np.testing.assert_array_equal(got, want)
    # distances past 128 share the last bucket of each direction
    assert got.min() == 0 and got.max() <= 31


def test_rms_norm_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 7, 64)) * rng.uniform(0.01, 30, size=(4, 7, 1))
         ).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(JaxRmsNorm(dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x)))
    norm = RmsNorm(64, dtype=torch.float32)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _ids(rng, B, L, all_pad_row=True):
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    for r in range(B):                   # ragged pad tails
        ids[r, L - (5 * r) % (L - 1):] = 0
    if all_pad_row:
        ids[-1] = 0                      # a fully masked row
    return ids


def _pair(attention, dtype, all_pad_row=True):
    ov = {**SMALL, "model.attention": attention, "model.dtype": dtype}
    jcfg = jax_get_config("mt5_multilingual", {**ov, "model.dropout": 0.0})
    tcfg = get_config("mt5_multilingual", {**ov, "model.dropout": 0.0})
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    rng = np.random.default_rng(0)
    q_ids = _ids(rng, 6, jcfg.data.query_len, all_pad_row)
    p_ids = _ids(rng, 6, jcfg.data.page_len, all_pad_row)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(q_ids),
                         jnp.asarray(p_ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel, q_ids, p_ids


def test_t5_params_round_trip():
    _, params, tmodel, _, _ = _pair("dense", "float32")
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    names = {jax.tree_util.keystr(p) for p in flat}
    # the t5 leaves: the bias table, RmsNorm scales, bias-free Dense
    # layers and the gated MLP's two input layers; proj keeps its bias
    for leaf in ("['query_tower']['rel_bias']",
                 "['page_tower']['block1']['ln_mlp']['scale']",
                 "['page_tower']['block0']['wi_0']['kernel']",
                 "['page_tower']['block0']['wi_1']['kernel']",
                 "['page_tower']['proj']['bias']"):
        assert f"['params']{leaf}" in names, leaf
    assert not any("attn" in n and "bias" in n for n in names)
    assert tmodel.query_tower.rel_bias.shape == (32, 4)
    back = flax_from_state_dict(tmodel.state_dict())
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_b)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_b[path], leaf)
    again = params_from_flax(back)
    for key, val in tmodel.state_dict().items():
        assert torch.equal(again[key], val), key


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_t5_towers_match_jax(attention, dtype, atol):
    jmodel, params, tmodel, q_ids, p_ids = _pair(attention, dtype)
    for method, ids in (("encode_query", q_ids), ("encode_page", p_ids)):
        want = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                       method=method))
        with torch.no_grad():
            got = getattr(tmodel, method)(torch.from_numpy(ids))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                   err_msg=f"{method} {attention} {dtype}")


def test_bias_gather_and_its_gradient():
    """_GatherBias is table[buckets] laid out [H, L, L], and its one-hot
    backward equals the gather's own (index_put_ accumulate) up to float32
    sums of up to ~300 terms taken in another order (1e-5)."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(32, 4)).astype(np.float32))
    buckets = torch.from_numpy(bucket_table(37))
    g = torch.from_numpy(rng.normal(size=(4, 37, 37)).astype(np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    got = _GatherBias.apply(a, buckets)
    want = b[buckets].permute(2, 0, 1)
    assert torch.equal(got, want)
    (ga,) = torch.autograd.grad(got, a, g)
    (gb,) = torch.autograd.grad(want, b, g)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_t5_tower_gradients_match_jax_grad(attention):
    """Every parameter's gradient of a loss through both towers, the
    shared rel_bias table included, against jax.grad at float32. No batch
    row is all padding here: the Pallas backward gives a fully masked row
    a different gradient (test_torch_flash_backward.py pins that)."""
    jmodel, params, tmodel, q_ids, p_ids = _pair(attention, "float32",
                                                 all_pad_row=False)
    rng = np.random.default_rng(7)
    wq, wp = (rng.normal(size=(6, 32)).astype(np.float32) for _ in range(2))

    def jax_loss(p):
        q = jmodel.apply(p, jnp.asarray(q_ids), method="encode_query")
        pg = jmodel.apply(p, jnp.asarray(p_ids), method="encode_page")
        return (q * wq).sum() + (pg * wp).sum()

    want = jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(params))
    tmodel.train()                       # dropout 0: only autograd differs
    loss = ((tmodel.encode_query(torch.from_numpy(q_ids))
             * torch.from_numpy(wq)).sum()
            + (tmodel.encode_page(torch.from_numpy(p_ids))
               * torch.from_numpy(wp)).sum())
    loss.backward()
    want_sd = params_from_flax(want)
    got_sd = {n: p.grad for n, p in tmodel.named_parameters()
              if p.grad is not None}
    assert "query_tower.rel_bias" in got_sd and "page_tower.rel_bias" in got_sd
    for name, g in got_sd.items():
        torch.testing.assert_close(g, want_sd[name], msg=name, **F32_GRAD)
    assert got_sd["page_tower.rel_bias"].abs().max() > 0


# -- the trainer ------------------------------------------------------------

TRAIN = {"data.num_pages": 256, "data.vocab_size": 512, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1, "model.model_dim": 64,
         "model.num_heads": 4, "model.mlp_dim": 128, "model.out_dim": 32,
         "train.batch_size": 32, "train.log_every": 1000,
         "train.warmup_steps": 1, "train.learning_rate": 1e-3}
CORPUS = dict(num_pages=256, seed=0, page_len=6, query_len=4, languages=4)


@pytest.mark.parametrize("attention,dtype,tol", [
    ("dense", "float32", 1e-5), ("flash", "float32", 1e-5),
    ("flash", "bfloat16", 5e-3)])
def test_t5_three_step_loss_curve_matches_jax_trainer(tmp_path, attention,
                                                      dtype, tol):
    ov = {**TRAIN, "model.attention": attention, "model.dtype": dtype,
          "model.dropout": 0.0}
    jcfg = jax_get_config("mt5_multilingual",
                          {**ov, "mesh.data": 1, "mesh.model": 1})
    jtr = JaxTrainer(jcfg, corpus=JaxCorpus(**CORPUS),
                     workdir=str(tmp_path / "jax"))
    state = jtr.init_state()
    init = jax.tree_util.tree_map(np.asarray, state.params)
    step, it, rng = jtr.compiled_step(state), iter(jtr.batches()), \
        jtr.base_rng()
    want = []
    for _ in range(3):
        state, m = step(state, next(it), rng)
        want.append(float(m["loss"]))
    tr = Trainer(get_config("mt5_multilingual", ov),
                 corpus=ToyCorpus(**CORPUS), device="cpu")
    tr.model.load_state_dict(params_from_flax(init), strict=True)
    batches = tr.batches()
    got = [float(tr.train_step(next(batches))["loss"]) for _ in range(3)]
    diff = float(np.abs(np.array(got) - np.array(want)).max())
    print(f"t5 loss curve {attention}/{dtype}: port {got} jax {want} "
          f"max diff {diff:.3g}")
    assert diff < tol, (got, want)
    assert len(set(np.round(want, 3))) == 3      # the steps really moved


# -- serving: store and Recall@10 -----------------------------------------------

SERVE = {**SMALL, "data.num_pages": 200, "data.vocab_size": 600,
         "model.attention": "flash", "model.dtype": "float32",
         "eval.embed_batch_size": 64, "eval.store_shard_size": 128}


def test_t5_store_and_recall_match_jax(tmp_path):
    """The 4-language corpus, its SentencePiece tokens, the bulk embed into
    the fp16 store at page_len 48, and evaluate_recall, against the JAX
    package's on the same weights."""
    jcfg = jax_get_config("mt5_multilingual", {
        **SERVE, "model.dropout": 0.0, "eval.embed_stack": 1,
        "data.tokenize_workers": 1})
    tcfg = get_config("mt5_multilingual", SERVE)
    jcorpus, tcorpus = jax_build_corpus(jcfg), build_corpus(tcfg)
    assert tcorpus.languages == 4
    assert [tcorpus.page_text(i) for i in range(8)] == \
        [jcorpus.page_text(i) for i in range(8)]
    jq_tok, jp_tok = jax_build_tokenizer(jcfg, jcorpus)
    tq_tok, tp_tok = build_tokenizer(tcfg, tcorpus)
    assert tp_tok.vocab_size == jp_tok.vocab_size == 600
    jmodel = jax_build(jcfg, vocab_size=600)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((2, 12), jnp.int32),
                         jnp.zeros((2, 48), jnp.int32))
    jemb = JaxEmbedder(jcfg, jmodel, params, jp_tok,
                       make_mesh(MeshConfig(data=1)), query_tok=jq_tok)
    jstore = JaxStore(os.path.join(tmp_path, "jax"), dim=32, shard_size=128)
    jemb.embed_corpus(jcorpus, jstore)
    tmodel = build_two_tower(tcfg, vocab_size=600, device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    temb = BulkEmbedder(tcfg, tmodel, tp_tok, query_tok=tq_tok, device="cpu")
    tstore = VectorStore(os.path.join(tmp_path, "torch"), dim=32,
                         shard_size=128)
    temb.embed_corpus(tcorpus, tstore)
    j_ids, j_vecs = jstore.load_all()
    t_ids, t_vecs = tstore.load_all()
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_vecs.astype(np.float32),
                               j_vecs.astype(np.float32), rtol=0, atol=1e-3)
    want, n_want = jax_evaluate_recall(jemb, jcorpus, jstore,
                                       num_queries=100, k=10)
    got, n_got = evaluate_recall(temb, tcorpus, tstore, num_queries=100,
                                 k=10)
    assert n_got == n_want == 100
    assert got == pytest.approx(want, abs=1 / 100)
