"""Sequence packing in the port (train.pack_pages: data/loader.py
``pack_segments`` and ``TrainBatcher(pack=...)``, the packed towers of
models/transformer.py and models/two_tower.py, the trainer's packed step,
and the ``bert_long_sp`` config) against the JAX package on the CPU.

Tolerances, each with its reason:
* packed rows, segment ids, local positions and whole packed batches:
  byte-identical (pure functions of the token lengths);
* packed page vectors against the JAX ``encode_page(seg, pos, nseg)`` on
  the same flax-initialised weights through convert.py: 1e-4 at float32,
  2e-2 at bfloat16 (bf16 rounds at other places in the two frameworks), as
  tests/test_torch_models.py holds the unpacked towers;
* no leak across packed pages: a page's vector moves by less than 1e-5
  when another page of its row changes (float32), as tests/test_packing.py
  pins it in JAX;
* the packed 3-step loss curve against the unpacked one on the same
  weights: 1e-3, as tests/test_packing.py pins it in JAX; against the JAX
  Trainer's packed curve at float32 on the same weights: 1e-5, as
  tests/test_torch_train.py holds the unpacked curve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import TrainBatcher as JaxBatcher
from dnn_page_vectors_tpu.data.loader import _waterfill as jax_waterfill
from dnn_page_vectors_tpu.data.loader import build_tokenizer as jax_tokenizer
from dnn_page_vectors_tpu.data.loader import pack_segments as jax_pack
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.train.loop import Trainer as JaxTrainer
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import params_from_flax
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, _waterfill, build_tokenizer, pack_segments)
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
from dnn_page_vectors_tpu_torch.train.loop import Trainer

VOCAB = 512
# 2 layers, d=64, 4 heads (Dh=16), page rows of 96 tokens
TOWER = {"model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
         "model.mlp_dim": 128, "model.out_dim": 32, "data.page_len": 96,
         "data.query_len": 12}
VARIANT_CONFIG = {"bert": "bert_mini_v5p16", "t5": "mt5_multilingual"}


def _enc(lens, L, seed=0, vocab=30_000):
    """Left-aligned token rows (ids in [1, vocab)) with the given non-pad
    lengths."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lens), L), np.int32)
    for i, n in enumerate(lens):
        out[i, :n] = rng.integers(1, vocab, size=n)
    return out


# -- pack_segments and the batcher --------------------------------------------

@pytest.mark.parametrize("pack,L,seed", [(4, 32, 0), (4, 16, 1), (2, 24, 2),
                                         (8, 64, 3)])
def test_pack_segments_byte_equal_to_jax(pack, L, seed):
    """Rows, segment ids and local positions equal the JAX function's,
    byte for byte, with rows that fit and rows that waterfilling clips
    (random lengths up to L, empty pages among them)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, size=6 * pack)
    enc = _enc(lens, L, seed)
    got, want = pack_segments(enc, pack), jax_pack(enc, pack)
    clipped = 0
    for a, b, name in zip(got, want, ("rows", "seg", "pos")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for r in range(len(lens) // pack):
        part = lens[r * pack:(r + 1) * pack]
        np.testing.assert_array_equal(_waterfill(part, L),
                                      jax_waterfill(part, L))
        clipped += int(part.sum() - (got[1][r] > 0).sum())
    assert clipped > 0                   # waterfilling clipped some rows


def test_pack_segments_rejects_bad_shapes():
    with pytest.raises(ValueError, match="divide"):
        pack_segments(_enc([3, 3, 3], 16), pack=2)
    with pytest.raises(ValueError, match="trigram"):
        pack_segments(np.zeros((4, 8, 3), np.int32), pack=2)


SMALL = {"data.num_pages": 256, "data.vocab_size": VOCAB, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1, "train.batch_size": 32,
         "train.log_every": 1000, "train.warmup_steps": 1,
         "train.learning_rate": 1e-3}


@pytest.fixture(scope="module")
def tokenizers():
    # pages of ~10 words: four of them overflow a 32-token row, so the
    # batches carry waterfill-clipped rows
    corpus = dict(num_pages=256, seed=0, page_len=10, query_len=4)
    jcfg = jax_get_config("bert_mini_v5p16", SMALL)
    tcfg = get_config("bert_mini_v5p16", SMALL)
    jc, tc = JaxCorpus(**corpus), ToyCorpus(**corpus)
    return (jc, jax_tokenizer(jcfg, jc)), (tc, build_tokenizer(tcfg, tc))


@pytest.mark.parametrize("start_step", [0, 6], ids=["start", "resume"])
def test_packed_batches_byte_identical_to_jax(tokenizers, start_step):
    (jc, (jq, jp)), (tc, (tq, tp)) = tokenizers
    jb = JaxBatcher(jc, jq, jp, batch_size=32, seed=3, start_step=start_step,
                    process_index=0, process_count=1, pack=4)
    tb = TrainBatcher(tc, tq, tp, batch_size=32, seed=3,
                      start_step=start_step, pack=4)
    clipped = 0
    for (_, want), (_, got) in zip(zip(range(3), jb), zip(range(3), tb)):
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["page"].shape == (8, 32)
        unpacked = tp.encode_batch([tc.page_text(int(i))
                                    for i in got["page_id"]])
        clipped += int((unpacked != 0).sum() - (got["page_seg"] > 0).sum())
    assert clipped > 0


def test_batcher_rejects_misaligned_pack(tokenizers):
    _, (tc, (tq, tp)) = tokenizers
    with pytest.raises(ValueError, match="pack_pages"):
        TrainBatcher(tc, tq, tp, batch_size=30, pack=4)


# -- packed towers --------------------------------------------------------------

def _packed_ids(rng, R, pack, L, vocab=VOCAB):
    """Packed rows of `pack` pages of random lengths (one page empty in the
    last row), with their segment ids and local positions."""
    lens = rng.integers(1, L // pack + 1, size=R * pack)
    lens[-1] = 0
    return pack_segments(_enc(lens, L, int(rng.integers(1 << 30)), vocab),
                         pack)


def _pair(variant, attention, dtype, overrides=None):
    """The JAX TwoTower and the port's, on the same flax-initialised
    weights."""
    ov = {**TOWER, **(overrides or {}), "model.attention": attention,
          "model.dtype": dtype, "model.dropout": 0.0}
    name = VARIANT_CONFIG[variant]
    jcfg, tcfg = jax_get_config(name, ov), get_config(name, ov)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    q = np.ones((2, jcfg.data.query_len), np.int32)
    p = np.ones((2, jcfg.data.page_len), np.int32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jnp.asarray(q), jnp.asarray(p)))
    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel, jcfg


def _encode_both(jmodel, params, tmodel, rows, seg, pos, nseg):
    want = np.asarray(jmodel.apply(
        params, jnp.asarray(rows), method="encode_page",
        seg=jnp.asarray(seg), pos=jnp.asarray(pos), nseg=nseg))
    with torch.no_grad():
        got = tmodel.encode_page(torch.from_numpy(rows), seg=torch.from_numpy(
            seg), pos=torch.from_numpy(pos), nseg=nseg)
    return got, want


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("variant", ["bert", "t5"])
def test_packed_towers_match_jax(variant, attention, dtype, atol):
    jmodel, params, tmodel, jcfg = _pair(variant, attention, dtype)
    rows, seg, pos = _packed_ids(np.random.default_rng(0), 3, 4,
                                 jcfg.data.page_len)
    got, want = _encode_both(jmodel, params, tmodel, rows, seg, pos, 4)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                               err_msg=f"{variant} {attention} {dtype}")


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("variant", ["bert", "t5"])
def test_packed_tower_no_cross_page_leak(variant, attention):
    """Changing page B's tokens must not move page A's vector when the two
    share a row (tests/test_packing.py's pin, at float32)."""
    _, _, tmodel, jcfg = _pair(variant, attention, "float32")
    L = jcfg.data.page_len
    rng = np.random.default_rng(0)
    a = rng.integers(2, 400, size=8).astype(np.int32)
    b1, b2 = (rng.integers(2, 400, size=10).astype(np.int32)
              for _ in range(2))

    def vecs(second):
        enc = np.zeros((2, L), np.int32)
        enc[0, :len(a)] = a
        enc[1, :len(second)] = second
        rows, seg, pos = (torch.from_numpy(x) for x in pack_segments(enc, 2))
        with torch.no_grad():
            return tmodel.encode_page(rows, seg=seg, pos=pos, nseg=2).numpy()

    v1, v2 = vecs(b1), vecs(b2)
    assert np.abs(v1[0, 0] - v2[0, 0]).max() < 1e-5     # page A unmoved
    assert np.abs(v1[0, 1] - v2[0, 1]).max() > 1e-3     # page B moved


def test_packed_page_equals_its_unpacked_encode():
    """A page packed with others gets the vector it gets alone (bert, flash,
    float32): packing is a layout change, not a change of the function."""
    _, _, tmodel, jcfg = _pair("bert", "flash", "float32")
    L = jcfg.data.page_len
    rng = np.random.default_rng(3)
    enc = _enc(rng.integers(5, L // 4, size=8), L, 3, VOCAB)
    rows, seg, pos = (torch.from_numpy(x) for x in pack_segments(enc, 4))
    with torch.no_grad():
        packed = tmodel.encode_page(rows, seg=seg, pos=pos, nseg=4)
        alone = tmodel.encode_page(torch.from_numpy(enc))
    torch.testing.assert_close(packed.reshape(8, -1), alone, rtol=1e-4,
                               atol=1e-5)


def test_packed_two_tower_forward_flattens_in_page_order():
    _, _, tmodel, jcfg = _pair("t5", "flash", "float32")
    rows, seg, pos = (torch.from_numpy(x) for x in _packed_ids(
        np.random.default_rng(4), 2, 4, jcfg.data.page_len))
    queries = torch.randint(1, VOCAB, (8, jcfg.data.query_len),
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        q, p, neg, _ = tmodel(queries, rows, page_seg=seg, page_pos=pos)
        per_row = tmodel.encode_page(rows, seg=seg, pos=pos, nseg=4)
    assert q.shape == p.shape == (8, 32) and neg is None
    assert torch.equal(p, per_row.reshape(8, 32))
    with pytest.raises(ValueError, match="packed rows"):
        tmodel(queries[:7], rows, page_seg=seg, page_pos=pos)


# -- training -------------------------------------------------------------------

# pages of ~4 words fit a quarter of a 96-token row: no clipping, so the
# packed batch holds the unpacked tokens byte for byte
TRAIN = {**TOWER, "data.num_pages": 512, "data.vocab_size": VOCAB,
         "model.dropout": 0.0, "train.batch_size": 32,
         "train.log_every": 1000}
TRAIN_CORPUS = dict(num_pages=512, seed=0, page_len=4, query_len=8)


@pytest.fixture(scope="module")
def train_data():
    cfg = get_config("bert_mini_v5p16", TRAIN)
    corpus = ToyCorpus(**TRAIN_CORPUS)
    return corpus, build_tokenizer(cfg, corpus)


def _curve(cfg, data, state=None, steps=3):
    """The loss curve of `steps` steps of a Trainer on `data`, from the
    seeded weights or `state`."""
    corpus, toks = data
    tr = Trainer(cfg, corpus=corpus, tokenizers=toks, device="cpu")
    if state is not None:
        tr.model.load_state_dict(state, strict=True)
    it = tr.batches()
    return [float(tr.train_step(next(it))["loss"]) for _ in range(steps)]


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("variant", ["bert", "t5"])
def test_packed_training_matches_unpacked_loss_curve(train_data, variant,
                                                     attention):
    """Both runs start from the same seeded weights (the factory's init does
    not depend on packing); the CPU path launches no kernel."""
    base = {**TRAIN, "model.attention": attention}
    name = VARIANT_CONFIG[variant]
    want = _curve(get_config(name, base), train_data)
    before = [getattr(fa, n) for n in fa.COUNTERS]
    got = _curve(get_config(name, {**base, "train.pack_pages": 4}),
                 train_data)
    assert [getattr(fa, n) for n in fa.COUNTERS] == before
    diff = float(np.abs(np.array(got) - np.array(want)).max())
    assert diff < 1e-3, (got, want)
    assert len(set(np.round(want, 3))) == 3          # the steps moved


def test_packed_training_matches_jax_trainer(tmp_path, train_data):
    """3 packed steps (pack 4, f32, dense and flash) from the JAX
    Trainer's initial weights give the JAX Trainer's packed loss curve."""
    ov = {**TRAIN, "train.pack_pages": 4, "model.dtype": "float32",
          "train.warmup_steps": 1, "train.learning_rate": 1e-3}
    jcfg = jax_get_config("bert_mini_v5p16", {**ov, "mesh.data": 1})
    jtr = JaxTrainer(jcfg, corpus=JaxCorpus(**TRAIN_CORPUS),
                     workdir=str(tmp_path / "jax"))
    state = jtr.init_state()
    init = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    step = jtr.compiled_step(state)
    it = iter(jtr.batches())
    rng = jtr.base_rng()
    want = []
    for _ in range(3):
        state, m = step(state, next(it), rng)
        want.append(float(m["loss"]))
    for attention in ("dense", "flash"):
        cfg = get_config("bert_mini_v5p16", {**ov,
                                             "model.attention": attention})
        got = _curve(cfg, train_data, init)
        diff = float(np.abs(np.array(got) - np.array(want)).max())
        assert diff < 1e-5, (attention, got, want)


def test_trainer_refuses_packing_without_a_transformer_tower(train_data):
    cfg = get_config("bert_mini_v5p16", {**TRAIN, "train.pack_pages": 4,
                                         "model.encoder": "cdssm"})
    corpus, toks = train_data
    with pytest.raises(ValueError, match="transformer"):
        Trainer(cfg, corpus=corpus, tokenizers=toks, device="cpu")


# -- bert_long_sp --------------------------------------------------------------

def test_bert_long_sp_config_and_weights_carry_over():
    """The port's bert_long_sp has the JAX config's widths; its ring
    attention is refused by name; with flash attention at one layer, JAX
    weights (pos_embed [1024, 512]) carry over through convert.py and a
    packed encode equals JAX's at float32."""
    jcfg, tcfg = jax_get_config("bert_long_sp"), get_config("bert_long_sp")
    for section in ("data", "model", "train"):
        want, got = getattr(jcfg, section), getattr(tcfg, section)
        for field in type(got).__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), field
    assert (tcfg.model.num_layers, tcfg.model.model_dim,
            tcfg.model.num_heads, tcfg.data.page_len,
            tcfg.train.batch_size) == (4, 512, 8, 1024, 2048)
    with pytest.raises(ValueError, match="ring"):
        build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    ov = {"model.attention": "flash", "model.num_layers": 1,
          "model.dtype": "float32", "model.dropout": 0.0}
    jcfg = jax_get_config("bert_long_sp", ov)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 32), jnp.int32),
        jnp.ones((1, 1024), jnp.int32)))
    tmodel = build_two_tower(get_config("bert_long_sp", ov),
                             vocab_size=VOCAB, device="cpu")
    state = params_from_flax(params)
    assert state["page_tower.pos_embed"].shape == (1024, 512)
    tmodel.load_state_dict(state, strict=True)
    rows, seg, pos = _packed_ids(np.random.default_rng(5), 1, 4, 1024)
    got, want = _encode_both(jmodel, params, tmodel, rows, seg, pos, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
