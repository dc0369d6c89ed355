"""The port's training slice (train/optimizer.py, data/loader.py
TrainBatcher, train/checkpoint.py, train/loop.py, the dropout of
models/transformer.py and convert.adamw_state_from_optax) against the JAX
package on the CPU. The loss curves against the JAX Trainer are in
tests/test_torch_train_curves.py, the resume in
tests/test_torch_train_resume.py and the log cadence and the dropout
masks after an embed in tests/test_torch_train_cadence.py (split off so
that no file runs long under a parallel run, pytest-xdist giving each
worker whole files).

Tolerances, each with its reason:
* the LR schedule and one clipped AdamW/SGD update against optax on the
  same gradients: 1e-6 relative (float32 rounding of the same formulas);
* batches: byte-identical;
* the dropout keep rate over 10^6 draws: within 1% of 1 - rate."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import TrainBatcher as JaxBatcher
from dnn_page_vectors_tpu.data.loader import build_tokenizer as jax_tokenizer
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu_torch.config import TrainConfig, get_config
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, build_tokenizer)
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.models.transformer import dropout
from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
from dnn_page_vectors_tpu_torch.train.loop import Trainer, dropout_generator
from dnn_page_vectors_tpu_torch.train.optimizer import (
    make_optimizer, warmup_cosine)

SMALL = {"data.num_pages": 256, "data.vocab_size": 512, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1,
         "train.batch_size": 32, "train.log_every": 1000,
         "train.warmup_steps": 1, "train.learning_rate": 1e-3}
CORPUS = dict(num_pages=256, seed=0, page_len=6, query_len=4)


# -- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("steps,warmup", [(50, 7), (20, 0), (5, 10)])
def test_lr_schedule_matches_optax_step_by_step(steps, warmup):
    cfg = TrainConfig(steps=steps, warmup_steps=warmup, learning_rate=5e-4)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=max(warmup, 1), decay_steps=max(steps, warmup + 1),
        end_value=cfg.learning_rate * 0.1)
    mine = warmup_cosine(cfg)
    assert mine(0) == 0.0
    end = max(steps, warmup + 1)      # where the cosine reaches 0.1 x lr
    for t in range(end + 5):
        np.testing.assert_allclose(mine(t), float(want(t)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {t}")
    np.testing.assert_allclose(mine(max(warmup, 1)), cfg.learning_rate,
                               rtol=1e-6)
    np.testing.assert_allclose(mine(end), 0.1 * cfg.learning_rate,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_clip_and_updates_match_optax(kind):
    cfg = TrainConfig(optimizer=kind, learning_rate=1e-2, warmup_steps=2,
                      steps=10, weight_decay=0.05)
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 2)}
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, max(cfg.warmup_steps, 1),
        max(cfg.steps, cfg.warmup_steps + 1), cfg.learning_rate * 0.1)
    tail = (optax.sgd(sched) if kind == "sgd"
            else optax.adamw(sched, weight_decay=cfg.weight_decay))
    tx = optax.chain(optax.clip_by_global_norm(1.0), tail)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in params.items()}
    opt = make_optimizer(cfg, tp.items())
    # below the clip bound, above it, far above it, then below again
    for gscale in (0.05, 3.0, 40.0, 0.1):
        grads = {n: (gscale * rng.normal(size=s) / 3).astype(np.float32)
                 for n, s in shapes.items()}
        upd, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in tp.items():
            p.grad = torch.from_numpy(grads[n])
        norm = opt.step()
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for n in shapes:
            np.testing.assert_allclose(tp[n].detach().numpy(),
                                       np.asarray(jp[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{kind} {n}")
    assert opt.count == 4


def test_optimizer_state_refuses_other_shapes():
    p = torch.nn.Parameter(torch.zeros(3, 2))
    opt = make_optimizer(TrainConfig(), [("w", p)])
    state = opt.state_dict()
    bad = {"count": 1, "mu": {"w": torch.zeros(2, 3)},
           "nu": {"w": torch.zeros(3, 2)}}
    with pytest.raises(ValueError, match="shape"):
        opt.load_state_dict(bad)
    with pytest.raises(ValueError, match="differ"):
        opt.load_state_dict({**state, "mu": {"x": torch.zeros(3, 2)}})


# -- data -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tokenizers():
    jcfg = jax_get_config("bert_mini_v5p16", SMALL)
    tcfg = get_config("bert_mini_v5p16", SMALL)
    jc, tc = JaxCorpus(**CORPUS), ToyCorpus(**CORPUS)
    return (jc, jax_tokenizer(jcfg, jc)), (tc, build_tokenizer(tcfg, tc))


@pytest.mark.parametrize("start_step", [0, 6], ids=["start", "resume"])
@pytest.mark.parametrize("negatives", [False, True])
def test_train_batches_byte_identical_to_jax(tokenizers, start_step,
                                             negatives):
    (jc, (jq, jp)), (tc, (tq, tp)) = tokenizers
    lookup = ((lambda ids: (ids[:, None] + np.array([1, 5])) % 256)
              if negatives else None)
    jb = JaxBatcher(jc, jq, jp, batch_size=32, seed=3, start_step=start_step,
                    hard_negative_lookup=lookup, process_index=0,
                    process_count=1)
    tb = TrainBatcher(tc, tq, tp, batch_size=32, seed=3,
                      start_step=start_step, hard_negative_lookup=lookup)
    # 8 steps per epoch: from step 6 this crosses into the next epoch
    for want, got in zip(list(zip(range(4), jb)), list(zip(range(4), tb))):
        want, got = want[1], got[1]
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -- dropout ------------------------------------------------------------------

def test_dropout_keep_rate_and_determinism():
    x = torch.ones(1000, 1000)
    gen = dropout_generator(0, 7, torch.device("cpu"))
    y = dropout(x, 0.1, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01 * 0.9
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    # the same (seed, step) draws the same mask; another step another
    again = dropout(x, 0.1, dropout_generator(0, 7, torch.device("cpu")))
    assert torch.equal(y, again)
    other = dropout(x, 0.1, dropout_generator(0, 8, torch.device("cpu")))
    assert not torch.equal(y, other)
    other = dropout(x, 0.1, dropout_generator(1, 7, torch.device("cpu")))
    assert not torch.equal(y, other)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, None)
    assert dropout(x, 0.0, None) is x


def test_eval_mode_draws_no_masks(tokenizers):
    _, (tc, toks) = tokenizers
    cfg = get_config("bert_mini_v5p16", SMALL)
    tr = Trainer(cfg, corpus=tc, tokenizers=toks, device="cpu")
    ids = torch.from_numpy(toks[1].encode_batch(
        [tc.page_text(i) for i in range(4)]))
    tr.model.eval()
    with torch.no_grad():
        a = tr.model.encode_page(ids)                  # no generator needed
        b = tr.model.encode_page(ids)
    assert torch.equal(a, b)
    tr.model.train()
    with torch.no_grad():
        c = tr.model.encode_page(ids, dropout_generator(0, 0, tr.device))
    assert not torch.equal(a, c)


# -- trainer ------------------------------------------------------------------

def _port_trainer(attention, dtype, dropout_rate=0.0, corpus=None,
                  toks=None):
    cfg = get_config("bert_mini_v5p16", {
        **SMALL, "model.attention": attention, "model.dtype": dtype,
        "model.dropout": dropout_rate})
    return Trainer(cfg, corpus=corpus or ToyCorpus(**CORPUS),
                   tokenizers=toks, device="cpu")


def test_checkpoint_restore_refuses_other_shapes_and_rolls_back(
        tokenizers, tmp_path):
    _, (tc, toks) = tokenizers
    tr = _port_trainer("dense", "float32", 0.0, tc, toks)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    tr.save(ckpt)
    tr.train(1)
    tr.save(ckpt)
    wide = get_config("bert_mini_v5p16", {**SMALL, "model.mlp_dim": 64})
    other = Trainer(wide, corpus=tc, tokenizers=toks, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore(other.state(), step=1)
    with pytest.raises(FileNotFoundError, match="available steps"):
        ckpt.restore(tr.state(), step=5)
    # a torn newest file: restore without a step rolls back to step 0
    with open(ckpt._path(1), "r+b") as f:
        f.truncate(100)
    fresh = _port_trainer("dense", "float32", 0.0, tc, toks)
    with pytest.warns(UserWarning, match="rollback"):
        assert fresh.restore(ckpt) == 0


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    cfg = get_config("bert_mini_v5p16", SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, corpus=ToyCorpus(**CORPUS))


# -- hard negatives -------------------------------------------------------------

def test_hard_negatives_without_a_lookup_train_in_batch(tokenizers):
    """train.hard_negatives=7 and no mined table yet (round 0 of the
    mining pipeline): the batches carry no negatives and the steps equal
    those of a trainer without negatives, bit for bit."""
    _, (tc, toks) = tokenizers
    losses = []
    for h in (7, 0):
        cfg = get_config("bert_mini_v5p16", {**SMALL,
                                             "train.hard_negatives": h})
        tr = Trainer(cfg, corpus=tc, tokenizers=toks, device="cpu")
        assert tr.hard_negative_lookup is None
        assert "neg_page" not in next(tr.batches())
        tr.train(2)
        losses.append([line["loss"] for line in tr.history])
    assert losses[0] == losses[1]


def test_a_lookup_batches_negatives(tokenizers):
    _, (tc, toks) = tokenizers
    cfg = get_config("bert_mini_v5p16", {**SMALL, "train.hard_negatives": 7})
    lookup = lambda ids: (ids[:, None] + np.arange(1, 8)) % tc.num_pages
    tr = Trainer(cfg, corpus=tc, hard_negative_lookup=lookup,
                 tokenizers=toks, device="cpu")
    batch = next(tr.batches())
    assert tuple(batch["neg_page"].shape) == (32, 7, 32)
    gold = batch["page_id"].numpy()
    want = toks[1].encode_batch(
        [tc.page_text(int(i)) for i in lookup(gold).reshape(-1)])
    np.testing.assert_array_equal(batch["neg_page"].numpy().reshape(
        want.shape), want)
    m = tr.train_step(batch)
    assert np.isfinite(float(m["loss"])) and tr.step == 1
    # the negatives enter the loss: the same step without them differs
    plain = Trainer(cfg, corpus=tc, tokenizers=toks, device="cpu")
    m0 = plain.train_step({k: v for k, v in batch.items()
                           if k != "neg_page"})
    assert float(m0["loss"]) != float(m["loss"])
