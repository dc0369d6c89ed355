"""The port's mining pipeline (train/pipeline.py run_pipeline and the
hardneg_v5p64 preset) on the CPU; tests/test_torch_mined_training.py
holds the steps with a mined table against the JAX Trainer.

Tolerances, each with its reason:
* the preset: every field equal to the JAX preset's;
* a pipeline resumed from a checkpoint taken mid-pipeline against the
  same pipeline run straight (dropout 0.1): bitwise;
* the mirror of the JAX package's tests/test_pipeline.py
  ``test_run_pipeline_end_to_end`` at its overrides (in
  tests/test_torch_pipeline_e2e.py, split off so that no file runs long
  under a parallel run, pytest-xdist giving each worker whole files):
  its own bars."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.loader import build_tokenizer
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.mine.ann import HardNegatives
from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
from dnn_page_vectors_tpu_torch.train.loop import Trainer
from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline

SMALL = {"data.num_pages": 256, "data.vocab_size": 512, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1,
         "train.batch_size": 32, "train.log_every": 1000,
         "train.warmup_steps": 1, "train.learning_rate": 1e-3,
         "train.hard_negatives": 7}
CORPUS = dict(num_pages=256, seed=0, page_len=6, query_len=4)


def test_hardneg_preset_equals_jax():
    mine, want = get_config("hardneg_v5p64"), jax_get_config("hardneg_v5p64")
    assert mine.name == want.name == "hardneg_v5p64"
    for section in ("data", "model", "train", "eval"):
        a, b = getattr(mine, section), getattr(want, section)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), \
                f"{section}.{f.name}"
    assert mine.train.hard_negatives == 7
    assert mine.train.batch_size == 16_384


# -- the pipeline ------------------------------------------------------------------

RESUME = {**SMALL, "model.dropout": 0.1, "eval.embed_batch_size": 64,
          "eval.store_shard_size": 128, "eval.eval_queries": 64}


@pytest.fixture(scope="module")
def small_world():
    cfg = get_config("bert_mini_v5p16", RESUME)
    corpus = ToyCorpus(**CORPUS)
    return cfg, corpus, build_tokenizer(cfg, corpus)


def _trainer(small_world, wd):
    cfg, corpus, toks = small_world
    return Trainer(cfg, corpus=corpus, tokenizers=toks, workdir=wd,
                   device="cpu")


def test_pipeline_resumes_from_a_checkpoint_taken_mid_pipeline(
        small_world, tmp_path):
    """A pipeline killed in round 1, after round 0 mined its table and a
    checkpoint was taken at the round's end, resumes on a fresh Trainer:
    it re-enters round 1 with the mined table from the workdir and ends
    with the weights, table and store of the same pipeline run straight,
    bit for bit (dropout on, so the straight run's embeds between its
    steps must not have left the model in eval mode)."""
    cfg = small_world[0]
    straight = _trainer(small_world, str(tmp_path / "straight"))
    want = run_pipeline(cfg, rounds=2, steps_per_round=3, trainer=straight)
    assert want["step"] == 6 and len(want["recalls"]) == 2
    assert [r["round"] for r in want["rounds"]] == [0, 1]
    assert "mine" in want["rounds"][0] and "mine" not in want["rounds"][1]

    wd = str(tmp_path / "killed")
    ckpt = CheckpointManager(os.path.join(wd, "ckpt"))
    killed = _trainer(small_world, wd)
    calls = []

    def train(steps=None, ckpt_manager=None):
        calls.append(steps)
        if len(calls) == 2:                 # round 1 starts: save and die
            killed.save(ckpt)
            raise RuntimeError("killed")
        return Trainer.train(killed, steps, ckpt_manager)

    killed.train = train
    with pytest.raises(RuntimeError, match="killed"):
        run_pipeline(cfg, rounds=2, steps_per_round=3, trainer=killed)
    assert os.path.exists(os.path.join(wd, "hard_negatives.npy"))

    resumed = _trainer(small_world, wd)
    assert resumed.restore(ckpt) == 3
    got = run_pipeline(cfg, rounds=2, steps_per_round=3, trainer=resumed)
    assert got["step"] == 6 and [r["round"] for r in got["rounds"]] == [1]
    assert isinstance(resumed.hard_negative_lookup, HardNegatives)
    np.testing.assert_array_equal(got["negatives"].table,
                                  want["negatives"].table)
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert got["recalls"] == want["recalls"][1:]
    a = VectorStore(os.path.join(straight.workdir, "store")).load_all()
    b = VectorStore(os.path.join(wd, "store")).load_all()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    # the round lines in metrics.jsonl
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        rounds = [json.loads(line) for line in f if "pipeline_round" in line]
    assert [(r["pipeline_round"], r["step"]) for r in rounds] == \
        [(0, 3), (1, 6)]
    assert rounds[-1]["recall@10"] == got["recalls"][-1]


def test_pipeline_refuses_what_it_cannot_run(small_world):
    cfg = small_world[0]
    with pytest.raises(ValueError, match="workdir"):
        run_pipeline(cfg, trainer=None)
    with pytest.raises(ValueError, match="hard_negatives > 0"):
        run_pipeline(get_config("bert_mini_v5p16"), trainer=None)
