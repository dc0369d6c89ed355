"""The port's 3-step loss curves against the JAX Trainer, and a JAX state
carried on in the port (moved from tests/test_torch_train.py whole, so
that no test file runs long under a parallel run, pytest-xdist giving
each worker whole files).

Tolerances, each with its reason:
* the 3-step loss curve against the JAX Trainer (1 layer, batch 32,
  dropout 0, the same flax-initialised weights through convert.py):
  1e-5 at model.dtype float32, 5e-3 at bfloat16 (bf16 rounds at other
  places in the two frameworks);
* JAX 3 steps -> convert.py -> port 3 steps against JAX's 6: 1e-4 at
  float32 (the optimizer state crosses over too)."""

import jax
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu.train.loop import Trainer as JaxTrainer
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import (
    adamw_state_from_optax, params_from_flax)
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.train.loop import Trainer

SMALL = {"data.num_pages": 256, "data.vocab_size": 512, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1,
         "train.batch_size": 32, "train.log_every": 1000,
         "train.warmup_steps": 1, "train.learning_rate": 1e-3}
CORPUS = dict(num_pages=256, seed=0, page_len=6, query_len=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _jax_run(tmp_path, attention, dtype, steps):
    """The JAX trainer's loss curve over `steps` steps and its numpy state
    (params, opt_state) after 3 steps, and its initial params."""
    cfg = jax_get_config("bert_mini_v5p16", {
        **SMALL, "model.attention": attention, "model.dtype": dtype,
        "model.dropout": 0.0, "mesh.data": 1})
    tr = JaxTrainer(cfg, corpus=JaxCorpus(**CORPUS),
                    workdir=str(tmp_path / f"jax_{attention}_{dtype}"))
    state = tr.init_state()
    init = jax.tree_util.tree_map(np.asarray, state.params)
    step = tr.compiled_step(state)
    it = iter(tr.batches())
    rng = tr.base_rng()
    curve, at3 = [], None
    for i in range(steps):
        state, m = step(state, next(it), rng)
        curve.append(float(m["loss"]))
        if i == 2:
            at3 = jax.tree_util.tree_map(
                np.asarray, (state.params, state.opt_state))
    return init, curve, at3


def _port_trainer(attention, dtype, dropout_rate=0.0, corpus=None,
                  toks=None):
    cfg = get_config("bert_mini_v5p16", {
        **SMALL, "model.attention": attention, "model.dtype": dtype,
        "model.dropout": dropout_rate})
    return Trainer(cfg, corpus=corpus or ToyCorpus(**CORPUS),
                   tokenizers=toks, device="cpu")


def _port_curve(tr, steps):
    it = tr.batches()
    return [float(tr.train_step(next(it))["loss"]) for _ in range(steps)]


@pytest.fixture(scope="module")
def jax_dense_f32(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax"), "dense", "float32", 6)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-3)])
def test_three_step_loss_curve_matches_jax_trainer(
        tmp_path, jax_dense_f32, attention, dtype, tol):
    if (attention, dtype) == ("dense", "float32"):
        init, curve, _ = jax_dense_f32
        curve = curve[:3]
    else:
        init, curve, _ = _jax_run(tmp_path, attention, dtype, 3)
    tr = _port_trainer(attention, dtype)
    tr.model.load_state_dict(params_from_flax(init), strict=True)
    got = _port_curve(tr, 3)
    diff = float(np.abs(np.array(got) - np.array(curve)).max())
    print(f"loss curve {attention}/{dtype}: port {got} jax {curve} "
          f"max diff {diff:.3g}")
    assert diff < tol, (got, curve)
    assert len(set(np.round(curve, 3))) == 3     # the steps really moved


def test_jax_state_continues_in_the_port(jax_dense_f32):
    init, curve, (params3, opt3) = jax_dense_f32
    tr = _port_trainer("dense", "float32")
    tr.model.load_state_dict(params_from_flax(params3), strict=True)
    tr.optimizer.load_state_dict(adamw_state_from_optax(opt3))
    assert tr.optimizer.count == 3
    tr.step = 3
    got = _port_curve(tr, 3)
    diff = float(np.abs(np.array(got) - np.array(curve[3:])).max())
    print(f"jax 3 -> port 3: port {got} jax {curve[3:]} max diff {diff:.3g}")
    assert diff < 1e-4, (got, curve[3:])
