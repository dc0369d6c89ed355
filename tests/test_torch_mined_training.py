"""Training with a mined hard-negative table (Trainer's
hard_negative_lookup, TrainBatcher's "neg_page", the page tower's second
encode and the loss with negatives) against the JAX Trainer on the CPU:
1 layer, batch 32, 7 negatives a pair from a fixed table, dropout 0, the
same flax-initialised weights through convert.py. The 3-step loss curves
agree within tests/test_torch_train.py's bars: 1e-5 at float32, 5e-3 at
bfloat16 (bf16 rounds at other places in the two frameworks)."""
import jax
import numpy as np
import pytest

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu.mine.ann import HardNegatives as JaxNegatives
from dnn_page_vectors_tpu.train.loop import Trainer as JaxTrainer
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import params_from_flax
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.mine.ann import HardNegatives
from dnn_page_vectors_tpu_torch.train.loop import Trainer

SMALL = {"data.num_pages": 256, "data.vocab_size": 512, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1,
         "train.batch_size": 32, "train.log_every": 1000,
         "train.warmup_steps": 1, "train.learning_rate": 1e-3,
         "train.hard_negatives": 7}
CORPUS = dict(num_pages=256, seed=0, page_len=6, query_len=4)


def _table() -> np.ndarray:
    """A fixed [256, 7] table that never holds the gold page."""
    rng = np.random.default_rng(5)
    off = np.stack([rng.choice(np.arange(1, 256), 7, replace=False)
                    for _ in range(256)])
    return ((np.arange(256)[:, None] + off) % 256).astype(np.int32)


@pytest.mark.parametrize("attention,dtype,tol", [
    ("dense", "float32", 1e-5), ("flash", "bfloat16", 5e-3)])
def test_loss_curve_with_mined_negatives_matches_jax_trainer(
        tmp_path, attention, dtype, tol):
    ov = {**SMALL, "model.attention": attention, "model.dtype": dtype,
          "model.dropout": 0.0}
    jtr = JaxTrainer(jax_get_config("bert_mini_v5p16", {**ov,
                                                         "mesh.data": 1}),
                     corpus=JaxCorpus(**CORPUS),
                     hard_negative_lookup=JaxNegatives(_table()),
                     workdir=str(tmp_path / "jax"))
    state = jtr.init_state()
    init = jax.tree_util.tree_map(np.asarray, state.params)
    step = jtr.compiled_step(state)
    it, rng = iter(jtr.batches()), jtr.base_rng()
    want = []
    for _ in range(3):
        state, m = step(state, next(it), rng)
        want.append(float(m["loss"]))

    tr = Trainer(get_config("bert_mini_v5p16", ov),
                 corpus=ToyCorpus(**CORPUS),
                 hard_negative_lookup=HardNegatives(_table()), device="cpu")
    tr.model.load_state_dict(params_from_flax(init), strict=True)
    batches = tr.batches()
    got = []
    for _ in range(3):
        batch = next(batches)
        assert tuple(batch["neg_page"].shape) == (32, 7, 32)
        got.append(float(tr.train_step(batch)["loss"]))
    diff = float(np.abs(np.array(got) - np.array(want)).max())
    print(f"{attention}/{dtype} with negatives: port {got} jax {want} "
          f"max diff {diff:.3g}")
    assert diff < tol, (got, want)
    assert len(set(np.round(want, 3))) == 3      # the steps really moved
