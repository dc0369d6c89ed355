"""Training across ranks (parallel/mesh.py, parallel/sharding.py, the
global in-batch negatives of models/losses.py, the ring and the model
split of models/transformer.py, train/loop.py and train/checkpoint.py on
a mesh) against the JAX package's training on its 8 fake CPU devices and
against the port in one process.

The port runs in 2-4 spawned processes over gloo (tests/torch_dist.py:
one torch thread each, a time limit a job and a timeout a collective);
the JAX side in this process. Weights cross with convert.params_from_flax
and the batches are the byte-equal TrainBatcher ones. Bars, the JAX
package's own (tests/test_parallel.py):
* data parallelism at world 2 against JAX at mesh.data=2 and against the
  port in one process: parameters within rtol 2e-4 / atol 2e-5, the loss
  within 1e-3 (4 steps, float32; cdssm with AdamW, as JAX's test, bert
  with SGD);
* one step's all-reduced gradient against one card's: 1e-5 relative
  (float32 sums in another order), the loss and in_batch_acc the global
  batch's, and the ranks' losses summing to the global loss;
* tensor parallelism (with data parallelism) and ring sequence
  parallelism against one process: within rtol 5e-4 / atol 5e-5 (SGD, as
  JAX: AdamW's 1/sqrt(v) turns summation-order noise on near-zero
  gradients into full steps);
* a checkpoint saved at one world size and resumed at another: within
  2e-4 / 2e-5 of a straight run (tests/test_multihost.py:125);
* the TP rules, mesh fitting, the presets' meshes and batch slices:
  exact; two runs at world 2 with dropout: bitwise equal;
* `cli train` under torchrun at world 2 over gloo: both ranks' lines,
  rank 0's metrics and checkpoint."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig as JaxMeshConfig
from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.parallel.mesh import (
    fit_mesh_to_devices as jax_fit)
from dnn_page_vectors_tpu.parallel.sharding import (
    spec_for_param as jax_spec)
from dnn_page_vectors_tpu.train.loop import Trainer as JaxTrainer
from dnn_page_vectors_tpu_torch.config import MeshConfig, get_config
from dnn_page_vectors_tpu_torch.convert import (
    flax_from_state_dict, params_from_flax)
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.parallel.mesh import (
    axis_lines, coords, fit_mesh_to_devices, make_mesh, multihost_init)
from dnn_page_vectors_tpu_torch.parallel.sharding import (
    TP_RULES, shard_params, spec_for_param)
from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
from dnn_page_vectors_tpu_torch.train.loop import Trainer

from torch_dist import grad_rank, hosts_rank, run_ranks, train_rank

NAMES = {"cdssm": "cdssm_toy", "bert": "bert_mini_v5p16",
         "t5": "mt5_multilingual"}


def _tiny(encoder="cdssm", **extra):
    """The JAX tests' tiny config (tests/test_parallel.py _tiny_cfg)."""
    ov = {"data.num_pages": 256, "data.trigram_buckets": 2048,
          "data.vocab_size": 512, "model.embed_dim": 32,
          "model.conv_channels": 64, "model.out_dim": 32,
          "model.dtype": "float32", "train.batch_size": 64,
          "train.steps": 4, "train.warmup_steps": 2, "train.log_every": 4}
    if encoder in ("bert", "t5"):
        ov.update({"model.num_layers": 2, "model.model_dim": 32,
                   "model.num_heads": 4, "model.mlp_dim": 64,
                   "model.dropout": 0.0})
    ov.update(extra)
    return ov


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel")


def _vocab(work, encoder, ov):
    """A directory holding the config's cached vocab (the ranks load it)."""
    d = str(work / f"tok_{encoder}_{ov.get('data.page_len', 'x')}")
    os.makedirs(d, exist_ok=True)
    cfg = get_config(NAMES[encoder], ov)
    build_tokenizer(cfg, build_corpus(cfg), cache_dir=d)
    return d


def _init(work, encoder, ov, tag):
    """The full seeded state dict of the config, saved for the ranks."""
    cfg = get_config(NAMES[encoder], ov)
    vocab = (cfg.data.trigram_buckets + 1 if cfg.data.tokenizer == "trigram"
             else cfg.data.vocab_size)
    path = str(work / f"init_{tag}.pt")
    torch.save(build_two_tower(cfg, vocab, device="cpu").state_dict(), path)
    return path


def _one_process(work, encoder, ov, init_path, steps):
    cfg = get_config(NAMES[encoder], {**ov, "train.log_every": 1})
    tr = Trainer(cfg, tokenizers=build_tokenizer(
        cfg, build_corpus(cfg), cache_dir=_vocab(work, encoder, ov)),
        device="cpu")
    tr.model.load_state_dict(torch.load(init_path, weights_only=True))
    tr.train(steps)
    return tr


def _jax_run(work, encoder, ov, tag, steps=4):
    """The JAX package's Trainer at `ov` on its fake devices: the path of
    its initial parameters saved as a port state dict, its parameters
    after `steps` steps (port names) and its last metrics line."""
    jtr = JaxTrainer(jax_get_config(NAMES[encoder], ov),
                     workdir=str(work / f"jax_{tag}"))
    state = jtr.init_state()
    init_path = str(work / f"jax_init_{tag}.pt")
    torch.save(params_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)), init_path)
    state, jm = jtr.train(steps=steps, state=state)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    return init_path, want, jm


def _close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("encoder,optimizer", [("cdssm", "adamw"),
                                                ("bert", "sgd")])
def test_dp_training_equals_jax_and_one_process(work, eight_devices,
                                                encoder, optimizer):
    """cdssm with AdamW, as the JAX test; bert with SGD: the key bias's
    gradient is zero up to rounding (a constant added to a row's scores),
    and AdamW's 1/sqrt(v) turns that noise into full steps."""
    ov = _tiny(encoder, **{"mesh.data": 2, "train.optimizer": optimizer})
    init_path, want, jm = _jax_run(work, encoder, ov, f"dp_{encoder}")
    tok = _vocab(work, encoder, ov) if encoder == "bert" else None
    ranks = run_ranks(train_rank, 2, NAMES[encoder], ov, None, tok,
                      init_path, 4)
    for r in ranks:
        _close(r["params"], want, 2e-4, 2e-5)
        np.testing.assert_allclose(r["loss"][-1], jm["loss"], rtol=1e-3)
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (1, 0, 0)]
    one = _one_process(work, encoder, ov, init_path, 4)
    _close(ranks[0]["params"], one.model.state_dict(), 2e-4, 2e-5)
    np.testing.assert_allclose(ranks[0]["loss"],
                               [h["loss"] for h in one.history], rtol=1e-3)
    np.testing.assert_allclose(ranks[0]["acc"],
                               [h["in_batch_acc"] for h in one.history],
                               atol=1e-6)


@pytest.mark.parametrize("chunk,negatives", [(0, False), (8, True)],
                         ids=["dense", "chunked_negatives"])
def test_dp_gradient_equals_one_card(work, chunk, negatives):
    """The loss scale: each rank's loss is its rows' share of the global
    loss, so the gradients summed over the ranks are the one card's."""
    ov = _tiny("bert", **{"mesh.data": 2, "train.loss_chunk": chunk})
    tok = _vocab(work, "bert", ov)
    init_path = _init(work, "bert", ov, "grad")
    shift = [3, 17] if negatives else None
    ranks = run_ranks(grad_rank, 2, NAMES["bert"], ov, None, tok, init_path,
                      shift)
    one = grad_rank(0, 1, NAMES["bert"], {**ov, "mesh.data": 1}, None, tok,
                    init_path, shift)
    for r in ranks:
        _close(r["grads"], one["grads"], 1e-5, 1e-7)
        assert r["loss"] == pytest.approx(one["loss"], rel=1e-6)
        assert r["acc"] == pytest.approx(one["acc"], abs=1e-9)
    assert sum(r["local_loss"] for r in ranks) == pytest.approx(
        one["loss"], rel=1e-6)


@pytest.mark.parametrize("encoder,data,model", [("t5", 2, 2),
                                                ("bert", 1, 2)])
def test_tp_dp_training_equals_one_process(work, eight_devices, encoder,
                                           data, model):
    """Against the JAX package's Trainer at the same mesh on its fake
    devices (tests/test_parallel.py:63) and the port in one process, from
    the JAX package's initial parameters; every rank's parameters are
    gathered over its model group."""
    ov = _tiny(encoder, **{"mesh.data": data, "mesh.model": model,
                           "train.optimizer": "sgd"})
    tok = _vocab(work, encoder, ov)
    init_path, jax_want, jm = _jax_run(work, encoder, ov, f"tp_{encoder}")
    ranks = run_ranks(train_rank, data * model, NAMES[encoder], ov, None,
                      tok, init_path, 4)
    one = _one_process(work, encoder, ov, init_path, 4)
    want = one.model.state_dict()
    for r in ranks:
        _close(r["params"], jax_want, 5e-4, 5e-5)
        np.testing.assert_allclose(r["loss"][-1], jm["loss"], rtol=1e-3)
        _close(r["params"], want, 5e-4, 5e-5)
        np.testing.assert_allclose(r["loss"], [h["loss"] for h in
                                               one.history], rtol=1e-3)
        np.testing.assert_allclose(r["grad_norm"],
                                   [h["grad_norm"] for h in one.history],
                                   rtol=1e-4)


@pytest.mark.parametrize("encoder", ["bert", "t5"])
def test_ring_sp_training_equals_dense(work, eight_devices, encoder):
    """data 2 x seq 2: each rank holds half of every row's tokens through
    the whole tower; the t5 case rebuilds its bias blocks on the ring.
    Against the JAX package's ring Trainer at the same mesh on its fake
    devices (tests/test_parallel.py:124) and the port's dense attention
    in one process, from the JAX package's initial parameters."""
    ov = _tiny(encoder, **{"mesh.data": 2, "mesh.model": 1, "mesh.seq": 2,
                           "model.attention": "ring",
                           "train.optimizer": "sgd"})
    dense = {**ov, "model.attention": "dense"}
    tok = _vocab(work, encoder, ov)
    init_path, jax_want, jm = _jax_run(work, encoder, ov, f"ring_{encoder}")
    ranks = run_ranks(train_rank, 4, NAMES[encoder], ov, None, tok,
                      init_path, 4)
    one = _one_process(work, encoder, dense, init_path, 4)
    want = one.model.state_dict()
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 0, 1),
                                            (1, 0, 0), (1, 0, 1)]
    for r in ranks:
        _close(r["params"], jax_want, 5e-4, 5e-5)
        np.testing.assert_allclose(r["loss"][-1], jm["loss"], rtol=1e-3)
        _close(r["params"], want, 5e-4, 5e-5)
        np.testing.assert_allclose(r["loss"], [h["loss"] for h in
                                               one.history], rtol=1e-3)


@pytest.mark.parametrize("direction", ["up", "down"])
def test_checkpoint_loads_at_another_world_size(work, tmp_path, direction):
    """2 steps saved at world 1 then 2 more at world 2 (up), or 2 at
    world 2 then 2 at world 1 (down), against 4 straight steps; the
    world-2 job splits the model too (t5, mesh.model=2), so the file holds
    the full tensors and each rank its shards (AdamW moments too)."""
    ov = _tiny("t5")
    two = {**ov, "mesh.model": 2}
    tok = _vocab(work, "t5", ov)
    init_path = _init(work, "t5", ov, "ckpt")
    straight = _one_process(work, "t5", ov, init_path, 4)
    ckpt = str(tmp_path / "ckpt")
    if direction == "up":
        first = _one_process(work, "t5", ov, init_path, 2)
        first.save(CheckpointManager(ckpt))
        got = run_ranks(train_rank, 2, NAMES["t5"], two, None, tok, None, 2,
                        ckpt, True)[0]
        assert got["step"] == 4
        got = got["params"]
    else:
        run_ranks(train_rank, 2, NAMES["t5"], two, None, tok, init_path, 2,
                  ckpt)
        cfg = get_config(NAMES["t5"], ov)
        tr = Trainer(cfg, tokenizers=build_tokenizer(
            cfg, build_corpus(cfg), cache_dir=tok), device="cpu")
        assert tr.restore(CheckpointManager(ckpt)) == 2
        tr.train(2)
        got = tr.model.state_dict()
    _close(got, straight.model.state_dict(), 2e-4, 2e-5)


@pytest.mark.parametrize("encoder", ["bert", "t5"])
def test_tp_rules_match_jax(encoder):
    """Through convert.py's name map, the port splits the same parameters
    on the same dimension as the JAX package's TP_RULES."""
    cfg = get_config(NAMES[encoder], _tiny(encoder))
    sd = build_two_tower(cfg, cfg.data.vocab_size, device="cpu").state_dict()
    split = 0
    for name, t in sd.items():
        flax = flax_from_state_dict({name: t})["params"]
        path, leaf = [], flax
        while isinstance(leaf, dict):
            (key, leaf), = leaf.items()
            path.append(key)
        spec = tuple(jax_spec("params/" + "/".join(path)))
        want = spec.index("model") if "model" in spec else None
        if want is not None and path[-1] == "kernel":
            want = t.dim() - 1 - want          # [in, out] -> [out, in]
        assert spec_for_param(name) == want, (name, path, spec)
        split += want is not None
    # a block: q, k, v (weights, bert's biases), wo, the MLP's input
    # matmuls (bert's bias) and wo_mlp; and tok_embed
    per_tower = {"bert": 2 * 10 + 1, "t5": 2 * 7 + 1}[encoder]
    assert split == 2 * per_tower
    assert len(TP_RULES) == 7


def test_fit_mesh_to_devices_matches_jax():
    cases = [(64, 1, 1), (4, 2, 1), (1, 16, 1), (16, 1, 4), (2, 2, 2),
             (3, 1, 1), (1, 3, 5), (8, 1, 1)]
    for d, m, s in cases:
        for n in range(1, 17):
            want = jax_fit(JaxMeshConfig(d, m, s), devices=list(range(n)))
            got = fit_mesh_to_devices(MeshConfig(d, m, s), n)
            assert (got.data, got.model, got.seq) == \
                (want.data, want.model, want.seq), (d, m, s, n)


def test_mesh_layout_is_jax_device_order():
    """Rank r sits where JAX's reshape(data, model, seq) puts device r;
    every axis line and the data x seq plane hold the ranks JAX's mesh
    puts on them."""
    cfg = MeshConfig(data=2, model=2, seq=3)
    grid = np.arange(cfg.num_devices).reshape(2, 2, 3)
    for r in range(cfg.num_devices):
        assert grid[coords(r, 2, 3)] == r
    lines = axis_lines(cfg)
    assert sorted(map(tuple, lines["data"])) == sorted(
        tuple(grid[:, m, s]) for m in range(2) for s in range(3))
    assert sorted(map(tuple, lines["model"])) == sorted(
        tuple(grid[d, :, s]) for d in range(2) for s in range(3))
    assert sorted(map(tuple, lines["seq"])) == sorted(
        tuple(grid[d, m, :]) for d in range(2) for m in range(2))
    assert sorted(map(tuple, lines["dp"])) == sorted(
        tuple(grid[:, m, :].reshape(-1)) for m in range(2))


@pytest.mark.parametrize("pack,negatives", [(1, False), (4, True)])
def test_rank_batch_slices_are_the_single_batch(work, pack, negatives):
    cfg = get_config("bert_mini_v5p16", _tiny("bert"))
    corpus = build_corpus(cfg)
    q, p = build_tokenizer(cfg, corpus, cache_dir=_vocab(work, "bert",
                                                         _tiny("bert")))
    lookup = ((lambda ids: (ids[:, None] + np.array([1, 5])) % 256)
              if negatives else None)
    kw = dict(batch_size=64, seed=3, start_step=5, pack=pack,
              hard_negative_lookup=lookup)
    whole = next(iter(TrainBatcher(corpus, q, p, **kw)))
    for world in (2, 4):
        parts = [next(iter(TrainBatcher(corpus, q, p, process_index=r,
                                        process_count=world, **kw)))
                 for r in range(world)]
        for key, want in whole.items():
            got = np.concatenate([part[key] for part in parts])
            assert got.dtype == want.dtype and got.tobytes() == \
                want.tobytes(), (key, world)
            # rank r holds the r-th of `world` contiguous slices
            n = len(want) // world
            for r, part in enumerate(parts):
                assert np.array_equal(part[key], want[r * n:(r + 1) * n]), \
                    (key, world, r)
    with pytest.raises(ValueError, match="divide over 3 data ranks"):
        TrainBatcher(corpus, q, p, batch_size=64, process_count=3)


def test_process_info_barrier_and_host_gather():
    from dnn_page_vectors_tpu_torch.parallel import multihost
    assert multihost.process_info() == (0, 1)
    multihost.barrier("alone")                       # no group: no-op
    assert multihost.allgather_hosts(np.ones(2)).shape == (1, 2)
    ranks = run_ranks(hosts_rank, 2)
    for r, got in enumerate(ranks):
        assert got["info"] == (r, 2)
        assert np.array_equal(got["gathered"],
                              [[0, 1, 2], [10, 11, 12]])


def test_one_process_mesh_and_failed_group():
    assert multihost_init() is False                # no WORLD_SIZE: no-op
    with pytest.raises(RuntimeError, match="mesh.strict"):
        make_mesh(MeshConfig(data=2, strict=True))
    mesh = make_mesh(MeshConfig(data=16, seq=4))     # shrinks to one rank
    assert (mesh.data, mesh.model, mesh.seq, mesh.groups) == (1, 1, 1, {})
    # a group whose other rank never comes raises, it does not train alone
    from torch_dist import free_port
    with pytest.raises(RuntimeError, match="did not form"):
        multihost_init(f"tcp://127.0.0.1:{free_port()}", world_size=2,
                       rank=0, backend="gloo", timeout_s=2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", sorted(NAMES.values()) + [
    "kim_cnn_v5e8", "lstm_words", "hardneg_v5p64", "bert_long_sp"])
def test_preset_meshes_are_jax_meshes(name):
    """Each preset carries the JAX preset's mesh, and an override such as
    mesh.data=2 works as JAX's does."""
    want = jax_get_config(name).mesh
    got = get_config(name).mesh
    assert (got.data, got.model, got.seq, got.strict) == \
        (want.data, want.model, want.seq, want.strict)
    assert got.num_devices == want.data * want.model * want.seq
    two = get_config(name, {"mesh.data": 2, "mesh.strict": "true"}).mesh
    assert (two.data, two.strict) == (2, True)


def test_a_launched_rank_without_its_group_refuses(monkeypatch):
    """torchrun's WORLD_SIZE with no process group formed: the mesh
    raises instead of training alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="multihost_init"):
        make_mesh(MeshConfig(data=2))


def test_trainer_registry_and_line(tokenizers_bert):
    """The train.steps counter and the per-chip gauge, as the JAX
    trainer's (no mfu gauge on the CPU: its peak is unknown)."""
    from dnn_page_vectors_tpu_torch.utils import telemetry
    cfg, toks = tokenizers_bert
    reg = telemetry.default_registry()
    before = reg.counter("train.steps").value
    tr = Trainer(cfg, tokenizers=toks, device="cpu")
    line = tr.train(2)
    assert reg.counter("train.steps").value - before == 2
    assert reg.gauge("train.pages_per_sec_per_chip").value == \
        pytest.approx(line["pages_per_sec_per_chip"])
    assert "mfu" not in line and "fault_counters" not in line


@pytest.fixture
def tokenizers_bert(work):
    ov = _tiny("bert", **{"train.log_every": 1})
    cfg = get_config(NAMES["bert"], ov)
    return cfg, build_tokenizer(cfg, build_corpus(cfg),
                                cache_dir=_vocab(work, "bert", ov))


def test_model_split_must_divide_and_shards_cover_the_model():
    cfg = get_config(NAMES["t5"], _tiny("t5"))
    mesh = make_mesh(MeshConfig())
    full = build_two_tower(cfg, 512, device="cpu").state_dict()
    mesh.model = 2
    halves = []
    for idx in range(2):
        mesh.rank = idx                             # (0, idx, 0)
        halves.append(shard_params(full, mesh))
    for name, t in full.items():
        dim = spec_for_param(name)
        got = (halves[0][name] if dim is None
               else torch.cat([h[name] for h in halves], dim))
        assert torch.equal(got, t), name
    from dnn_page_vectors_tpu_torch.models.transformer import Attention
    with pytest.raises(ValueError, match="num_heads 4 does not divide"):
        Attention(4, 32, mesh=dataclasses.replace(mesh, model=3))


def test_bert_long_sp_builds_and_trains_at_seq_1(work):
    """The preset keeps attention="ring"; on one rank the ring is one hop
    and runs the flash path (its plain version on the CPU), equal to
    flash attention; packed rows refuse the ring."""
    ov = {"data.num_pages": 128, "data.vocab_size": 512,
          "data.page_len": 64, "data.query_len": 16,
          "model.num_layers": 1, "model.model_dim": 32,
          "model.num_heads": 4, "model.mlp_dim": 64, "model.dropout": 0.0,
          "model.dtype": "float32", "train.batch_size": 16,
          "train.log_every": 1, "train.warmup_steps": 1}
    assert get_config("bert_long_sp").model.attention == "ring"
    cfg = get_config("bert_long_sp", ov)
    toks = build_tokenizer(cfg, build_corpus(cfg))
    ring = Trainer(cfg, tokenizers=toks, device="cpu")
    assert (ring.mesh.data, ring.mesh.seq) == (1, 1)
    flash = Trainer(get_config("bert_long_sp",
                               {**ov, "model.attention": "flash"}),
                    tokenizers=toks, device="cpu")
    ring.train(2)
    flash.train(2)
    assert [h["loss"] for h in ring.history] == \
        [h["loss"] for h in flash.history]
    with pytest.raises(ValueError, match="ring splits the sequence"):
        Trainer(get_config("bert_long_sp", {**ov, "train.pack_pages": 4,
                                            "mesh.seq": 2}),
                tokenizers=toks, device="cpu",
                mesh=dataclasses.replace(make_mesh(MeshConfig()), seq=2))


def test_two_runs_at_one_world_size_are_bitwise_equal(work):
    """Dropout on: a rank's masks come from (seed, step, rank), so two runs
    at world 2 give the same parameters bit for bit."""
    ov = _tiny("bert", **{"mesh.data": 2, "model.dropout": 0.1})
    tok = _vocab(work, "bert", ov)
    init_path = _init(work, "bert", ov, "bitwise")
    runs = [run_ranks(train_rank, 2, NAMES["bert"], ov, None, tok,
                      init_path, 2) for _ in range(2)]
    for a, b in zip(*runs):
        assert a["loss"] == b["loss"]
        for k in a["params"]:
            assert np.array_equal(a["params"][k], b["params"][k]), k


def test_cli_train_under_torchrun(work, tmp_path):
    """`torchrun --nproc-per-node 2 -m ...cli train --device cpu`: the
    group forms over gloo, each rank prints its line, rank 0 alone writes
    the metrics and the checkpoint."""
    import json
    import subprocess
    import sys
    ov = _tiny("bert", **{"mesh.data": 2, "train.log_every": 1})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wd = str(tmp_path / "w")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=2", "-m", "dnn_page_vectors_tpu_torch.cli",
           "train", "--config", NAMES["bert"], "--workdir", wd, "--device",
           "cpu", "--steps", "2"]
    for k, v in ov.items():
        cmd += ["--set", f"{k}={v}"]
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    decoder = json.JSONDecoder()
    lines, at = [], proc.stdout.find('{"final"')
    while at >= 0:
        rec, end = decoder.raw_decode(proc.stdout, at)
        lines.append(rec)
        at = proc.stdout.find('{"final"', end)
    assert sorted(r["rank"] for r in lines) == [0, 1]
    assert {r["world"] for r in lines} == {2}
    assert all(r["mesh"] == [2, 1, 1] for r in lines)
    assert lines[0]["final"]["loss"] == lines[1]["final"]["loss"]
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        steps = [json.loads(x)["step"] for x in f]
    assert steps == [1, 2]
    assert os.listdir(os.path.join(wd, "ckpt"))


def test_cli_refuses_other_commands_in_a_group(monkeypatch, tmp_path):
    from dnn_page_vectors_tpu_torch import cli
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="item 6"):
        cli.main(["embed", "--config", "cdssm_toy", "--workdir",
                  str(tmp_path), "--device", "cpu"])
