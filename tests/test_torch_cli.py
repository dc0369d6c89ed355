"""The port's CLI (``dnn_page_vectors_tpu_torch.cli``), called in process
with ``--device cpu`` at the verify skill's cdssm_toy overrides over a
600-page synthetic jsonl corpus: ``train``, ``embed``, ``eval``, ``mine``
and ``pipeline`` (4 tokenizer workers) give the same metrics, store
bytes, recall and mined table as the same calls through the API with one
worker; a second ``embed`` is a manifest no-op; every JAX command that is
not ported exits non-zero naming its ROADMAP item."""
import json
import os

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch import cli
from dnn_page_vectors_tpu_torch.config import CONFIGS, get_config
from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl
from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import prepare_store
from dnn_page_vectors_tpu_torch.mine.ann import mine_hard_negatives
from dnn_page_vectors_tpu_torch.train.loop import Trainer
from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _overrides(path):
    return {"data.corpus": f"jsonl:{path}", "data.num_pages": 600,
            "data.trigram_buckets": 4096, "model.embed_dim": 64,
            "model.conv_channels": 128, "model.out_dim": 64,
            "train.batch_size": 64, "eval.embed_batch_size": 128,
            "eval.store_shard_size": 256, "train.steps": 20,
            "train.warmup_steps": 10, "train.learning_rate": 2e-3,
            "train.log_every": 20}


def _argv(command, workdir, ov, *extra):
    out = [command, "--config", "cdssm_toy", "--workdir", str(workdir),
           "--device", "cpu"]
    for k, v in ov.items():
        out += ["--set", f"{k}={v}"]
    return out + list(extra)


def _run(capsys, argv):
    cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _npy_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npy")}


@pytest.fixture(scope="module")
def corpus_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "c.jsonl")
    return write_synth_jsonl(path, 600, seed=3, page_len=24, query_len=6)


def test_offline_commands_equal_the_api(corpus_path, tmp_path, capsys):
    ov = _overrides(corpus_path)
    wd = tmp_path / "cli"
    final = _run(capsys, _argv("train", wd, ov))["final"]
    assert final["step"] == 20
    emb = _run(capsys, _argv("embed", wd, ov))
    assert emb["embedded"] == 600 and emb["model_step"] == 20
    assert emb["tokenize_workers"] == 4
    assert emb["stages"]["stage_tokenize_n"] == 5
    ev = _run(capsys, _argv("eval", wd, ov))
    assert ev["num_queries"] == 600 and ev["index"] == "exact"
    mined = _run(capsys, _argv("mine", wd, ov))
    assert mined["mined"] == [600, 7]

    # the same calls through the API, with one tokenizer worker (the CLI
    # ran data.tokenize_workers = 4)
    cfg = get_config("cdssm_toy", {**ov, "data.tokenize_workers": 1})
    api = tmp_path / "api"
    tr = Trainer(cfg, workdir=str(api), device="cpu")
    line = tr.train()
    for k in ("loss", "in_batch_acc", "scale", "grad_norm", "step"):
        assert final[k] == line[k], k
    e = BulkEmbedder(cfg, tr.model, tr.page_tok, query_tok=tr.query_tok,
                     device="cpu")
    store = prepare_store(str(api / "store"), 64, 256, "float16", tr.step)
    e.embed_corpus(tr.corpus, store)
    got, want = _npy_bytes(wd / "store"), _npy_bytes(api / "store")
    assert len(got) == 6 and got == want     # 3 shards: ids + vectors
    recall, nq = evaluate_recall(e, tr.corpus, store, k=10)
    assert ev["recall@10"] == recall and nq == 600
    assert recall > 0.2                      # random: about 0.017
    negs = mine_hard_negatives(e, tr.corpus, store, num_negatives=7,
                               out_path=str(api / "negs.npy"))
    np.testing.assert_array_equal(np.load(wd / "hard_negatives.npy"),
                                  negs.table)
    # a second embed is a manifest no-op: nothing is rewritten
    mtimes = {n: os.stat(wd / "store" / n).st_mtime_ns for n in got}
    again = _run(capsys, _argv("embed", wd, ov))
    assert again["embedded"] == 600 and "stage_tokenize_n" not in \
        again["stages"]
    assert mtimes == {n: os.stat(wd / "store" / n).st_mtime_ns for n in got}


def test_pipeline_command_equals_run_pipeline(corpus_path, tmp_path, capsys):
    ov = dict(_overrides(corpus_path), **{"train.hard_negatives": 3,
                                         "train.steps": 20})
    out = _run(capsys, _argv("pipeline", tmp_path / "cli", ov,
                             "--rounds", "2", "--steps", "10"))
    cfg = get_config("cdssm_toy", {**ov, "data.tokenize_workers": 1})
    tr = Trainer(cfg, workdir=str(tmp_path / "api"), device="cpu")
    want = run_pipeline(cfg, rounds=2, steps_per_round=10, trainer=tr)
    assert out == {"rounds": 2, "recalls": want["recalls"]}
    np.testing.assert_array_equal(
        np.load(tmp_path / "cli" / "hard_negatives.npy"),
        np.load(tmp_path / "api" / "hard_negatives.npy"))
    assert _npy_bytes(tmp_path / "cli" / "store") == \
        _npy_bytes(tmp_path / "api" / "store")


@pytest.mark.parametrize("command", sorted(cli.NOT_PORTED))
def test_unported_commands_exit_naming_their_item(command, tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main([command, "--workdir", str(tmp_path), "--device", "cpu"])
    item = cli.NOT_PORTED[command][0]
    assert str(ei.value).endswith(f"(ROADMAP.md queue 1, item {item})")
    assert ei.value.code not in (0, None)
    assert not os.listdir(tmp_path)          # nothing ran in its place


def test_embed_slices_configs_and_workdir(tmp_path, capsys):
    with pytest.raises(SystemExit, match="item 5"):
        cli.main(["embed", "--workdir", str(tmp_path), "--start", "256"])
    with pytest.raises(SystemExit, match="item 5"):
        cli.main(["embed", "--workdir", str(tmp_path), "--stop", "256"])
    cli.main(["configs"])
    assert capsys.readouterr().out.split() == sorted(CONFIGS)
    with pytest.raises(SystemExit) as ei:
        cli.main(["train"])
    assert ei.value.code == 2 and "--workdir" in capsys.readouterr().err
