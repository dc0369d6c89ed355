"""The port stands alone: importing every module of dnn_page_vectors_tpu_torch
(and chip_smoke.py) pulls in neither jax nor anything of the JAX package,
and no import statement anywhere in them (or in scripts/serve_ab.py,
scripts/bwd_ab.py and scripts/serve_load.py), lazy ones inside functions
included, names one. Note
the name prefix: the port's package starts with
"dnn_page_vectors_tpu", so the check matches that module exactly or with a
dot after it. Entry points resolve device=None to cuda and raise where no
GPU is present; only an explicit "cpu" runs on the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dnn_page_vectors_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dnn_page_vectors_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_prefix_match_is_exact():
    assert _forbidden("dnn_page_vectors_tpu")
    assert _forbidden("dnn_page_vectors_tpu.config")
    assert _forbidden("jax.numpy")
    assert not _forbidden("dnn_page_vectors_tpu_torch")
    assert not _forbidden("dnn_page_vectors_tpu_torch.config")
    assert not _forbidden("jaxtyping_like")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import dnn_page_vectors_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        f"bad = [n for n in sys.modules if any(n == f or n.startswith(f + '.')"
        f" for f in {FORBIDDEN!r})]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_and_native_are_covered(tmp_path):
    """cli.py and native/ are among the modules the checks above walk, and
    importing them runs no compiler: the C++ library is built on first
    use, never at import."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    for mod in ("cli", "native", "native.trigram_native",
                "native.jsonl_native", "native.subword_native"):
        assert f"dnn_page_vectors_tpu_torch.{mod}" in names, mod
    files = {os.path.relpath(f, PKG) for f in _sources()}
    assert {"cli.py", os.path.join("native", "__init__.py"),
            os.path.join("native", "subword_native.py")} <= files
    code = (
        "import sys; from pathlib import Path\n"
        "import dnn_page_vectors_tpu_torch.native as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "import dnn_page_vectors_tpu_torch.cli, "
        "dnn_page_vectors_tpu_torch.native.subword_native, "
        "dnn_page_vectors_tpu_torch.data.loader\n"
        "print(n._LIB is None, list(n.BUILD_DIR.glob('*')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "True []", proc.stdout + proc.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "scripts", "serve_ab.py")
    yield os.path.join(ROOT, "scripts", "bwd_ab.py")
    yield os.path.join(ROOT, "scripts", "serve_load.py")


def test_no_import_statement_names_jax_or_the_jax_package():
    seen = 0
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            seen += 1
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
    assert seen > 20


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_cuda():
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    cfg = get_config("bert_mini_v5p16", {"model.num_layers": 1,
                                         "model.model_dim": 32,
                                         "model.mlp_dim": 64,
                                         "model.out_dim": 16})
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_two_tower(cfg, vocab_size=64)
    model = build_two_tower(cfg, vocab_size=64, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_serving_modules_are_covered(tmp_path):
    """The serving slice's modules are among those the checks above walk
    (the loadgen package and the telemetry utilities included), and the
    serving commands, like every entry point, run on cuda unless asked
    for the CPU."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    for mod in ("infer.serve", "infer.server", "infer.transport",
                "loadgen", "loadgen.driver", "loadgen.workload",
                "utils.telemetry", "utils.tracing", "utils.logging",
                "utils.profiling"):
        assert f"dnn_page_vectors_tpu_torch.{mod}" in names, mod
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    from dnn_page_vectors_tpu_torch import cli
    for command in ("search", "loadtest", "serve-metrics", "trace"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command, "--workdir", str(tmp_path / "wd"),
                      "--query", "x"])


def test_update_modules_are_covered(tmp_path):
    """The live-update slice's packages (updates/, maintenance/) are among
    those the checks above walk, and its entry points run on cuda unless
    asked for the CPU: append_corpus through its embedder, IVFIndex.update,
    and the CLI's append and refresh."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    for mod in ("updates", "updates.append", "maintenance",
                "maintenance.compact", "maintenance.lease"):
        assert f"dnn_page_vectors_tpu_torch.{mod}" in names, mod
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    from dnn_page_vectors_tpu_torch import cli
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    store = VectorStore(str(tmp_path / "wd" / "store"), dim=8)
    store.ensure_model_step(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IVFIndex.update(store)
    for command in ("append", "refresh"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command, "--workdir", str(tmp_path / "wd"),
                      "--set", "data.num_pages=64"])


def test_migration_and_maintenance_modules_are_covered(tmp_path):
    """The slice's modules (utils/faults.py, maintenance/migrate.py,
    maintenance/service.py) are among those the checks above walk, and its
    entry points run on cuda unless asked for the CPU: the CLI's migrate
    and index, and a MaintenanceService's rebuild."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    for mod in ("utils.faults", "maintenance.migrate",
                "maintenance.service"):
        assert f"dnn_page_vectors_tpu_torch.{mod}" in names, mod
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    import numpy as np

    from dnn_page_vectors_tpu_torch import cli
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.maintenance import MaintenanceService
    store = VectorStore(str(tmp_path / "wd" / "store"), dim=8, shard_size=8)
    store.ensure_model_step(0)
    store.write_shard(0, np.arange(8, dtype=np.int64),
                      np.eye(8, dtype=np.float32))
    for command in ("migrate", "index"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command, "--workdir", str(tmp_path / "wd"),
                      "--set", "data.num_pages=64"])
    ms = MaintenanceService(get_config("cdssm_toy"), store.directory)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ms._swap_index(VectorStore(store.directory), reason="test")


def test_filtered_modules_are_covered():
    """The filtered-retrieval slice's module (index/attrs.py) is among
    those the checks above walk, and imports neither jax nor the JAX
    package on its own (in a fresh interpreter)."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    assert "dnn_page_vectors_tpu_torch.index.attrs" in names
    assert os.path.join("index", "attrs.py") in {
        os.path.relpath(f, PKG) for f in _sources()}
    code = ("import sys\n"
            "import dnn_page_vectors_tpu_torch.index.attrs as a\n"
            "p = a.Predicate.parse('lang==1')\n"
            f"bad = [n for n in sys.modules if any(n == f or "
            f"n.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
            "print(p.text, bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "lang==1 []", proc.stdout + proc.stderr


def test_partition_modules_are_covered(tmp_path):
    """The partitioned-serving slice's modules (infer/partition.py,
    parallel/multihost.py) are among those the checks above walk, import
    neither jax nor the JAX package on their own (in a fresh
    interpreter), and the partitioned search runs on cuda unless asked
    for the CPU."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    for mod in ("infer.partition", "parallel", "parallel.multihost"):
        assert f"dnn_page_vectors_tpu_torch.{mod}" in names, mod
    assert {os.path.join("infer", "partition.py"),
            os.path.join("parallel", "multihost.py")} <= {
        os.path.relpath(f, PKG) for f in _sources()}
    code = ("import sys\n"
            "import dnn_page_vectors_tpu_torch.infer.partition as part\n"
            "import dnn_page_vectors_tpu_torch.parallel.multihost as mh\n"
            "print(mh.partition_shard_ranges([1, 1, 1], 2), "
            "[n for n in sys.modules if any(n == f or "
            f"n.startswith(f + '.') for f in {FORBIDDEN!r})])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "[(0, 2), (2, 3)] []", \
        proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    from dnn_page_vectors_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["search", "--workdir", str(tmp_path / "wd"), "--query",
                  "x", "--partitions", "2", "--replicas", "2"])


def test_partition_host_is_covered(tmp_path):
    """The fleet's module (infer/partition_host.py) is among those the
    checks above walk and imports neither jax nor the JAX package on its
    own; a partition worker stages on the card unless asked for the CPU,
    and raises where there is none (the CLI's worker too)."""
    import pkgutil
    import dnn_page_vectors_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    assert "dnn_page_vectors_tpu_torch.infer.partition_host" in names
    assert os.path.join("infer", "partition_host.py") in {
        os.path.relpath(f, PKG) for f in _sources()}
    code = ("import sys\n"
            "import dnn_page_vectors_tpu_torch.infer.partition_host as ph\n"
            "print(ph.DeviceEmbedder('cpu').device, "
            "[n for n in sys.modules if any(n == f or "
            f"n.startswith(f + '.') for f in {FORBIDDEN!r})])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "cpu []", proc.stdout + proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    from dnn_page_vectors_tpu_torch import cli
    from dnn_page_vectors_tpu_torch.infer.partition_host import (
        DeviceEmbedder, PartitionWorker)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceEmbedder(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PartitionWorker(get_config("cdssm_toy"), str(tmp_path / "store"),
                        ("127.0.0.1", 1), partition=0, partitions=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["partition-worker", "--workdir", str(tmp_path / "wd"),
                  "--connect", "127.0.0.1:1"])
