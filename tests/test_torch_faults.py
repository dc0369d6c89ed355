"""The port's fault plan and retry policy (utils/faults.py) against the
JAX package's: one spec string and seed fire the same schedule (which
calls of which op raise, sleep, or corrupt which byte and bit of a file),
``retry`` absorbs a transient fault and re-raises a persistent one with
the same counters, and ``CircuitBreaker`` walks the same states on a fake
clock. The store's fault points: a transient manifest or shard fault is
absorbed by the retry, a persistent one raises and leaves the store as it
was."""
import os

import numpy as np
import pytest

from dnn_page_vectors_tpu.utils import faults as jfaults
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.utils import faults, telemetry


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jfaults):
        mod.reset()
        mod.configure_retry(3, 0.0, 0.0)
    yield
    for mod in (faults, jfaults):
        mod.reset()


PLAN = ("shard_write:io_error:1,manifest_dump:io_error:0:2,"
        "shard_file:bit_flip:0,manifest_file:truncate:2,"
        "wire_send:frame_trunc:3,wire_recv:conn_drop:1:*,"
        "shard_read:delay:4")
OPS = ("shard_write", "manifest_dump", "shard_read", "wire_send",
       "wire_recv", "worker_dial")


def _schedule(mod, tmp_path, tag):
    """Drive one plan through a fixed call sequence; returns what each
    call did and the damaged files' bytes."""
    plan = mod.FaultPlan.parse(PLAN, seed=7)
    out = []
    for i in range(6):
        for op in OPS[:3]:
            try:
                plan.check(op)
                out.append((op, i, "ok"))
            except mod.InjectedFault:
                out.append((op, i, "raise"))
            out.append((op, "pending", plan.pending(op)))
        for op in OPS[3:]:
            spec = plan.wire(op)
            out.append((op, i, None if spec is None else spec.kind))
    files = []
    for i, op in enumerate(("shard_file", "manifest_file") * 3):
        path = os.path.join(tmp_path, f"{tag}_{i}.bin")
        with open(path, "wb") as f:
            f.write(bytes(range(256)) * 4)
        out.append((op, i, plan.corrupt(op, path)))
        files.append(open(path, "rb").read())
    return out, files, mod.counters()


def test_one_spec_and_seed_fire_the_same_schedule(tmp_path):
    got, got_files, got_counts = _schedule(faults, tmp_path, "port")
    want, want_files, want_counts = _schedule(jfaults, tmp_path, "jax")
    assert got == want
    assert got_files == want_files
    assert got_counts == want_counts
    assert any(r[2] == "raise" for r in got)
    assert got_files[0] != bytes(range(256)) * 4          # a bit flipped
    assert len(got_files[5]) == 512                        # truncated


@pytest.mark.parametrize("bad", ["x", "a:b:c:d:e", "op:melt", "op:io_error:-1",
                                 "op:io_error:0:0"])
def test_bad_specs_raise_as_in_jax(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)


def test_retry_absorbs_a_transient_fault_and_reraises_a_persistent_one():
    for mod in (faults, jfaults):
        calls = []

        def flaky():
            calls.append(1)
            mod.active().check("shard_write")
            return "done"

        mod.install(mod.FaultPlan.parse("shard_write:io_error:0"))
        assert mod.retry(flaky, op="shard_write") == "done"
        assert len(calls) == 2
        mod.install(mod.FaultPlan.parse("shard_write:io_error:0:*"))
        calls.clear()
        with pytest.raises(mod.InjectedFault):
            mod.retry(flaky, op="shard_write")
        assert len(calls) == 3
        # a non-OSError is never retried
        with pytest.raises(ZeroDivisionError):
            mod.retry(lambda: 1 / 0, op="x")
    assert faults.counters() == jfaults.counters()
    assert faults.counters()["retry_shard_write"] == 3
    assert faults.counters()["injected_shard_write_io_error"] == 4


def test_counters_mirror_into_the_default_registry():
    reg = telemetry.reset_default()
    faults.count("quarantined_shards", 2)
    assert reg.counter("fault.quarantined_shards").value == 2
    faults.reset()
    assert faults.counters() == {}


def test_install_from_config_sets_the_plan_and_the_retry_policy():
    cfg = get_config("cdssm_toy", {"faults.plan": "shard_write:io_error:0",
                                   "faults.retry_attempts": 5})
    plan = faults.install_from_config(cfg)
    assert plan is faults.active() and plan.pending("shard_write")
    assert faults._RETRY["attempts"] == 5
    faults.reset()
    assert faults.install_from_config(get_config("cdssm_toy")) is None
    assert not faults.active().pending("shard_write")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_circuit_breaker_walks_the_jax_states():
    events = ["f", "f", "a", "f", "a", "t1", "a", "a", "f", "a", "t1", "a",
              "t2", "a", "s", "a", "f", "f", "f", "a", "r", "a"]
    runs = []
    for mod in (faults, jfaults):
        clock, log = _Clock(), []
        br = mod.CircuitBreaker(failures=3, open_s=1.0, max_open_s=3.0,
                                clock=clock,
                                on_open=lambda b: log.append("open"),
                                on_close=lambda b: log.append("close"))
        trace = []
        for ev in events:
            if ev == "f":
                br.record_failure()
            elif ev == "s":
                br.record_success()
            elif ev == "r":
                br.reset()
            elif ev.startswith("t"):
                clock.t += float(ev[1:])
            else:
                trace.append(br.allow())
            trace.append((br.state, br.trips))
        runs.append((trace, log))
    assert runs[0] == runs[1]
    trace, log = runs[0]
    assert ("open", 1) in trace and ("half_open", 1) in trace
    assert log[:2] == ["open", "open"] and "close" in log


def test_store_dumps_and_writes_retry_transient_faults(tmp_path):
    store = VectorStore(str(tmp_path / "s"), dim=4, shard_size=8)
    store.ensure_model_step(1)
    faults.install(faults.FaultPlan.parse(
        "manifest_dump:io_error:0,shard_write:io_error:0"))
    store.write_shard(0, np.arange(8, dtype=np.int64),
                      np.eye(8, 4, dtype=np.float32))
    c = faults.counters()
    assert c["retry_manifest_dump"] == 1 and c["retry_shard_write"] == 1
    assert VectorStore(store.directory).num_vectors == 8
    # a persistent manifest fault raises and leaves the manifest as it was
    faults.install(faults.FaultPlan.parse("manifest_dump:io_error:0:*"))
    with pytest.raises(faults.InjectedFault):
        store.write_shard(1, np.arange(8, 16, dtype=np.int64),
                          np.eye(8, 4, dtype=np.float32))
    faults.install(faults.FaultPlan())
    assert VectorStore(store.directory).num_vectors == 8


def test_a_corrupted_shard_file_is_quarantined_on_open(tmp_path):
    store = VectorStore(str(tmp_path / "s"), dim=4, shard_size=8)
    store.ensure_model_step(1)
    faults.install(faults.FaultPlan.parse("shard_file:bit_flip:1", seed=3))
    for i in range(2):
        store.write_shard(i, np.arange(8 * i, 8 * i + 8, dtype=np.int64),
                          np.eye(8, 4, dtype=np.float32) + i)
    faults.install(faults.FaultPlan())
    again = VectorStore(store.directory)
    assert [s["index"] for s in again.shards()] == [0]
    assert again.missing_id_ranges() == [(8, 16)]
    assert faults.counters()["quarantined_shards"] == 1
