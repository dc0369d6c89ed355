"""The cache key of the port's kernel libraries (ops/build.py): a library
is named by a hash of its source, of every header under csrc/, of nvcc's
flags and of nvcc's version, so an edit to a shared header (mma_sm80.cuh,
included by both sources), another flag or another nvcc rebuilds both,
and an unchanged tree reuses what was built. No nvcc runs here."""
import shutil

import pytest

from dnn_page_vectors_tpu_torch.ops import build

SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
NVCC = "Cuda compilation tools, release 12.8, V12.8.93"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.CSRC points to."""
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    monkeypatch.setattr(build, "CSRC", dst)
    return dst


def _keys(toolchain=NVCC):
    return {src: build.source_digest(src, toolchain) for src in SOURCES}


def test_every_header_a_source_includes_lies_under_csrc(csrc):
    headers = {p.name for p in csrc.glob("*.cuh")}
    assert "mma_sm80.cuh" in headers
    for src in SOURCES:
        text = (csrc / src).read_text()
        for line in text.splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in headers, (src, line)


def test_key_is_stable_for_an_unchanged_tree(csrc, monkeypatch):
    here = _keys()
    assert here == _keys()
    monkeypatch.undo()           # the checkout's own csrc/: the same key
    assert here == _keys()


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_key_changes_with_a_header_or_the_source(csrc, edit):
    before = _keys()
    if edit == "header":
        with open(csrc / "mma_sm80.cuh", "a") as f:
            f.write("\n// an edit\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        with open(csrc / "flash_fwd.cu", "a") as f:
            f.write("\n// an edit\n")
    after = _keys()
    if edit == "source":     # the other source keeps its library
        assert after["flash_fwd.cu"] != before["flash_fwd.cu"]
        assert after["flash_bwd.cu"] == before["flash_bwd.cu"]
    else:
        assert all(after[s] != before[s] for s in SOURCES)


@pytest.mark.parametrize("edit", ["flag", "nvcc"])
def test_key_changes_with_the_nvcc_flags_or_version(csrc, monkeypatch,
                                                    edit):
    before = _keys()
    if edit == "flag":
        monkeypatch.setattr(build, "NVCC_FLAGS",
                            [*build.NVCC_FLAGS, "-lineinfo"])
        after = _keys()
    else:
        after = _keys(NVCC.replace("12.8.93", "12.9.41"))
    assert all(after[s] != before[s] for s in SOURCES)


def test_a_built_library_is_found_by_its_key(csrc, tmp_path, monkeypatch):
    """compile_source returns the library named by the current key without
    calling nvcc to build (with the build log kept beside it), and looks
    for a new one after a header edit."""
    out = tmp_path / "build"
    out.mkdir()
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "find_nvcc", lambda: "/no/such/nvcc")
    monkeypatch.setattr(build, "nvcc_version", lambda nvcc: NVCC)

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc must not run for a cached library")
    monkeypatch.setattr(build.subprocess, "run", no_nvcc)
    monkeypatch.setattr(build, "BUILD_INFO", {})
    lib = out / f"flash_bwd-{build.source_digest('flash_bwd.cu', NVCC)}.so"
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 166 registers")
    assert build.compile_source("flash_bwd.cu") == lib
    # the registers and spills of the cached build come from its log
    assert build.BUILD_INFO["flash_bwd.cu"] == (
        0.0, "ptxas info    : Used 166 registers")
    with open(csrc / "mma_sm80.cuh", "a") as f:
        f.write("\n// an edit\n")
    with pytest.raises(AssertionError, match="nvcc must not run"):
        build.compile_source("flash_bwd.cu")
