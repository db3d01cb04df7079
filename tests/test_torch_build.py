"""The naming rule of ops/cuda/_build.py: a library is named by a hash of its .cu
and of every csrc/ header that source includes, so that editing a shared
header rebuilds every kernel that uses it (nothing is compiled here)."""

import shutil

import pytest

from rqvae_tpu_torch.ops.cuda import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_sources_and_their_headers():
    assert _build.SOURCES == ("rq_encode", "decoder_stack", "attention", "encoder_stack", "attention_bwd")
    names = {name: [p.name for p in _build.source_files(name)] for name in _build.SOURCES}
    assert names == {
        "rq_encode": ["rq_encode.cu", "mma_core.cuh"], "decoder_stack": ["decoder_stack.cu", "mma_core.cuh", "rows_core.cuh"],
        "attention": ["attention.cu", "attention_core.cuh", "mma_core.cuh"],
        "encoder_stack": ["encoder_stack.cu", "attention_core.cuh", "mma_core.cuh", "rows_core.cuh"],
        "attention_bwd": ["attention_bwd.cu", "attention_core.cuh", "mma_core.cuh"],
    }
    assert str(_build.CSRC) in _build.NVCC_FLAGS  # quoted includes resolve under csrc/


def test_library_name_follows_the_header(csrc_copy):
    before = {name: _build._lib_path(name).name for name in _build.SOURCES}
    with open(csrc_copy / "attention_core.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build._lib_path(name).name for name in _build.SOURCES}
    assert after["attention"] != before["attention"] and after["encoder_stack"] != before["encoder_stack"]
    assert after["attention_bwd"] != before["attention_bwd"]
    assert after["rq_encode"] == before["rq_encode"] and after["decoder_stack"] == before["decoder_stack"]
    with open(csrc_copy / "attention.cu", "a") as f:
        f.write("// edited\n")
    assert _build._lib_path("attention").name != after["attention"]
    assert _build._lib_path("encoder_stack").name == after["encoder_stack"]
    with open(csrc_copy / "rows_core.cuh", "a") as f:  # the two stacks' row products
        f.write("// edited\n")
    assert _build._lib_path("encoder_stack").name != after["encoder_stack"]
    assert _build._lib_path("decoder_stack").name != after["decoder_stack"]
    assert _build._lib_path("attention_bwd").name == after["attention_bwd"]


def test_nested_and_missing_includes(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    with open(csrc_copy / "attention_core.cuh", "a") as f:
        f.write('#include "inner.cuh"\n')
    assert [p.name for p in _build.source_files("encoder_stack")] == [
        "encoder_stack.cu", "attention_core.cuh", "inner.cuh", "mma_core.cuh", "rows_core.cuh"]
    (csrc_copy / "inner.cuh").unlink()
    with pytest.raises(RuntimeError, match="inner.cuh"):
        _build.source_files("attention")


def test_a_built_library_keeps_its_compiler_log(tmp_path, monkeypatch):
    """build_all returns each source's ptxas log also when the library was
    built before (the log is kept beside it); a library without its log is
    built again, so no caller reads an empty log."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for name in _build.SOURCES:
        lib = _build._lib_path(name)
        lib.write_bytes(b"")
        _build._log_path(lib).write_text(f"ptxas info : {name}\n")
    assert _build.build_all() == {name: f"ptxas info : {name}\n" for name in _build.SOURCES}
    _build._log_path(_build._lib_path("decoder_stack")).unlink()
    started = []
    monkeypatch.setattr(_build.subprocess, "Popen", lambda cmd, **kw: started.append(cmd) or None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    assert _build._start_build("decoder_stack") is not None and _build._start_build("attention") is None
    assert len(started) == 1 and started[0][-1].endswith("decoder_stack.cu")
