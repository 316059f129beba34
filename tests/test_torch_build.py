"""The CUDA build's bookkeeping, on the CPU (nothing is compiled here).

A library's file name carries a hash of everything its build depends on:
the source, every local header it includes, and nvcc's flags.
tools/kernel_variants.py builds other versions of the package through
their own build; here, only how it makes them.
"""

import importlib.util
from pathlib import Path

import pytest

from text2nerf_tpu_torch.ops.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_the_hash_covers_every_included_header(csrc):
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// v1\n")
    assert [p.name for p in _build.dependencies("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (csrc / "b.cuh").write_text("// v2\n")  # a header two includes deep
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


def test_a_missing_local_header_raises(csrc):
    (csrc / "k.cu").write_text('#include "gone.cuh"\n')
    with pytest.raises(FileNotFoundError, match="gone.cuh"):
        _build.library_path("k")


def test_the_hash_covers_the_flags(csrc, monkeypatch):
    (csrc / "k.cu").write_text("// kernel\n")
    first = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-I", str(csrc / "inc")))
    second = _build.library_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1] + (str(csrc / "other"),))
    assert _build.library_path("k") not in (first, second)


def test_the_port_sources_and_their_headers():
    deps = {name: [p.name for p in _build.dependencies(name)] for name in _build.SOURCES}
    assert deps == {
        "factor_features": ["factor_features.cu", "factor_common.cuh"],
        "factor_features_bwd": ["factor_features_bwd.cu", "factor_common.cuh"],
        "shading_mlp": ["shading_mlp.cu", "hopper.cuh"],
    }
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)  # no fast math


def _variants_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_variants_edit_a_copy_of_a_package(tmp_path):
    kv = _variants_tool()
    assert kv.parse("plain") == ("plain", kv.REPO, [])
    src = tmp_path / "other"
    (src / kv.PKG / "csrc").mkdir(parents=True)
    (src / kv.PKG / "build").mkdir()
    (src / kv.PKG / "csrc" / "k.cu").write_text("a: 1;\nb\n")
    name, base, pairs = kv.parse(f"one={src}:csrc/k.cu:a: 1;\\n=>;;b=>c")
    assert (name, base) == ("one", src.resolve())
    assert pairs == [("csrc/k.cu", "a: 1;\n", ""), ("csrc/k.cu", "b", "c")]
    assert kv.materialise(name, base, []) == base  # no edits: the directory itself
    root = kv.materialise(name, base, pairs, dest=tmp_path / "variants")
    assert (root / kv.PKG / "csrc" / "k.cu").read_text() == "c\n"
    assert (src / kv.PKG / "csrc" / "k.cu").read_text() == "a: 1;\nb\n"
    assert not (root / kv.PKG / "build").exists()  # built anew, by its own hash
    with pytest.raises(ValueError, match="does not occur"):
        kv.materialise(name, base, [("csrc/k.cu", "zz", "")], dest=tmp_path / "v2")
    with pytest.raises(FileNotFoundError, match="no text2nerf_tpu_torch"):
        kv.materialise("gone", tmp_path / "none", [])
