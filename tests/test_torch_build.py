"""The build's bookkeeping, on the CPU (no CUDA source is compiled here;
one test builds the host library with g++ from two threads at once;
others pass each wrapper's launch site from two threads, a fake library
standing in for the CUDA one).

A library's file name carries a hash of everything its build depends on:
the source, every local header it includes, and nvcc's flags.
tools/kernel_variants.py builds other versions of the package through
their own build; here, only how it makes them.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
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
        "cp_features": ["cp_features.cu", "factor_common.cuh"],
        "eval_prepass": ["eval_prepass.cu"],
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


def test_two_threads_build_the_host_library_once(tmp_path, monkeypatch):
    """Two threads load ``host_ops`` into an empty build directory at the
    same moment: g++ runs under the build lock, both get one library, and
    no temporary file is left (the temporary name is per process and
    thread)."""
    import threading

    from text2nerf_tpu_torch import native

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    barrier = threading.Barrier(2)
    libs, errors = [None, None], []

    def load(i):
        try:
            barrier.wait()
            libs[i] = native.load()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert libs[0] is not None and libs[0] is libs[1]
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(built) == 1 and built[0].startswith("libhost_ops-") and ".tmp" not in built[0]
    img, depth = native.sparse_bilateral(np.ones((8, 8), np.float32),
                                         np.zeros((8, 8, 3), np.float32), (3,), 0.02)
    assert img.shape == (8, 8, 3) and depth.shape == (8, 8)


def test_temporary_names_differ_by_thread():
    import threading

    out = _build.BUILD_DIR / "libx-0123.so"
    names = [_build._tmp_path(out)]
    t = threading.Thread(target=lambda: names.append(_build._tmp_path(out)))
    t.start()
    t.join()
    assert names[0] != names[1] and all(".tmp" in n.name for n in names)


def _fake_launcher(*args):
    return 0


def _fake_backward_launcher(*args):
    # the launchers' info array (route, grid, block) sits before the stream
    ctypes.cast(args[-2], ctypes.POINTER(ctypes.c_int))[0] = 1
    return 0


def _launch_sites():
    """{name: (launch once, read the count)} at each wrapper's launch site,
    on tiny CPU tensors; the caller replaces the libraries by fakes."""
    import torch

    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk
    from text2nerf_tpu_torch.ops.kernels import eval_prepass as ep
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    g = torch.Generator().manual_seed(0)
    xn = torch.rand((5, 3), generator=g) * 2 - 1
    planes = [torch.rand((4, 4, 3), generator=g) for _ in range(3)]
    lines = [torch.rand((4, 3), generator=g) for _ in range(3)]
    nd = (1, 1, 1)
    mlp = {"w1": torch.rand((2 * 5, 128), generator=g), "b1": torch.rand(128, generator=g),
           "w2": torch.rand((128, 128), generator=g), "b2": torch.rand(128, generator=g),
           "w3": torch.rand((128, 3), generator=g), "b3": torch.rand(3, generator=g)}
    feats = torch.rand((5, 2), generator=g)
    # the MLP_Fea head at C 2, fea_pe 2, view_pe 0: 2 + 3 + 2 * 2 * 2 inputs
    mlp_view = dict(mlp, w1=torch.rand((13, 128), generator=g))
    dirs = torch.rand((5, 3), generator=g)
    box = torch.tensor([[-1.0, -1, -1], [1, 1, 1]])
    prepass_args = (torch.rand((5, 6), generator=g), box, box, torch.tensor(0.1),
                    torch.ones((4, 4, 4)), 8, 4, 0.5, 8.0, 2.0, 1, (2, 4))
    return {
        "factor_features": (lambda: ff._launch(xn, planes, lines, nd, True, True, False),
                            lambda: (ff.LAUNCHES, ff.DTYPES["fp32"])),
        "factor_features_bf16": (lambda: ff._launch(xn, planes, lines, nd, True, True, True),
                                 lambda: (ff.LAUNCHES, ff.DTYPES["bf16"])),
        "factor_features_bwd": (
            lambda: ff._launch_backward(xn, planes, lines, nd, xn[:, 0].contiguous(),
                                        torch.ones((5, 6)), False, None),
            lambda: (ff.BWD_LAUNCHES, ff.BWD_MODES["fused"], ff.BWD_DTYPES["fp32"],
                     ff.BWD_ROUTES["shared"])),
        "factor_features_bwd_bf16": (
            lambda: ff._launch_backward(xn, planes, lines, nd, xn[:, 0].contiguous(),
                                        torch.ones((5, 6), dtype=torch.bfloat16), True, None),
            lambda: (ff.BWD_LAUNCHES, ff.BWD_MODES["fused"], ff.BWD_DTYPES["bf16"],
                     ff.BWD_ROUTES["shared"])),
        "shading_mlp": (lambda: sm._launch(mlp, feats, 2),
                        lambda: (sm.LAUNCHES, sm.MODES["noview"])),
        "shading_mlp_view": (lambda: sm._launch_view(mlp_view, feats, dirs, 1, 2, 0),
                             lambda: (sm.LAUNCHES, sm.MODES["view"])),
        "cp_features": (lambda: cpk._launch(xn, lines, 1, True, True, False),
                        lambda: (cpk.LAUNCHES, cpk.DTYPES["fp32"])),
        "cp_features_bwd": (
            lambda: cpk._launch_backward(xn, lines, 1, xn[:, 0].contiguous(),
                                         torch.ones((5, 2)), False, None),
            lambda: (cpk.BWD_LAUNCHES, cpk.BWD_DTYPES["fp32"], cpk.BWD_ROUTES["shared"])),
        "cp_features_bf16": (lambda: cpk._launch(xn, lines, 1, True, True, True),
                             lambda: (cpk.LAUNCHES, cpk.DTYPES["bf16"])),
        "cp_features_bwd_bf16": (
            lambda: cpk._launch_backward(xn, lines, 1, xn[:, 0].contiguous(),
                                         torch.ones((5, 2), dtype=torch.bfloat16), True, None),
            lambda: (cpk.BWD_LAUNCHES, cpk.BWD_DTYPES["bf16"], cpk.BWD_ROUTES["shared"])),
        "eval_prepass": (lambda: ep._launch(*prepass_args), lambda: ep.LAUNCHES),
    }


@pytest.mark.parametrize("site", ["factor_features", "factor_features_bf16",
                                  "factor_features_bwd", "factor_features_bwd_bf16",
                                  "shading_mlp", "shading_mlp_view", "cp_features",
                                  "cp_features_bwd", "cp_features_bf16", "cp_features_bwd_bf16",
                                  "eval_prepass"])
def test_launch_counts_are_exact_under_two_threads(site, monkeypatch):
    """Two threads pass the same wrapper's launch site N times each (the
    CUDA library replaced by a fake that returns success; farm workers are
    threads of one process): the count grows by exactly 2N."""
    import contextlib
    import sys
    import threading
    from types import SimpleNamespace

    import torch

    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk
    from text2nerf_tpu_torch.ops.kernels import eval_prepass as ep
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    fake = SimpleNamespace(t2n_factor_features=_fake_launcher,
                           t2n_factor_features_bf16=_fake_launcher,
                           t2n_factor_features_bwd=_fake_backward_launcher,
                           t2n_factor_features_bwd_bf16=_fake_backward_launcher,
                           t2n_shade_fea_noview=_fake_launcher,
                           t2n_shade_fea=_fake_launcher,
                           t2n_cp_features=_fake_launcher,
                           t2n_cp_features_bf16=_fake_launcher,
                           t2n_cp_features_bwd=_fake_backward_launcher,
                           t2n_cp_features_bwd_bf16=_fake_backward_launcher,
                           t2n_eval_prepass=_fake_launcher)
    for mod, names in ((ff, ("_lib", "_lib_backward")), (sm, ("_lib",)), (cpk, ("_lib",)),
                       (ep, ("_lib",))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda: fake)
    # the counts are restored when the test ends
    for mod, names in ((ff, ("LAUNCHES", "DTYPES", "BF16_COPIES", "BWD_LAUNCHES", "BWD_MODES",
                             "BWD_DTYPES", "BWD_ROUTES", "BWD_LAST_GRID")),
                       (sm, ("LAUNCHES", "MODES")), (ep, ("LAUNCHES",)),
                       (cpk, ("LAUNCHES", "DTYPES", "BWD_LAUNCHES", "BWD_DTYPES", "BWD_ROUTES",
                              "BWD_LAST_GRID"))):
        for name in names:
            value = getattr(mod, name)
            monkeypatch.setattr(mod, name, dict(value) if isinstance(value, dict) else value)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    launch, read = _launch_sites()[site]
    before = read()
    n = 2000
    barrier = threading.Barrier(2)
    errors = []

    def work():
        try:
            barrier.wait()
            with torch.no_grad():
                for _ in range(n):
                    launch()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    after = read()
    if isinstance(before, tuple):
        assert [a - b for a, b in zip(after, before)] == [2 * n] * len(before)
    else:
        assert after - before == 2 * n
