#!/usr/bin/env python3
"""Time the port's CUDA kernels in other versions of the package.

    python3 tools/kernel_variants.py [--kernels K[,K...]] [--cp-step] VARIANT [VARIANT ...]

VARIANT is ``NAME[=DIR][:FILE:OLD=>NEW[;;OLD=>NEW...]]`` or
``NAME[=DIR]:FILE=SOURCE[:FILE=SOURCE...]``.  DIR holds a
``text2nerf_tpu_torch`` package (an unpacked ``git archive`` of another
commit, say); without it, this checkout's.  With edits, the package is
copied under this checkout's ``text2nerf_tpu_torch/build/variants/`` and
each literal OLD is replaced by NEW in FILE, a path inside the package
such as ``csrc/shading_mlp.cu`` (backslash escapes such as ``\\n`` are
decoded; OLD must occur), or each FILE is replaced by SOURCE, a file of
this checkout (such as ``tools/kernel_baselines/cp_features_v2.cu``).

``--kernels`` names the kernels to time, of ``a`` (kernel A), ``b``
(kernel B), ``a1`` (kernel A'), ``a16`` and ``a1_16`` (kernels A and A'
in bf16), ``cp`` (kernels C and C'); all by default.  ``--cp-step`` also
profiles one TensorCP dense train step per version.

The second design of kernels C and C' (fp32 lines and gradients in bf16
mode) is kept in ``tools/kernel_baselines/`` with its wrapper; chip_smoke.py
phase 3 times it beside this checkout's with ``--kernels cp`` (its
variant, one argument: ``"v2:csrc/cp_features.cu=tools/kernel_baselines/
cp_features_v2.cu:ops/kernels/cp_features.py=tools/kernel_baselines/
cp_features_v2.py"``).  The first design of the bf16 modes of kernels A
and A' is kept there too (its two sources and its wrapper); from the
repo root it is timed beside this checkout's with

    B=tools/kernel_baselines
    python3 tools/kernel_variants.py --kernels a16,a1_16 "v1:csrc/factor_features.cu=\\
    $B/factor_features_v1.cu:csrc/factor_features_bwd.cu=$B/factor_features_bwd_v1.cu\\
    :ops/kernels/factor_features.py=$B/factor_features_v1.py"

(the variant one argument, without the line breaks).

Each version runs in a process of its own that imports the package from
its directory, so it is built by that package's own ``_build`` (its
sources, headers, flags and hash).  There each kernel is held against its
plain version on chip_smoke.py's kernel inputs (kernel A: 1M samples of
the full-width room shell, 65536 rays x 16 consecutive steps; kernel B:
1M rows of the full-width head; kernel A in bf16: the same samples in
its three output modes, and the fused mode followed by the cast to bf16
that ``TensoRF._basis`` makes of an fp32 ``app_raw`` (none for a bf16
one), a render chunk's share; kernel A', fused mode: phase 3's three
layouts of 1M samples, 16384 rays x 64 consecutive steps, with random
output gradients, and the output gradients of one compacted train step of
chip_smoke.py's phase 5, caught on their way into kernel A'; kernel A'
in bf16: the three layouts, fused mode, random bf16-valued output
gradients in the dtype the version's kernel A returns ``app_raw`` in (the
one autograd hands back); kernels C
and C', fp32 and bf16: a TensorCP field at the published widths,
chip_smoke.py phase 3's three shapes, each in its own output mode: 1M
fused samples, a dense step's density-only launch over 16384 rays x 259
ray-ordered samples and its app-only launch over each ray's top 64
samples by weight, with random output gradients, in bf16 bf16-valued
and in the dtype the version's kernel C returns ``app_raw`` in) and
timed with chip_smoke.py's CUDA-event timer, L2 flushed between calls,
20 calls.  The TensorCP step (``--cp-step``) is
chip_smoke.py phase 11's TensorCP configuration (the CLI's flags and
overrides: 96 / 288 components, MLP_Fea, batch 16384, one sub-batch,
app_k 64) on the 300^3 grid, stepped dense toward phase 5's room-shell
targets: 3 steps, then 5 under torch.profiler, device time per step split
into kernel C, kernel C', the MLP_Fea head (forward and backward),
``torch.topk`` and the rest by text2nerf_tpu_torch/profile_train.py's
rules.  The versions run in the order this checkout, v1 .. vn, vn .. v1,
this checkout, so each is timed twice and a drift of the card shows as a
gap between its two readings.  Prints the card's name and power limit, a
line per kernel and run, and last a JSON object of every run's numbers.
Needs one GPU.
"""

from __future__ import annotations

import codecs
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
VARIANTS_DIR = REPO / "text2nerf_tpu_torch" / "build" / "variants"
PKG = "text2nerf_tpu_torch"


def parse(spec: str):
    """(name, base directory, [(file, old, new), ...]) of a VARIANT (new
    None: old is the whole new file)."""
    head, _, edits = spec.partition(":")
    name, _, base = head.partition("=")
    base = Path(base).resolve() if base else REPO
    pairs = []
    if edits:
        if "=>" not in edits:  # FILE=SOURCE[:FILE=SOURCE...]
            for item in edits.split(":"):
                path, sep, source = item.partition("=")
                if not sep:
                    raise ValueError(f"{spec}: edits are FILE:OLD=>NEW or FILE=SOURCE")
                pairs.append((path, None, (REPO / source).read_text()))
            return name, base, pairs
        path, sep, rest = edits.partition(":")
        if not sep:
            raise ValueError(f"{spec}: edits are FILE:OLD=>NEW or FILE=SOURCE")
        for edit in rest.split(";;"):
            old, sep, new = edit.partition("=>")
            if not sep:
                raise ValueError(f"{spec}: an edit is OLD=>NEW")
            pairs.append((path, codecs.decode(old, "unicode_escape"),
                          codecs.decode(new, "unicode_escape")))
    return name, base, pairs


def materialise(name: str, base: Path, pairs, dest: Path = VARIANTS_DIR) -> Path:
    """The directory whose package is the variant: ``base`` itself, or an
    edited copy of its package under ``dest/name``."""
    if not (base / PKG).is_dir():
        raise FileNotFoundError(f"{name}: {base} holds no {PKG} package")
    if not pairs:
        return base
    root = dest / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(base / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for path, old, new in pairs:
        f = root / PKG / path
        if old is None:  # the whole file
            f.write_text(new)
            continue
        text = f.read_text()
        if old not in text:
            raise ValueError(f"{name}: {old!r} does not occur in {path}")
        f.write_text(text.replace(old, new))
    return root


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _time_version(name: str, root: Path, kernels, cp_step: bool) -> dict:
    """The named kernels of the package under ``root``, on chip_smoke.py's
    inputs (made by this checkout's chip_smoke.py with that package)."""
    sys.path.insert(0, str(root))
    import torch

    from text2nerf_tpu_torch.data import synthetic as syn
    from text2nerf_tpu_torch.ops import rays as R
    from text2nerf_tpu_torch.ops.kernels import _build
    from text2nerf_tpu_torch.ops.kernels import factor_features as ff
    from text2nerf_tpu_torch.ops.kernels import shading_mlp as sm

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"{name}: imported {_build.__file__}, not the package in {root}")
    cs = _chip_smoke()

    if kernels == {"cp"} and not cp_step:
        _build.build(("cp_features",))
    else:
        _build.build()
    out_ptxas = _ptxas(_build.BUILD_LOGS.get("cp_features", ""))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = syn.serving_shell(0, dev)
    planes, lines, nd = tuple(field.planes), tuple(field.lines), field.nd
    intr = R.default_intrinsics(*syn.VIEW_HW)
    dirs = R.ray_directions(*syn.VIEW_HW, intr[:2], intr[2:], device=dev)
    rays = torch.cat(R.rays_from_pose(dirs, syn.serving_poses()[0]), -1)
    aabb = torch.tensor(syn.AABB, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    out = {"name": name, "inputs": [], "ptxas": out_ptxas}

    bf = torch.bfloat16
    if kernels & {"a", "b", "a16"}:
        xn = cs._chunk_samples(rays, aabb, field, cs.N_SAMPLES_A, gen)
        feats = 2.0 * torch.randn(cs.N_ROWS_B, field.cfg.app_dim, generator=gen, device=dev)

        def run_a():
            return ff.factor_features(xn, planes, lines, nd)

        def run_b():
            return sm.shade_fea_noview(field.mlp, feats, field.cfg.fea_pe)

        out["inputs"] += [float(xn.sum()), float(feats.sum()), float(field.mlp.w1.sum())]
        if "a" in kernels:
            out["a_exact"] = all(torch.equal(g, r) for g, r in zip(
                run_a(), ff.factor_features_plain(xn, planes, lines, nd)))
            out["a_ms"] = cs._time_ms(run_a, 20, flush)
        if "b" in kernels:
            out["b_err"] = float((run_b() - sm.shade_fea_noview_plain(
                field.mlp, feats, field.cfg.fea_pe)).abs().max())
            out["b_ms"] = cs._time_ms(run_b, 20, flush)
        if "a16" in kernels:
            out["a16_ms"], out["a16_exact"] = {}, {}
            for mode, sig, app in (("fused", True, True), ("density", True, False),
                                   ("app", False, True)):
                def run_a16():
                    return ff.factor_features(xn, planes, lines, nd, sigma=sig, app=app,
                                              dtype=bf)

                got = run_a16()
                ref = ff.factor_features_plain(xn, planes, lines, nd, sigma=sig, app=app,
                                               dtype=bf)
                out["a16_exact"][mode] = all(torch.equal(g.float(), r.float())
                                             for g, r in zip(got, ref) if g is not None)
                del got, ref
                out["a16_ms"][mode] = cs._time_ms(run_a16, 20, flush)
            out["a16_app_dtype"] = str(run_a16()[1].dtype)
            out["a16_ms"]["fused+cast"] = cs._time_ms(
                lambda: ff.factor_features(xn, planes, lines, nd, dtype=bf)[1].to(bf), 20, flush)
        del feats

    if "a1" in kernels:
        # kernel A': phase 3's layouts with random gradients, then one train
        # step's own gradients
        layouts = cs._bwd_layouts(field, aabb, rays, gen)
        n = cs.N_RAYS_TRAIN * cs.K_TRAIN
        na = sum(p.shape[2] - d for p, d in zip(planes, nd))
        d_sig = torch.randn(n, generator=gen, device=dev)
        d_app = torch.randn(n, na, generator=gen, device=dev)
        cases = {k: (x, planes, lines, d_sig, d_app) for k, x in layouts.items()}
        out["inputs"] += [float(x.sum()) for x in layouts.values()] + [float(d_app.sum())]
        cases["step"] = _step_gradients(cs, syn, ff, dev)
        out["bwd_ms"], out["bwd_err"] = {}, {}
        for k, (x, p, l, ds, da) in cases.items():
            got = ff.factor_features_backward(x, p, l, nd, ds, da)
            ref = ff.factor_features_backward_plain(x, p, l, nd, ds, da)
            out["bwd_err"][k] = max(float((g - r).abs().max()) / float(r.abs().max())
                                    for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])))
            del got, ref
            out["bwd_ms"][k] = cs._time_ms(
                lambda: ff.factor_features_backward(x, p, l, nd, ds, da), 20, flush)
        x, _, _, ds, da = cases["step"]
        out["step_zero_share"] = float(((ds == 0) & (da == 0).all(1)).float().mean())
        out["step_samples"] = x.shape[0]
        del cases, layouts

    if "a1_16" in kernels:
        # kernel A' in bf16 on phase 3's layouts, d_app_raw in the dtype this
        # version's kernel A hands autograd
        layouts = cs._bwd_layouts(field, aabb, rays, gen)
        n = cs.N_RAYS_TRAIN * cs.K_TRAIN
        na = sum(p.shape[2] - d for p, d in zip(planes, nd))
        app_dtype = ff.factor_features(layouts["coherent"][:32], planes, lines, nd, sigma=False,
                                       dtype=bf)[1].dtype
        d_sig = torch.randn(n, generator=gen, device=dev)
        d_app = torch.randn(n, na, generator=gen, device=dev).to(bf)
        out["inputs"] += [float(x.sum()) for x in layouts.values()] + [float(d_app.sum())]
        d_app = d_app.to(app_dtype)
        out["bwd16_ms"], out["bwd16_err"] = {}, {}
        for k, x in layouts.items():
            got = ff.factor_features_backward(x, planes, lines, nd, d_sig, d_app, dtype=bf)
            ref = ff.factor_features_backward_plain(x, planes, lines, nd, d_sig, d_app, bf)
            out["bwd16_err"][k] = max(float((g - r).abs().max()) / float(r.abs().max())
                                      for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])))
            del got, ref
            out["bwd16_ms"][k] = cs._time_ms(
                lambda: ff.factor_features_backward(x, planes, lines, nd, d_sig, d_app,
                                                    dtype=bf), 20, flush)
        out["bwd16_d_app_dtype"] = str(app_dtype)
        del layouts

    if "cp" in kernels:
        out.update(_time_cp(cs, field, aabb, rays, gen, flush, out["inputs"]))
    if cp_step:
        out["cp_step"] = _cp_step_profile(cs, dev)
    return out


def _ptxas(log: str) -> dict:
    """{kernel and template arguments: [registers, spill store bytes]} of
    the CP kernels in an nvcc log of this process's build (empty when the
    library was built before)."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d(cp_features\w*?_kernel)I(\w*?)EEv", line)
        if m:
            args = re.findall(r"L[bi](\d+)", m.group(2))
            name = f"{m.group(1)}<{','.join(args)}>"
            res[name] = [0, 0]
        elif name and "spill stores" in line:
            res[name][1] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "registers" in line:
            res[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return res


def _time_cp(cs, shell, aabb, rays, gen, flush, inputs) -> dict:
    """Kernels C and C' at chip_smoke.py phase 3's three shapes, each in
    its own output mode, fp32 and bf16: C's bit-equality with its plain
    version, C''s largest error relative to each line's largest gradient,
    and the times (keys "C", "C'", "C bf16", "C' bf16")."""
    import torch
    from text2nerf_tpu_torch.ops.kernels import cp_features as cpk

    bf = torch.bfloat16
    field = cs._cp_field(rays.device, gen)
    lines, nd = tuple(field.lines), cs.CP_WIDTHS[0]
    na = lines[0].shape[1] - nd
    shapes = cs._cp_shapes(field, shell, aabb, rays, gen)
    app_dtype = cpk.cp_features(shapes["fused"][:32], lines, nd, sigma=False, dtype=bf)[1].dtype
    res = {"cp_ms": {}, "cp_exact": {}, "cp_bwd_err": {}, "cp_app_dtype": str(app_dtype)}
    for shape, xn in shapes.items():
        sig, app = cs.CP_SHAPE_MODES[shape]
        d_sig, d_app = cs._cp_grads(xn, na, gen, shape)
        inputs += [float(xn.sum()), float(d_sig.sum()), float(d_app.sum())]
        times = res["cp_ms"][shape] = {}
        for tag, dtype, d_app_t in (("", None, d_app), (" bf16", bf, d_app.to(bf).to(app_dtype))):
            ds, da = (d_sig if sig else None), (d_app_t if app else None)
            got = cpk.cp_features(xn, lines, nd, sigma=sig, app=app, dtype=dtype)
            ref = cs._cp_plain(xn, lines, nd, sig, app, dtype)
            res["cp_exact"][f"C{tag} {shape}"] = all(
                torch.equal(g.float(), r.float()) for g, r in zip(got, ref) if g is not None)
            got = cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype)
            ref = cs._cp_plain_backward(xn, lines, nd, ds, da, dtype)
            res["cp_bwd_err"][f"C'{tag} {shape}"] = max(
                float((g - r).abs().max()) / float(r.abs().max()) for g, r in zip(got, ref))
            del got, ref
            times["C" + tag] = cs._time_ms(
                lambda: cpk.cp_features(xn, lines, nd, sigma=sig, app=app, dtype=dtype), 20,
                flush)
            times["C'" + tag] = cs._time_ms(
                lambda: cpk.cp_features_backward(xn, lines, nd, ds, da, dtype=dtype), 20, flush)
        del d_sig, d_app
    return res


def _profile_train():
    """This checkout's text2nerf_tpu_torch/profile_train.py (its layer rules
    know kernels C and C'), loaded from its file whatever package is
    imported."""
    spec = importlib.util.spec_from_file_location(
        "t2n_profile_rules", REPO / PKG / "profile_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: profile_train layer -> the split of a TensorCP step's device time
CP_STEP_PARTS = (("kernel C'", "C'"), ("kernel C:", "C"), ("head", "MLP_Fea head"),
                 ("topk", "topk"))


def _cp_step_profile(cs, dev, steps: int = 5) -> dict:
    """Device ms per TensorCP dense step (chip_smoke.py phase 11's TensorCP
    configuration on phase 5's room-shell targets), split by CP_STEP_PARTS
    and the rest; the wall per step and the device's busy ms."""
    import torch
    from torch.autograd import DeviceType

    from text2nerf_tpu_torch.engine import train_step as ts

    rules = _profile_train()
    field, aabb, cfg, kw, (rays, rgb, depth) = cs._cp_step_setup(dev, str(VARIANTS_DIR))
    state, opt = ts.make_train_state(field, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
    step = ts.make_train_step(cfg.model, opt, device=dev, **kw)
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)

    def one(state):
        ids = torch.as_tensor(sampler.next_ids(), device=dev)
        batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
        return step(state, aabb, batch, gen)  # no mask: the dense branch

    for _ in range(3):
        state, _ = one(state)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = one(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    layers, _ = rules.device_time_by_layer(events)
    busy_us = sum(e.time_range.end - e.time_range.start for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and not e.name.startswith(("t2n.", "Optimizer.")))
    split = {part: 0.0 for _, part in CP_STEP_PARTS}
    split["rest"] = busy_us - sum(layers.values())  # kernels linked to no op
    for layer, us in layers.items():
        part = next((p for frag, p in CP_STEP_PARTS if layer.startswith(frag)), "rest")
        split[part] += us
    return {"wall_ms": wall / steps * 1e3, "busy_ms": busy_us / steps / 1e3,
            "ms": {k: v / steps / 1e3 for k, v in split.items()}, "samples": kw["n_samples"],
            "app_k": kw["app_k"], "microbatch": kw["microbatch"]}


def _step_gradients(cs, syn, ff, dev):
    """(xn, planes, lines, d_sigma, d_app_raw) that kernel A' gets in one
    compacted train step of chip_smoke.py's phase 5 (its training
    configuration and step settings, after its warm-up steps), caught on
    the way from FactorFeatures.backward into the kernel's wrapper."""
    import torch
    from text2nerf_tpu_torch.engine import train_step as ts

    rays, rgb, depth = syn.training_targets(dev)
    field, aabb, mask, cfg, kw = syn.training_setup(dev)
    state, opt = ts.make_train_state(field, cfg.lr_init, cfg.lr_basis, runtime_decay=True)
    step = ts.make_train_step(field.cfg, opt, device=dev, **kw)
    sampler = ts.PermutationSampler(rays.shape[0], cfg.batch_size, seed=cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(0)
    caught = []
    wrapped = ff.factor_features_backward

    def catch(xn, planes, lines, nd, d_sigma=None, d_app_raw=None, **kwargs):
        caught.append((xn, planes, lines, d_sigma, d_app_raw))
        return wrapped(xn, planes, lines, nd, d_sigma, d_app_raw, **kwargs)

    try:
        for i in range(cs.TRAIN_WARMUP + 1):
            ff.factor_features_backward = catch if i == cs.TRAIN_WARMUP else wrapped
            ids = torch.as_tensor(sampler.next_ids(), device=dev)
            batch = {"rays": rays[ids], "rgb": rgb[ids], "depth": depth[ids]}
            state, _ = step(state, aabb, batch, gen, alpha_mask=mask)
    finally:
        ff.factor_features_backward = wrapped
    if len(caught) != 1 or caught[0][3] is None or caught[0][4] is None:
        raise RuntimeError(f"the compacted step made {len(caught)} kernel A' calls, not one "
                           "fused call")
    xn, planes, lines, d_sigma, d_app = caught[0]
    return (xn, tuple(t.detach().clone() for t in planes),
            tuple(t.detach().clone() for t in lines), d_sigma, d_app)


KERNELS = ("a", "b", "a1", "a16", "a1_16", "cp")


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        kernels = set(argv[3].split(","))
        print(json.dumps(_time_version(argv[1], Path(argv[2]), kernels, argv[4] == "1")),
              flush=True)
        return 0
    kernels, cp_step = set(KERNELS), False
    while argv and argv[0].startswith("--"):
        if argv[0] == "--kernels" and len(argv) > 1:
            kernels = set(argv[1].split(","))
            argv = argv[2:]
        elif argv[0] == "--cp-step":
            cp_step, argv = True, argv[1:]
        else:
            print(f"kernel_variants: unknown option {argv[0]}", file=sys.stderr)
            return 2
    if not kernels or not kernels <= set(KERNELS):
        print(f"kernel_variants: --kernels takes a subset of {','.join(KERNELS)}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    card = _chip_smoke()._card_line()
    print(card, flush=True)
    setup = time.perf_counter()
    versions = [("this checkout", REPO)] + [
        (name, materialise(name, base, pairs)) for name, base, pairs in map(parse, argv)]
    order = versions + versions[::-1]
    inputs = None
    runs = []
    for i, (name, root) in enumerate(order):
        out = subprocess.run([sys.executable, __file__, "--time", name, str(root),
                              ",".join(sorted(kernels)), "1" if cp_step else "0"],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"{name}: exit code {out.returncode}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        if inputs is not None and r["inputs"] != inputs:
            raise RuntimeError(f"{name}: its package made other inputs {r['inputs']} "
                               f"than {inputs}")
        inputs = r["inputs"]
        r["run"] = 0 if i < len(versions) else 1
        runs.append(r)
        run = r["run"]
        if "a_ms" in r:
            print(f"A {name}, run {run}: {r['a_ms']:.4f} ms, bit-exact {r['a_exact']}",
                  flush=True)
        if "b_ms" in r:
            print(f"B {name}, run {run}: {r['b_ms']:.4f} ms, max_abs_err {r['b_err']:.3e}",
                  flush=True)
        if "a16_ms" in r:
            times = ", ".join(f"{k} {v:.4f} ms" for k, v in r["a16_ms"].items())
            print(f"A bf16 {name}, run {run}: {times}; bit-exact {r['a16_exact']}, app_raw "
                  f"{r['a16_app_dtype']}", flush=True)
        if "bwd16_ms" in r:
            times = ", ".join(f"{k} {v:.4f} ms" for k, v in r["bwd16_ms"].items())
            print(f"A' bf16 {name}, run {run}: {times}; within "
                  f"{max(r['bwd16_err'].values()):.3e} of each table's largest, d_app_raw "
                  f"{r['bwd16_d_app_dtype']}", flush=True)
        if "bwd_ms" in r:
            times = ", ".join(f"{k} {v:.4f} ms" for k, v in r["bwd_ms"].items())
            print(f"A' {name}, run {run}: {times}; within {max(r['bwd_err'].values()):.3e} of "
                  f"each table's largest", flush=True)
        if r["ptxas"] and run == 0:
            print(f"ptxas {name}, fp32 kernels: " + ", ".join(
                f"{k} {v[0]} registers {v[1]} B spilled" for k, v in r["ptxas"].items()
                if k.split("<")[1].startswith("0")), flush=True)
        if "cp_ms" in r:
            for k in ("C", "C'", "C bf16", "C' bf16"):
                times = ", ".join(f"{shape} {v[k]:.4f} ms" for shape, v in r["cp_ms"].items())
                if k.startswith("C'"):
                    worst = max(v for key, v in r["cp_bwd_err"].items()
                                if key.rsplit(" ", 1)[0] == k)
                    check = f"within {worst:.3e} of each line's largest"
                else:
                    check = "bit-exact " + str(all(v for key, v in r["cp_exact"].items()
                                                   if key.rsplit(" ", 1)[0] == k))
                print(f"{k} {name}, run {run}: {times}; {check}", flush=True)
            print(f"C bf16 {name}: app_raw {r['cp_app_dtype']}", flush=True)
        if "cp_step" in r:
            p = r["cp_step"]
            split = ", ".join(f"{k} {v:.3f}" for k, v in p["ms"].items())
            print(f"TensorCP dense step {name}, run {run}: {p['wall_ms']:.2f} ms wall, "
                  f"{p['busy_ms']:.2f} ms busy ({p['samples']} samples a ray, app_k "
                  f"{p['app_k']}, {p['microbatch']} sub-batch): {split} ms", flush=True)
    if "step_samples" in r:
        print(f"train step's kernel A' input: {r['step_samples']} samples, "
              f"{r['step_zero_share']:.4f} of them with all-zero gradients", flush=True)
    print(f"{time.perf_counter() - setup:.0f} s in all", flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
