"""The port's diffusion models and pipelines against the JAX package, on
the CPU, at tiny size (``UNetConfig.tiny``, ``VAEConfig.tiny``,
``DiffusionPipeline(tiny=True)``).  Inputs come from a numpy seed, JAX
runs as ``tests/conftest.py`` sets it up (CPU, matmul precision
``highest``), and the flax parameters reach the port through the bridge
(``services/weights.py``).  Each check states its tolerance, relative to
the largest |value| of the JAX output unless said otherwise (the worst
seen in brackets):

- ``timestep_embedding``: 2.4e-7·(1 + t) absolute, two ulps of the
  argument (5.7e-5 at t = 999: XLA's exp and torch's differ by an ulp);
- the UNet (4 and 9 input channels): fp32 1e-5 (7.5e-7); bf16 3e-2 (1.4e-2:
  both sides round every op to bf16, JAX's own bf16 output is 1.2e-2 from
  its fp32 one, and the two round at different points of a fused op);
- the VAE encode and decode, fp32: 1e-5;
- the schedules: timesteps equal; sigmas, alphas_cum and the per-step
  coefficients within 3e-6 relative (1.9e-6: the fp32 cumulative product
  of 1000 factors, sequential here, associated in another order by XLA's
  reduce-window lowering); ``step_state`` over a fixed sequence of eps,
  every step, 1e-5 of the largest |x|;
- ``denoise_loop``, 3 steps at guidance 7.5, fp32, with and without the
  inpainting's extra channels, from the same latents: 1e-5;
- ``generate`` end to end (text through the hash tokenizer, the VAE
  encoder for inpainting, the loop, the decode, the clip to [0, 1]), fp32,
  latents injected: 1e-5 absolute on [0, 1] images;
- a diffusers directory written from the JAX params (the inverse of JAX's
  name maps) as ``.bin`` and as ``.safetensors``: the port's loader and
  JAX's ``convert_sd_checkpoint_dir`` give equal parameters and the UNet
  outputs agree within 1e-5; a UNet checkpoint under 99% coverage raises;
  an unreadable checkpoint raises, never becoming a random init; a VAE
  with the legacy attention names (1x1-conv shaped) loads equal;
- the scheduler: inpainting takes the class and offset of the
  checkpoint's ``scheduler_config.json`` (timesteps equal to JAX's),
  text2img runs Euler;
- the seeded random init: per tensor, the standard deviation within 15%
  of flax's init of the same tensor (tensors of ≥ 512 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.models import diffusion as JD
from text2nerf_tpu.services import diffusion_service as JDS
from text2nerf_tpu.services import weight_convert as JWC
from text2nerf_tpu_torch.models import clip as PC
from text2nerf_tpu_torch.models import diffusion as PD
from text2nerf_tpu_torch.services import diffusion_service as PDS
from text2nerf_tpu_torch.services import weights as PW

torch.set_num_threads(2)

HW = (32, 32)
STEPS = 3


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def unets():
    """JAX tiny UNets (4 and 9 channels) with their flax params, and the
    port's UNets carrying them, fp32 and bf16."""
    out = {}
    rng = np.random.default_rng(0)
    for ch in (4, 9):
        cfg = JD.UNetConfig.tiny()
        cfg = JD.UNetConfig(**{**cfg.__dict__, "in_channels": ch})
        x = rng.standard_normal((2, 16, 16, ch)).astype(np.float32)
        t = np.array([10.0, 500.5], np.float32)
        ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
        params = jax.jit(JD.UNet(cfg).init)(jax.random.PRNGKey(ch), x, t, ctx)["params"]
        pcfg = PD.UNetConfig(**cfg.__dict__)
        state = PW.unet_state_from_flax(params, pcfg)
        ports = {}
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            m = PD.materialize(lambda: PD.UNet(pcfg, dt), "cpu")
            m.load_state_dict(state, strict=True)
            ports[name] = m
        out[ch] = dict(cfg=cfg, pcfg=pcfg, params=params, x=x, t=t, ctx=ctx, port=ports)
    return out


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 499.5, 999.0], np.float32)
    want = np.asarray(JD.timestep_embedding(jnp.asarray(t), 320))
    got = PD.timestep_embedding(torch.from_numpy(t), 320).numpy()
    assert got.shape == want.shape
    # XLA's exp and torch's differ by up to an ulp, which the sin / cos
    # argument t·freq carries: two ulps of the argument
    err = np.abs(got - want).max(-1)
    assert (err <= 2.4e-7 * (1 + t)).all(), err


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("channels", [4, 9])
def test_unet_matches_jax(unets, channels, dtype):
    u = unets[channels]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    apply = jax.jit(JD.UNet(u["cfg"], dtype=jdt).apply)
    want = np.asarray(apply({"params": u["params"]}, u["x"], u["t"], u["ctx"]).astype(jnp.float32))
    with torch.no_grad():
        got = _nhwc(u["port"][dtype](_nchw(u["x"]), torch.from_numpy(u["t"]),
                                     torch.from_numpy(u["ctx"])))
    assert got.shape == want.shape == (*u["x"].shape[:3], 4)
    assert _rel(got, want) <= (1e-5 if dtype == "fp32" else 3e-2), _rel(got, want)


def test_unet_state_dict_has_the_diffusers_names(unets):
    pcfg = unets[4]["pcfg"]
    keys = set(unets[4]["port"]["fp32"].state_dict())
    assert keys <= set(PW.sd_unet_name_map(pcfg))
    for k in ("conv_in.weight", "time_embedding.linear_1.weight",
              "down_blocks.0.resnets.0.conv1.weight",
              "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight",
              "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight",
              "down_blocks.0.downsamplers.0.conv.weight", "mid_block.attentions.0.proj_in.weight",
              "up_blocks.0.resnets.1.conv_shortcut.weight", "up_blocks.0.upsamplers.0.conv.weight",
              "up_blocks.1.attentions.1.norm.weight", "conv_norm_out.weight"):
        assert k in keys, k
    # the full-width UNet's parameter count: SD 2's 865.9M (with 9 input
    # channels the first conv adds 5·320·9 weights)
    with torch.device("meta"):
        n = sum(p.numel() for p in PD.UNet(PD.UNetConfig.sd21_base()).parameters())
    assert n == 865_910_724, n


def test_vae_matches_jax():
    cfg = JD.VAEConfig.tiny()
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    enc, dec = JD.VAEEncoder(cfg), JD.VAEDecoder(cfg)
    pe = jax.jit(enc.init)(jax.random.PRNGKey(3), img)["params"]
    pd = jax.jit(dec.init)(jax.random.PRNGKey(4), z)["params"]
    want_m = np.asarray(jax.jit(enc.apply)({"params": pe}, img))
    want_x = np.asarray(jax.jit(dec.apply)({"params": pd}, z))
    pcfg = PD.VAEConfig(**cfg.__dict__)
    vae = PD.materialize(lambda: PD.AutoencoderKL(pcfg), "cpu")
    vae.load_state_dict(PW.vae_state_from_flax(pe, pd, pcfg), strict=True)
    with torch.no_grad():
        got_m, got_x = _nhwc(vae.encode(_nchw(img))), _nhwc(vae.decode(_nchw(z)))
    assert got_m.shape == want_m.shape == (2, 8, 8, 8) and got_x.shape == want_x.shape
    assert _rel(got_m, want_m) <= 1e-5 and _rel(got_x, want_x) <= 1e-5


def _run_steps(sched, state0, eps_seq, x0, step, to_x):
    x, state = x0, state0
    xs = []
    for i, eps in enumerate(eps_seq):
        x, state = step(eps, i, x, state)
        xs.append(to_x(x))
    return np.stack(xs)


@pytest.mark.parametrize("name", ["euler", "ddim", "pndm"])
def test_schedules_match_jax(name):
    cls = {"euler": "EulerSchedule", "ddim": "DDIMSchedule", "pndm": "PNDMSchedule"}[name]
    offset = {"euler": 0, "ddim": 0, "pndm": 1}[name]
    js = getattr(JD, cls).create(50, steps_offset=offset)
    ps = getattr(PD, cls).create(50, steps_offset=offset)
    np.testing.assert_array_equal(np.asarray(ps.timesteps), np.asarray(js.timesteps))
    assert len(ps.timesteps) == (51 if name == "pndm" else 50)
    if name == "euler":
        assert np.abs(ps.sigmas[:-1] / np.asarray(js.sigmas)[:-1] - 1).max() <= 3e-6
        assert ps.sigmas[-1] == 0 and abs(ps.init_noise_sigma / float(js.init_noise_sigma) - 1) <= 3e-6
    else:
        assert np.abs(ps.alphas_cum / np.asarray(js.alphas_cum) - 1).max() <= 3e-6
    if name == "pndm":
        for k in ("t_eff", "t_prev", "coeffs", "push", "use_saved", "save"):
            np.testing.assert_array_equal(np.asarray(getattr(ps, k), np.float32),
                                          np.asarray(getattr(js, k), np.float32))
    # step_state over a fixed eps sequence: every step's x
    rng = np.random.default_rng(7)
    n = len(ps.timesteps)
    eps_seq = rng.standard_normal((n, 2, 3, 4, 4)).astype(np.float32)
    x0 = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    jstep = jax.jit(js.step_state, static_argnums=())
    want = _run_steps(js, js.init_state(jnp.asarray(x0)), [jnp.asarray(e) for e in eps_seq],
                      jnp.asarray(x0), jstep, np.asarray)
    got = _run_steps(ps, ps.init_state(torch.from_numpy(x0)),
                     [torch.from_numpy(e) for e in eps_seq], torch.from_numpy(x0),
                     ps.step_state, lambda t: t.numpy())
    for i in range(n):
        assert _rel(got[i], want[i]) <= 1e-5, (i, _rel(got[i], want[i]))


@pytest.mark.parametrize("extra", [False, True])
def test_denoise_loop_matches_jax(unets, extra):
    u = unets[9 if extra else 4]
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx_c = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ctx_u = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ex = rng.standard_normal((16, 16, 5)).astype(np.float32) if extra else None
    js = (JD.PNDMSchedule if extra else JD.EulerSchedule).create(STEPS)
    ps = (PD.PNDMSchedule if extra else PD.EulerSchedule).create(STEPS)

    @jax.jit
    def loop(params, lat, c, uc, ex):
        return JD.denoise_loop(JD.UNet(u["cfg"]), params, js, lat, c, uc, 7.5, extra_channels=ex)

    want = np.asarray(loop(u["params"], lat, ctx_c, ctx_u, ex))
    got = _nhwc(PD.denoise_loop(u["port"]["fp32"], ps, _nchw(lat), torch.from_numpy(ctx_c),
                                torch.from_numpy(ctx_u), 7.5,
                                None if ex is None else _nchw(ex[None])))
    assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """The JAX package's tiny pipelines (fp32, 3 steps) and the port's,
    loaded from the JAX params through a converted npz."""
    out = {}
    for inpaint in (False, True):
        jp = JDS.DiffusionPipeline("", inpaint=inpaint, hw=HW, tiny=True, num_steps=STEPS,
                                   dtype=jnp.float32)
        d = tmp_path_factory.mktemp("inpaint" if inpaint else "text2img")
        JWC.save_converted(str(d / "converted.npz"), jp.params)
        pp = PDS.DiffusionPipeline(str(d), inpaint=inpaint, hw=HW, tiny=True, num_steps=STEPS,
                                   dtype=torch.float32, device="cpu")
        out[inpaint] = (jp, pp)
    return out


@pytest.mark.parametrize("inpaint", [False, True])
def test_generate_matches_jax(pipes, inpaint):
    jp, pp = pipes[inpaint]
    assert pp.scheduler == ("pndm" if inpaint else "euler") == jp.scheduler
    kw = {}
    if inpaint:
        rng = np.random.default_rng(5)
        mask = np.zeros(HW, np.float32)
        mask[6:22, 10:30] = 1.0
        kw = dict(init_image=rng.uniform(0, 1, (*HW, 3)).astype(np.float32), mask_holes=mask)
    want = jp.generate("a garden with flowers", "blurry", num_images=2, seed=5, **kw)
    f = jp.latent_factor
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, HW[0] // f, HW[1] // f, 4),
                                       jnp.float32))
    got = pp.generate("a garden with flowers", "blurry", num_images=2, seed=5,
                      latents=_nchw(lat), **kw)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (*HW, 3) and g.dtype == np.float32
        assert np.abs(g - w).max() <= 1e-5, np.abs(g - w).max()
        assert g.min() >= 0 and g.max() <= 1
    # the seeded draw: a stream of its own, the same for the same seed
    a = pp.generate("p", num_images=1, seed=3, **kw)[0]
    assert np.array_equal(a, pp.generate("p", num_images=1, seed=3, **kw)[0])


def _write_diffusers_dir(root, params, pipe, fmt):
    """A diffusers-layout directory from the JAX params, through the
    inverse of the JAX package's name maps."""
    from safetensors.torch import save_file

    def inverse(tree, name_map):
        flat = PW._flat(tree)
        state = {}
        for tname, fpath in name_map.items():
            raw = fpath.startswith("raw:")
            fpath = fpath.split(":", 1)[-1]
            if fpath not in flat or tname in state or any(
                    s in tname for s in (".query.", ".key.", ".value.", ".proj_attn.")):
                continue
            a = flat[fpath]
            if not raw and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif not raw and a.ndim == 2:
                a = a.T
            state[tname] = torch.from_numpy(np.array(a, order="C"))
        return state

    states = {
        "unet": inverse(params["unet"], JWC.sd_unet_name_map(pipe.unet_cfg)),
        "vae": {**inverse(params["vae_encoder"], JWC.sd_vae_encoder_name_map(pipe.vae_cfg)),
                **inverse(params["vae_decoder"], JWC.sd_vae_decoder_name_map(pipe.vae_cfg))},
        "text_encoder": inverse(params["text"], JWC.clip_text_name_map(pipe.text_cfg.layers)),
    }
    for sub, state in states.items():
        (root / sub).mkdir()
        if fmt == "bin":
            name = "pytorch_model.bin" if sub == "text_encoder" else "diffusion_pytorch_model.bin"
            torch.save(state, root / sub / name)
        else:
            name = ("model" if sub == "text_encoder" else "diffusion_pytorch_model") + ".safetensors"
            save_file(state, str(root / sub / name))
    return states


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_diffusers_checkpoint_loads_as_jax_converts_it(pipes, tmp_path, fmt):
    jp0, _ = pipes[True]
    states = _write_diffusers_dir(tmp_path, jp0.params, jp0, fmt)
    jp = JDS.DiffusionPipeline(str(tmp_path), inpaint=True, hw=HW, tiny=True, num_steps=STEPS,
                               dtype=jnp.float32)
    pp = PDS.DiffusionPipeline(str(tmp_path), inpaint=True, hw=HW, tiny=True, num_steps=STEPS,
                               dtype=torch.float32, device="cpu")
    # equal parameters: the port's loaded state and JAX's converted tree
    # carried across the bridge
    for got, want in ((pp.unet.state_dict(), PW.unet_state_from_flax(jp.params["unet"],
                                                                     pp.unet_cfg)),
                      (pp.vae.state_dict(), PW.vae_state_from_flax(
                          jp.params["vae_encoder"], jp.params["vae_decoder"], pp.vae_cfg)),
                      (pp.text.state_dict(), PW.clip_text_state_from_flax(jp.params["text"],
                                                                          pp.text_cfg))):
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
    # the same UNet output
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 16, 16, 9)).astype(np.float32)
    t = np.array([321.0], np.float32)
    ctx = rng.standard_normal((1, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jp.unet.apply)({"params": jp.params["unet"]}, x, t, ctx))
    with torch.no_grad():
        got = _nhwc(pp.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)))
    assert _rel(got, want) <= 1e-5
    # under 99% coverage raises, in both packages
    unet_file = next((tmp_path / "unet").iterdir())
    state = dict(states["unet"])
    for k in sorted(state)[::20]:
        del state[k]
    unet_file.unlink()
    torch.save(state, tmp_path / "unet" / "diffusion_pytorch_model.bin")
    for make in (lambda: JDS.DiffusionPipeline(str(tmp_path), inpaint=True, hw=HW, tiny=True,
                                               dtype=jnp.float32),
                 lambda: PDS.DiffusionPipeline(str(tmp_path), inpaint=True, hw=HW, tiny=True,
                                               device="cpu")):
        with pytest.raises(ValueError, match="SD UNet checkpoint layout mismatch"):
            make()


def test_unreadable_checkpoints_raise(tmp_path):
    # a checkpoint the port cannot parse, and one it does not read
    for sub in ("unet", "vae", "text_encoder"):
        (tmp_path / "a" / sub).mkdir(parents=True)
        (tmp_path / "a" / sub / "diffusion_pytorch_model.safetensors").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="safetensors"):
        PDS.DiffusionPipeline(str(tmp_path / "a"), tiny=True, hw=HW, device="cpu")
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "v2-1_512-ema-pruned.ckpt").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="cannot read"):
        PDS.DiffusionPipeline(str(tmp_path / "b"), tiny=True, hw=HW, device="cpu")
    # an empty directory (and an absent one) takes the seeded init
    (tmp_path / "c").mkdir()
    p = PDS.DiffusionPipeline(str(tmp_path / "c"), tiny=True, hw=HW, device="cpu")
    q = PDS.DiffusionPipeline(str(tmp_path / "none"), tiny=True, hw=HW, device="cpu")
    for a, b in zip(p.unet.parameters(), q.unet.parameters()):
        assert torch.equal(a, b)


def test_seeded_init_has_flax_statistics(pipes):
    jp, pp = pipes[False]
    gen = torch.Generator().manual_seed(0)
    unet = PD.materialize(lambda: PD.UNet(pp.unet_cfg), "cpu", gen)
    text = PD.materialize(lambda: PC.CLIPTextEncoder(pp.text_cfg), "cpu", gen)
    checked = 0
    for module, tree, name_map in (
            (unet, jp.params["unet"], PW.sd_unet_name_map(pp.unet_cfg)),
            (text, jp.params["text"], PW.clip_text_name_map(pp.text_cfg.layers))):
        flat = PW._flat(tree)
        for k, v in module.state_dict().items():
            want = np.asarray(flat[name_map[k].split(":", 1)[-1]])
            if want.size >= 512 and want.std() > 0:
                assert abs(float(v.std()) / float(want.std()) - 1) <= 0.15, k
                checked += 1
            elif want.std() == 0:
                assert torch.equal(v, torch.full_like(v, float(want.flat[0]))), k
    assert checked > 20


def test_legacy_vae_attention_names_load(pipes, tmp_path):
    # older VAE checkpoints name the mid attention query / key / value /
    # proj_attn and store its projections as 1x1 convs: the same weights
    jp0, pp0 = pipes[True]
    states = _write_diffusers_dir(tmp_path, jp0.params, jp0, "bin")
    legacy = {}
    for k, v in states["vae"].items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                v = v[..., None, None] if v.ndim == 2 else v
        legacy[k] = v
    assert any(".proj_attn.weight" in k for k in legacy)
    torch.save(legacy, tmp_path / "vae" / "diffusion_pytorch_model.bin")
    pp = PDS.DiffusionPipeline(str(tmp_path), inpaint=True, hw=HW, tiny=True, num_steps=STEPS,
                               dtype=torch.float32, device="cpu")
    want = PW.vae_state_from_flax(jp0.params["vae_encoder"], jp0.params["vae_decoder"],
                                  pp.vae_cfg)
    got = pp.vae.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("cls,name", [("DDIMScheduler", "ddim"), ("PNDMScheduler", "pndm"),
                                      ("EulerDiscreteScheduler", "euler")])
def test_scheduler_from_the_checkpoint_config(tmp_path, cls, name):
    # inpainting runs the checkpoint's scheduler class and offset; text2img
    # runs Euler whatever the checkpoint ships
    import json

    (tmp_path / "scheduler").mkdir()
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": cls, "num_train_timesteps": 1000, "beta_start": 0.00085,
         "beta_end": 0.012, "steps_offset": 1}))
    pp = PDS.DiffusionPipeline(str(tmp_path), inpaint=True, hw=HW, tiny=True, num_steps=10,
                               device="cpu")
    assert pp.scheduler == name
    sched = getattr(JD, {"ddim": "DDIMSchedule", "pndm": "PNDMSchedule",
                         "euler": "EulerSchedule"}[name]).create(10, steps_offset=1)
    np.testing.assert_array_equal(np.asarray(pp._make_schedule().timesteps),
                                  np.asarray(sched.timesteps))
    assert PDS.DiffusionPipeline(str(tmp_path), hw=HW, tiny=True, device="cpu").scheduler \
        == "euler"
