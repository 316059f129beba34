"""The port's CLIP towers, tokenizers, ranker and service registry against
the JAX package, on the CPU.  Inputs come from a numpy seed, the flax
parameters reach the port through the bridge (``services/weights.py``).
Tolerances, relative to the largest |value| of the JAX output unless said
otherwise (the worst seen in brackets):

- the text tower (tiny, quick gelu and exact gelu, the last and the
  penultimate layer exposed) and the vision tower (tiny), fp32: 1e-5;
- ``hash_tokenize``: equal ids (Python's ``hash`` is salted per process:
  equal inside one process); the BPE tokenizer on a vocabulary and merges
  written here: equal ids;
- ``cosine_scores``: 1e-6; ``make_clip_ranker`` at ViT-B/32 width, both
  packages loading one converted npz: scores within 1e-3 absolute (scores
  are 100 · cosine; the preprocessing differs by float rounding) and the
  same argmax;
- ``preprocess`` against ``cv2.resize(INTER_CUBIC)`` (skipped without
  OpenCV): 2e-5 absolute after CLIP's normalization (values up to ~2.1;
  fp32 sums in another order);
- the registry: empty service entries resolve "real" and run their nets;
  ``leres`` raises; a present but unreadable checkpoint raises.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_tokenizer import PROMPTS, _tiny_vocab_files
from text2nerf_tpu.models import clip as JC
from text2nerf_tpu.models.tokenizer import CLIPBPETokenizer as JTok
from text2nerf_tpu.services import clip_rank as JCR
from text2nerf_tpu.services import weight_convert as JWC
from text2nerf_tpu_torch.models import clip as PC
from text2nerf_tpu_torch.models import diffusion as PD
from text2nerf_tpu_torch.models.tokenizer import CLIPBPETokenizer as PTok
from text2nerf_tpu_torch.services import clip_rank as PCR
from text2nerf_tpu_torch.services import diffusion_service as PDS
from text2nerf_tpu_torch.services import registry as preg
from text2nerf_tpu_torch.services import weights as PW

torch.set_num_threads(2)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("quick,skip", [(True, 0), (False, 1)])
def test_text_tower_matches_jax(quick, skip):
    cfg = JC.CLIPTextConfig(**{**JC.CLIPTextConfig.tiny().__dict__, "use_quick_gelu": quick})
    tokens = np.array([[0, 5, 9, 255, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                       [0, 17, 3, 3, 40, 77, 255, 0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    net = JC.CLIPTextEncoder(cfg, skip_last_layers=skip)
    params = jax.jit(net.init)(jax.random.PRNGKey(1), tokens)["params"]
    want = jax.jit(net.apply)({"params": params}, tokens)
    pcfg = PC.CLIPTextConfig(**cfg.__dict__)
    port = PD.materialize(lambda: PC.CLIPTextEncoder(pcfg, skip), "cpu")
    port.load_state_dict(PW.clip_text_state_from_flax(params, pcfg), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long())
    for k in ("hidden", "pooled", "embeds"):
        assert got[k].shape == want[k].shape
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, (k, _rel(got[k].numpy(), want[k]))


def _vision_case():
    cfg = JC.CLIPVisionConfig.tiny()
    imgs = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    net = JC.CLIPVisionEncoder(cfg)
    params = jax.jit(net.init)(jax.random.PRNGKey(2), imgs)["params"]
    return cfg, imgs, net, params


def test_vision_tower_and_cosine_scores_match_jax():
    cfg, imgs, net, params = _vision_case()
    want = np.asarray(jax.jit(net.apply)({"params": params}, imgs)["embeds"])
    pcfg = PC.CLIPVisionConfig(**cfg.__dict__)
    port = PD.materialize(lambda: PC.CLIPVisionEncoder(pcfg), "cpu")
    port.load_state_dict(PW.clip_vision_state_from_flax(params, pcfg), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(imgs).permute(0, 3, 1, 2))["embeds"].numpy()
    assert got.shape == want.shape == (3, 32)
    assert _rel(got, want) <= 1e-5
    ws = np.asarray(JC.cosine_scores(jnp.asarray(want[:2]), jnp.asarray(want[2:]), 100.0))
    gs = PC.cosine_scores(torch.tensor(want[:2]), torch.tensor(want[2:]), 100.0).numpy()
    assert np.abs(gs - ws).max() <= 1e-6 * 100


def test_hash_tokenize_matches_jax_in_process():
    texts = ["a beautiful garden with flowers", "", "blurry, bad art, blurred, text, watermark",
             "word " * 100]
    for length, vocab in ((77, 49408), (16, 256)):
        want = np.asarray(JC.hash_tokenize(texts, length, vocab))
        got = PC.hash_tokenize(texts, length, vocab)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad", [None, "!"])
def test_bpe_tokenizer_matches_jax(tmp_path, pad):
    _tiny_vocab_files(tmp_path, pad_token=pad)
    jt, pt = JTok.from_dir(str(tmp_path)), PTok.from_dir(str(tmp_path))
    assert pt.pad_id == jt.pad_id and PTok.from_dir(str(tmp_path / "none")) is None
    prompts = PROMPTS + ["<|startoftext|>hello<|endoftext|>", "the  CAT\t\nhello"]
    for p in prompts:
        assert pt.encode(p) == jt.encode(p), p
    np.testing.assert_array_equal(pt(prompts, 16), jt(prompts, 16))


def test_clip_ranker_matches_jax(tmp_path):
    # ViT-B/32 at its published width, one flax init saved as the JAX
    # package's converted npz, loaded by both rankers
    net = JC.CLIPVisionEncoder(JC.CLIPVisionConfig.vit_b32())
    params = jax.jit(net.init)(jax.random.PRNGKey(5), jnp.zeros((1, 224, 224, 3)))["params"]
    JWC.save_converted(str(tmp_path / "converted.npz"), {"vision": params})
    rng = np.random.default_rng(9)
    cands = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32) for _ in range(4)]
    ref = np.clip(cands[2] + rng.normal(0, 0.05, cands[2].shape), 0, 1).astype(np.float32)
    want = np.asarray(JCR.make_clip_ranker(str(tmp_path))(cands, ref))
    ranker = PCR.make_clip_ranker(str(tmp_path), device="cpu")
    got = ranker(cands, ref)
    assert got.shape == want.shape == (4,)
    assert np.abs(got - want).max() <= 1e-3, np.abs(got - want).max()
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("shape", [(512, 512), (100, 80), (224, 224), (37, 300)])
def test_preprocess_matches_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(4).uniform(0, 1, (*shape, 3)).astype(np.float32)
    want = (cv2.resize(img, (224, 224), interpolation=cv2.INTER_CUBIC) - PCR._CLIP_MEAN) \
        / PCR._CLIP_STD
    got = PCR.preprocess([img])[0]
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-5, np.abs(got - want).max()


def test_registry_resolves_the_real_services(tmp_path, monkeypatch):
    # tiny networks for the SD pipelines (the published widths are what
    # chip_smoke.py runs on the card); the ranker at ViT-B/32
    monkeypatch.setattr(PDS, "DiffusionPipeline",
                        functools.partial(PDS.DiffusionPipeline, tiny=True, num_steps=2))
    for sub in ("stable-diffusion-2-1-base", "stable-diffusion-2-inpainting",
                "clip-vit-base-patch32"):
        (tmp_path / "w" / sub).mkdir(parents=True)
    svc = preg.default_services(weights_dir=str(tmp_path / "w"), hw=(16, 16), device="cpu")
    assert svc.resolution == {"text2img": "real", "inpaint": "real", "depth": "fallback",
                              "rank": "real", "merge": "init"}
    assert svc.text2img.pipeline.scheduler == "euler"
    assert svc.inpaint.pipeline.scheduler == "pndm" and svc.inpaint.pipeline.unet_cfg.in_channels == 9
    img = svc.text2img("a garden")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and 0 <= img.min() <= img.max() <= 1
    holes = np.zeros((16, 16), np.float32)
    holes[4:12, 4:12] = 1
    cands = svc.inpaint(img, holes, prompt="a garden", num_images=2, seed=1)
    assert len(cands) == 2 and all(c.shape == (16, 16, 3) for c in cands)
    scores = svc.rank(cands, img)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    assert svc.rank.model.cfg == PC.CLIPVisionConfig.vit_b32()

    # the depth family is not ported: raises
    (tmp_path / "w" / "leres").mkdir()
    with pytest.raises(NotImplementedError, match="leres"):
        preg.default_services(weights_dir=str(tmp_path / "w"), hw=(16, 16), device="cpu")


@pytest.mark.parametrize("sub,path,content", [
    ("stable-diffusion-2-1-base", "unet/diffusion_pytorch_model.safetensors", b"\x00" * 64),
    ("stable-diffusion-2-inpainting", "sd-v2-inpainting.ckpt", b"\x00" * 64),
    ("clip-vit-base-patch32", "pytorch_model.bin", b"not a checkpoint"),
    ("clip-vit-base-patch32", "flax_model.msgpack", b"\x00" * 64),
])
def test_registry_raises_on_an_unreadable_checkpoint(tmp_path, monkeypatch, sub, path, content):
    monkeypatch.setattr(PDS, "DiffusionPipeline",
                        functools.partial(PDS.DiffusionPipeline, tiny=True, num_steps=2))
    f = tmp_path / sub / path
    f.parent.mkdir(parents=True)
    f.write_bytes(content)
    if path.startswith("unet/"):
        for other in ("vae", "text_encoder"):
            (tmp_path / sub / other).mkdir()
            (tmp_path / sub / other / "diffusion_pytorch_model.safetensors").write_bytes(content)
    with pytest.raises((ValueError, RuntimeError, pickle.UnpicklingError)):
        preg.default_services(weights_dir=str(tmp_path), hw=(16, 16), device="cpu")
