"""The port's weights manifest (``services/weights_manifest.py``) against
the JAX package's, on trees the test writes: every family's status and
named diffs equal.

The checkpoints hold every mapped key at the shape the port's own module
gives it (its state dict built on the meta device), each tensor a
zero-stride view of one zero, so a full-width LeReS, CLIP or pix2pix
state dict is a few kilobytes.  JAX derives its expectations from its
flax trees, so a clean tree passing on both sides also holds the port's
shapes against JAX's.  Cases: the absent tree; a clean tree of every
family; one LeReS key at a wrong shape; the LeReS decoder's keys
missing; an SD tree missing a file and a checkpoint; a 4-channel UNet
where the 9-channel inpainting UNet belongs; a CLIP checkpoint with one
projection at a wrong shape.
"""

import os

import pytest
import torch

from text2nerf_tpu.services import weights_manifest as JWM
from text2nerf_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig,
                                             CLIPVisionEncoder)
from text2nerf_tpu_torch.models.leres import LeReSConfig, RelDepthModel
from text2nerf_tpu_torch.models.pix2pix import UnetGenerator
from text2nerf_tpu_torch.services import weights as W
from text2nerf_tpu_torch.services import weights_manifest as PWM


def _zeros(shape):
    return torch.zeros(()).expand(tuple(shape))


def _state(name_map, template, key_of=None):
    return {k: _zeros(s) for k, s in PWM.expected_shapes(name_map, template, key_of).items()}


def _leres_state():
    cfg = LeReSConfig.resnext101()
    return _state(W.leres_name_map(cfg), W._template(lambda: RelDepthModel(cfg)))


def _clip_state():
    v, t = CLIPVisionConfig.vit_b32(), CLIPTextConfig.vit_b32()
    return {**_state(W.clip_vision_name_map(v.layers), W._template(lambda: CLIPVisionEncoder(v))),
            **_state(W.clip_text_name_map(t.layers), W._template(lambda: CLIPTextEncoder(t)))}


def _merge_state():
    return _state(W.unet_generator_name_map(10), W._template(lambda: UnetGenerator(1, 1, 10)),
                  key_of=W.pix2pix_key)


def _sd_tree(root, family, unet_in=None, skip=()):
    d = root / family
    for f in PWM._SD_FILES:
        if f not in skip:
            os.makedirs((d / f).parent, exist_ok=True)
            (d / f).write_text("{}")
    for part, spots in PWM._SD_SPOTS[family].items():
        path = PWM._SD_CKPTS[part][1]
        if path in skip:
            continue
        state = {k: _zeros(s) for k, s in spots.items()}
        if part == "unet" and unet_in is not None:
            state["conv_in.weight"] = _zeros((320, unet_in, 3, 3))
        os.makedirs((d / path).parent, exist_ok=True)
        torch.save(state, d / path)


def _leres(root, edit=None):
    state = _leres_state()
    if edit:
        edit(state)
    torch.save({"depth_model": state}, root / "res101.pth")


def _wrong_stem(state):
    state["depth_model.encoder_modules.conv1.weight"] = _zeros((64, 4, 7, 7))


def _no_decoder(state):
    for k in [k for k in state if "decoder_modules" in k]:
        del state[k]


def _clean(root):
    _leres(root)
    os.makedirs(root / "merge_model_sc" / "checkpoints")
    torch.save(_merge_state(), root / "merge_model_sc" / "checkpoints" / "latest_net_G.pth")
    os.makedirs(root / "clip-vit-base-patch32")
    torch.save(_clip_state(), root / "clip-vit-base-patch32" / "pytorch_model.bin")
    _sd_tree(root, "stable-diffusion-2-1-base")
    _sd_tree(root, "stable-diffusion-2-inpainting")


def _bad_clip(root):
    os.makedirs(root / "clip-vit-base-patch32")
    state = _clip_state()
    state["visual_projection.weight"] = _zeros((512, 512))
    torch.save(state, root / "clip-vit-base-patch32" / "pytorch_model.bin")


CASES = {
    "absent": lambda root: None,
    "clean": _clean,
    "wrong_shape": lambda root: _leres(root, _wrong_stem),
    "missing_keys": lambda root: _leres(root, _no_decoder),
    "missing_file": lambda root: _sd_tree(root, "stable-diffusion-2-1-base",
                                          skip=("tokenizer/merges.txt",
                                                "vae/diffusion_pytorch_model.bin")),
    "unet_variant": lambda root: _sd_tree(root, "stable-diffusion-2-inpainting", unet_in=4),
    "clip_shape": _bad_clip,
}
EXPECTED = {
    "absent": {},
    "clean": {f: "ok" for f in ("stable-diffusion-2-1-base", "stable-diffusion-2-inpainting",
                                "leres", "merge_model_sc", "clip-vit-base-patch32")},
    "wrong_shape": {"leres": "error"},
    "missing_keys": {"leres": "error"},
    "missing_file": {"stable-diffusion-2-1-base": "error"},
    "unet_variant": {"stable-diffusion-2-inpainting": "error"},
    "clip_shape": {"clip-vit-base-patch32": "error"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_tree_matches_jax(tmp_path, case):
    root = tmp_path / "weights"
    if case != "absent":
        os.makedirs(root)
    CASES[case](root)
    got, want = PWM.validate_tree(str(root)), JWM.validate_tree(str(root))
    assert got == want
    statuses = {r["family"]: r["status"] for r in got}
    assert set(statuses) == set(PWM.EPS_NOTES)
    assert {f: s for f, s in statuses.items() if s != "absent"} == EXPECTED[case]
    errors = [d for r in got for d in r["diffs"]]
    if case == "wrong_shape":
        assert len(errors) == 1 and "(64, 4, 7, 7)" in errors[0] and "(64, 3, 7, 7)" in errors[0]
        assert "leres_name_map" in errors[0]
    if case == "missing_keys":
        assert len(errors) == PWM.MAX_NAMED_DIFFS + 1 and "missing key" in errors[0]
    if case == "unet_variant":
        assert any("conv_in.weight" in d and "(320, 9, 3, 3)" in d for d in errors)


def test_expected_shapes_follow_the_loaders_maps():
    # every mapped LeReS key is one of the module's entries: the shapes the
    # manifest expects are those load_leres_checkpoint copies into
    cfg = LeReSConfig.resnext101()
    name_map = W.leres_name_map(cfg)
    shapes = PWM.expected_shapes(name_map, W._template(lambda: RelDepthModel(cfg)))
    assert set(shapes) == set(name_map)
    assert shapes["depth_model.encoder_modules.conv1.weight"] == (64, 3, 7, 7)
    merge = PWM.expected_shapes(W.unet_generator_name_map(10),
                                W._template(lambda: UnetGenerator(1, 1, 10)), W.pix2pix_key)
    assert len(merge) == 40 and merge["model.0.weight"] == (64, 1, 4, 4)
    assert merge["model.3.weight"] == (128, 1, 4, 4)  # ConvTranspose2d: (in, out, kh, kw)
