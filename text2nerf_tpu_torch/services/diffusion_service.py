"""Stable Diffusion 2 text2img and inpainting pipelines (port of
``text2nerf_tpu/services/diffusion_service.py``).

A :class:`DiffusionPipeline` holds the UNet, the VAE and the text tower on
one device and runs the whole sampler there: the prompt through the text
tower, the guided denoise loop (Euler for text2img, the checkpoint's PNDM
for inpainting, 50 steps, guidance 7.5), the VAE decode.  Its weights
come from, in order:

1. a converted ``.npz`` of the JAX package (``converted.npz`` in the
   directory), through the bridge in :mod:`.weights`;
2. a diffusers directory (``unet/``, ``vae/``, ``text_encoder/``, and
   ``tokenizer/`` for the BPE vocabulary), each checkpoint held to the
   ≥ 99% coverage check;
3. a seeded random init at the published widths when the directory holds
   no checkpoint at all.

A checkpoint file the port cannot read raises; it never becomes a random
init.  Compute is bf16 as flax's ``dtype=`` (parameters fp32, norms and
softmax in fp32); the scheduler's arithmetic is fp32.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..models import clip as C
from ..models import diffusion as D
from ..models.tokenizer import CLIPBPETokenizer
from . import weights as W
from .merge import nearest_resize

_SCHEDULERS = {"PNDMScheduler": "pndm", "EulerDiscreteScheduler": "euler",
               "DDIMScheduler": "ddim"}


class DiffusionPipeline:
    """The machinery text2img and inpainting share."""

    def __init__(self, weights_path: str, inpaint: bool = False, hw=(512, 512),
                 dtype=torch.bfloat16, num_steps: Optional[int] = None, tiny: bool = False,
                 scheduler: str = "auto", device=None):
        """``scheduler`` 'auto': text2img runs Euler, inpainting the
        checkpoint's ``scheduler/scheduler_config.json`` class (PNDM when
        there is none); or 'euler' | 'pndm' | 'ddim'.  ``num_steps`` None:
        the 50 steps of the diffusers pipelines.  ``tiny``: the test-sized
        networks.  The networks live on ``device`` (cuda unless asked)."""
        self.device = resolve_device(device)
        self.hw, self.inpaint, self.tiny, self.dtype = tuple(hw), inpaint, tiny, dtype
        self.num_steps = 50 if num_steps is None else num_steps
        self.sched_cfg = self._load_scheduler_config(weights_path)
        if scheduler == "auto":
            scheduler = _SCHEDULERS.get((self.sched_cfg or {}).get("_class_name"), "pndm") \
                if inpaint else "euler"
        if scheduler not in ("euler", "pndm", "ddim"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.scheduler = scheduler
        if tiny:
            self.unet_cfg = D.UNetConfig(in_channels=9 if inpaint else 4, block_channels=(32, 64),
                                         layers_per_block=1, cross_attention_dim=32, head_dim=16,
                                         attn_blocks=(True, False))
            self.vae_cfg, self.text_cfg = D.VAEConfig.tiny(), C.CLIPTextConfig.tiny()
        else:
            self.unet_cfg = D.UNetConfig.sd2_inpaint() if inpaint else D.UNetConfig.sd21_base()
            self.vae_cfg, self.text_cfg = D.VAEConfig(), C.CLIPTextConfig.sd2_text()
        self.latent_factor = 2 ** (len(self.vae_cfg.block_channels) - 1)
        self.tokenizer = self._load_tokenizer(weights_path)
        self.unet, self.vae, self.text = self._load_or_init(weights_path)
        self._schedule = None

    # -- weights --------------------------------------------------------------

    @staticmethod
    def _load_scheduler_config(weights_path: str):
        """``scheduler/scheduler_config.json`` of the checkpoint directory,
        or None."""
        p = os.path.join(weights_path or "", "scheduler", "scheduler_config.json")
        if not weights_path or not os.path.isfile(p):
            return None
        try:
            with open(p, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _make_schedule(self):
        cfg = self.sched_cfg or {}
        kw = dict(n_train=int(cfg.get("num_train_timesteps", 1000)),
                  beta_start=float(cfg.get("beta_start", 0.00085)),
                  beta_end=float(cfg.get("beta_end", 0.012)))
        if self.scheduler == "pndm":
            return D.PNDMSchedule.create(self.num_steps,
                                         steps_offset=int(cfg.get("steps_offset", 1)), **kw)
        if self.scheduler == "ddim":
            return D.DDIMSchedule.create(self.num_steps,
                                         steps_offset=int(cfg.get("steps_offset", 0)), **kw)
        return D.EulerSchedule.create(self.num_steps, **kw)

    @staticmethod
    def _load_tokenizer(weights_path: str):
        """The CLIP BPE when the directory ships ``vocab.json`` and
        ``merges.txt`` (in ``tokenizer/`` or at its top), else None."""
        if not weights_path or not os.path.isdir(weights_path):
            return None
        for sub in ("tokenizer", "."):
            tok = CLIPBPETokenizer.from_dir(os.path.join(weights_path, sub))
            if tok is not None:
                return tok
        return None

    def _makers(self):
        # the SD 2 checkpoints ship the text tower cut to 23 layers with its
        # final norm: the exposed hidden state is the last one
        dt = self.dtype
        return (lambda: D.UNet(self.unet_cfg, dt), lambda: D.AutoencoderKL(self.vae_cfg, dt),
                lambda: C.CLIPTextEncoder(self.text_cfg, 0, dt))

    def _load_or_init(self, weights_path: str):
        dev = self.device
        makers = self._makers()
        tree = W.load_converted(weights_path) if weights_path else None
        if tree is not None:
            states = (W.unet_state_from_flax(tree["unet"], self.unet_cfg),
                      W.vae_state_from_flax(tree["vae_encoder"], tree["vae_decoder"],
                                            self.vae_cfg),
                      W.clip_text_state_from_flax(tree["text"], self.text_cfg))
            mods = []
            for make, state in zip(makers, states):
                m = D.materialize(make, dev)
                m.load_state_dict(state, strict=True)
                mods.append(m)
            return tuple(mods)
        if weights_path and os.path.isdir(weights_path):
            loaded = self._load_diffusers(weights_path, makers)
            if loaded is not None:
                return loaded
            found = W.checkpoint_files(weights_path)
            if found:
                raise ValueError(f"{weights_path} holds checkpoint files the port cannot read: "
                                 f"{found}")
        gen = torch.Generator(device=dev).manual_seed(0)
        return tuple(D.materialize(make, dev, gen) for make in makers)

    def _load_diffusers(self, ckpt_dir: str, makers):
        """The networks from a diffusers directory, or None when it has no
        ``unet/`` checkpoint."""
        files = [W.find_weights_file(os.path.join(ckpt_dir, sub))
                 for sub in ("unet", "vae", "text_encoder")]
        if files[0] is None:
            return None
        missing = (["text"] if files[2] is None else []) + (
            ["vae_decoder", "vae_encoder"] if files[1] is None else [])
        if missing:
            raise ValueError(f"diffusers checkpoint dir {ckpt_dir} has a unet/ but is missing "
                             f"the weights for: {sorted(missing)}")
        checks = (
            [(W.sd_unet_name_map(self.unet_cfg), "SD UNet", ("conv_shortcut",))],
            [(W.sd_vae_encoder_name_map(self.vae_cfg), "SD VAE encoder", ("conv_shortcut",)),
             (W.sd_vae_decoder_name_map(self.vae_cfg), "SD VAE decoder", ("conv_shortcut",))],
            # text_projection exists only on the WithProjection variant
            [(W.clip_text_name_map(self.text_cfg.layers), "CLIP text encoder",
              ("text_projection",))],
        )
        mods = []
        for make, path, maps in zip(makers, files, checks):
            state = W.load_torch_checkpoint(path)
            for m, what, optional in maps:
                W.require_coverage(state, m, what, path, optional)
            mods.append(W.load_state(D.materialize(make, self.device), state,
                                     [m for m, _, _ in maps]))
            del state
        return tuple(mods)

    # -- conditioning ------------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, prompt: str, negative_prompt: str = ""):
        """(cond, uncond) hidden states (1, L, cross_attention_dim)."""
        L = self.text_cfg.context_length
        if self.tokenizer is not None:
            tokens = self.tokenizer([negative_prompt, prompt], L)
        else:
            tokens = C.hash_tokenize([negative_prompt, prompt], L, self.text_cfg.vocab_size)
        hidden = self.text(torch.as_tensor(tokens, dtype=torch.long, device=self.device))["hidden"]
        cross = self.unet_cfg.cross_attention_dim
        if hidden.shape[-1] != cross:
            # only the deliberately narrow tiny configurations slice
            if not self.tiny:
                raise ValueError(f"text hidden width {hidden.shape[-1]} != UNet "
                                 f"cross_attention_dim {cross}; checkpoint/config mismatch")
            hidden = hidden[..., :cross]
        return hidden[1:2], hidden[0:1]

    # -- sampling -------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt: str, negative_prompt: str = "", num_images: int = 1,
                 guidance_scale: float = 7.5, seed: int = 0, init_image=None, mask_holes=None,
                 latents=None) -> List[np.ndarray]:
        """``num_images`` float32 (H, W, 3) images in [0, 1].  Inpainting
        takes ``init_image`` and ``mask_holes`` (> 0.5: regenerate).  The
        initial latents (num_images, 4, H/8, W/8) are ``latents`` when
        given, else drawn from ``torch.Generator(device).manual_seed(seed)``:
        a stream of its own, not JAX's ``PRNGKey(seed)``."""
        dev, (h, w), f = self.device, self.hw, self.latent_factor
        lat_c = self.vae_cfg.latent_channels
        ctx_c, ctx_u = self.encode_text(prompt, negative_prompt)
        extra = None
        if self.inpaint:
            if init_image is None or mask_holes is None:
                raise ValueError("inpainting needs init_image and mask_holes")
            img = as_tensor(init_image, dev) * 2 - 1
            m = as_tensor(mask_holes, dev)
            m = (m[..., 0] if m.ndim == 3 else m) > 0.5
            m = m.float()
            masked = (img * (1 - m)[..., None]).permute(2, 0, 1)[None]
            moments = self.vae.encode(masked)
            # scaled in the compute type, the factor rounded to it first
            z_masked = moments[:, :lat_c] * torch.tensor(self.vae_cfg.scaling_factor,
                                                         dtype=moments.dtype)
            m_lat = nearest_resize(m, (h // f, w // f))
            extra = torch.cat([m_lat[None, None], z_masked.float()], 1)
        shape = (num_images, lat_c, h // f, w // f)
        if latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=dev)
        else:
            latents = as_tensor(latents, dev)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents of shape {tuple(latents.shape)}, want {shape}")
        if self._schedule is None:
            self._schedule = self._make_schedule()
        z = D.denoise_loop(self.unet, self._schedule, latents,
                           ctx_c.expand(num_images, -1, -1), ctx_u.expand(num_images, -1, -1),
                           guidance_scale, extra)
        img = self.vae.decode(z / self.vae_cfg.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
        return [img[i] for i in range(num_images)]


def make_text2img(weights_path: str, hw=(512, 512), device=None):
    """``text2img(prompt, negative_prompt="")`` → one (H, W, 3) image; the
    pipeline is its ``pipeline`` attribute."""
    pipe = DiffusionPipeline(weights_path, inpaint=False, hw=hw, device=device)

    def text2img(prompt: str, negative_prompt: str = ""):
        return pipe.generate(prompt, negative_prompt, num_images=1)[0]

    text2img.pipeline = pipe
    return text2img


def make_inpaint(weights_path: str, hw=(512, 512), device=None):
    """``inpaint(image, mask_holes, prompt, negative_prompt, num_images,
    seed, guidance_scale)`` → candidates; the pipeline is its ``pipeline``
    attribute."""
    pipe = DiffusionPipeline(weights_path, inpaint=True, hw=hw, device=device)

    def inpaint(image, mask_holes, prompt="", negative_prompt="", num_images=5, seed=0,
                guidance_scale=7.5):
        return pipe.generate(prompt, negative_prompt, num_images=num_images,
                             guidance_scale=guidance_scale, seed=seed, init_image=image,
                             mask_holes=mask_holes)

    inpaint.pipeline = pipe
    return inpaint
