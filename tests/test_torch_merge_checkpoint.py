"""The port's merge net read from the reference's torch checkpoint, against
the JAX package's, on the CPU.

A state dict under the reference's names (``unet_generator_name_map``),
its values seeded numpy, is written with ``torch.save`` (or as
safetensors); both packages' ``DepthMergeService`` load it and run one
seeded depth through the generator at its base parameters (fp32, 64/4).
The outputs agree within 1e-5 of the largest magnitude: the same U-Net
forward in fp32 with its convolution sums in other orders (the bound of
the forward in test_torch_expansion.py).  Cases: every entry under each
file suffix the JAX package reads; one entry left out, which both
packages fill with zeros; an entry at the wrong shape, which the port
refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2nerf_tpu.services import merge as JM
from text2nerf_tpu_torch.models.pix2pix import UnetGenerator
from text2nerf_tpu_torch.services import merge as PM
from text2nerf_tpu_torch.services import weights as W

NET_SIZE, NUM_DOWNS, OUTSIZE = 64, 4, 48
TOL = 1e-5


def _reference_state(seed=0):
    """Seeded values for every entry of the reference's names, at the
    shapes of torch's layouts (the port's generator keeps them)."""
    rng = np.random.default_rng(seed)
    template = UnetGenerator(1, 1, NUM_DOWNS).state_dict()
    state = {}
    for tname, fpath in W.unet_generator_name_map(NUM_DOWNS).items():
        shape = tuple(template[W.pix2pix_key(fpath)].shape)
        state[tname] = torch.from_numpy((0.05 * rng.standard_normal(shape)).astype(np.float32))
    return state


def _save(state, path):
    if path.suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file(state, str(path))
    else:
        torch.save(state, path)


def _both(path):
    jm = JM.DepthMergeService(str(path), net_size=NET_SIZE, num_downs=NUM_DOWNS, seed=0,
                              compute_dtype=jnp.float32)
    pm = PM.DepthMergeService(str(path), net_size=NET_SIZE, num_downs=NUM_DOWNS,
                              compute_dtype=torch.float32, device="cpu")
    src = np.random.default_rng(3).uniform(-1, 1, (OUTSIZE, OUTSIZE)).astype(np.float32)
    return jm, pm, jm.run(src, outsize=OUTSIZE), pm.run(src, outsize=OUTSIZE)


def _close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("suffix", [".pth", ".pt", ".tar", ".safetensors"])
def test_merge_reads_reference_torch_checkpoint(tmp_path, suffix):
    state = _reference_state()
    path = tmp_path / f"latest_net_G{suffix}"
    _save(state, path)
    jm, pm, want, got = _both(path)
    _close(got, want)
    # the checkpoint's values, not the seeded init
    key = W.pix2pix_key(W.unet_generator_name_map(NUM_DOWNS)["model.0.weight"])
    np.testing.assert_array_equal(pm.model.state_dict()[key].numpy(),
                                  state["model.0.weight"].numpy())


def test_merge_fills_a_missing_entry_with_zeros(tmp_path):
    state = _reference_state(seed=1)
    name_map = W.unet_generator_name_map(NUM_DOWNS)
    left_out = next(t for t, f in name_map.items()
                    if f.endswith("UnetSkipBlock_1/ConvTranspose_0/bias"))
    del state[left_out]
    path = tmp_path / "latest_net_G.pth"
    torch.save({"state_dict": state}, path)
    jm, pm, want, got = _both(path)
    _close(got, want)
    assert not pm.model.state_dict()[W.pix2pix_key(name_map[left_out])].any()
    assert not np.asarray(jm.base_params["UnetSkipBlock_1"]["ConvTranspose_0"]["bias"]).any()


def test_merge_refuses_a_wrong_shape(tmp_path):
    state = _reference_state()
    state["model.0.weight"] = torch.zeros(3, 1, 4, 4)
    path = tmp_path / "latest_net_G.pth"
    torch.save(state, path)
    pm = PM.DepthMergeService(str(path), net_size=NET_SIZE, num_downs=NUM_DOWNS,
                              compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="model.0.weight"):
        pm.model
