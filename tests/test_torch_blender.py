"""The port's Blender-format loader (``data/blender.py``) against the JAX
package's on a tiny scene the test writes (3 frames of 24x16 RGBA PNGs
written by imageio, random camera-to-world matrices): at full size and
downsampled by 2 (INTER_AREA), the poses and intrinsics equal; the
images equal at full size and within 2.4e-7 downsampled (cv2 sums a
4-channel image's 2x2 cells in another order than the port's per-channel
INTER_AREA: one fp32 ulp below 1 on 8% of them); the rays within 2.4e-7
(the rotation is a float64 product rounded once, JAX's an fp32 one: one
ulp on 8% of them); every other field as its source (rays or images).
"""

import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest

from text2nerf_tpu.data import blender as JB
from text2nerf_tpu_torch.data import blender as PB


def _rotation(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.diag(r))


def _write_scene(root, n=3, hw=(16, 24), seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    os.makedirs(root / "train")
    for i in range(n):
        img = rng.integers(0, 256, (*hw, 4), dtype=np.uint8)
        img[..., 3] = np.where(rng.random(hw) < 0.3, 0, img[..., 3])
        imageio.imwrite(root / "train" / f"r_{i}.png", img)
        c2w = np.eye(4)
        c2w[:3, :3] = _rotation(rng)
        c2w[:3, 3] = rng.normal(0, 2, 3)
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


@pytest.mark.parametrize("downsample", [1.0, 2.0])
def test_blender_scene_matches_jax(tmp_path, downsample):
    _write_scene(tmp_path)
    want = JB.load_blender_scene(str(tmp_path), downsample=downsample)
    got = PB.load_blender_scene(str(tmp_path), downsample=downsample)
    h, w = (16, 24) if downsample == 1.0 else (8, 12)
    assert got.hw == want.hw == (h, w)
    assert got.intrinsic == want.intrinsic
    np.testing.assert_array_equal(got.poses_gen, want.poses_gen)
    img_tol = 0.0 if downsample == 1.0 else 2.4e-7
    for name in ("rgbs_gen_split", "all_rgbs"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=img_tol, err_msg=name)
    for name in ("rays_gen_split", "all_rays", "rays_support_split"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=2.4e-7, err_msg=name)
    for name in ("scene_bbox", "all_depth", "depth_gen_split", "masks_gen_split",
                 "poses_support", "render_path"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.near_far, got.white_bg) == (want.near_far, want.white_bg)
    assert got.rgbs_gen_split.shape == (3, h, w, 3)
