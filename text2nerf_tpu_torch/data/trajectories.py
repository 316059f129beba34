"""Camera trajectories (port of ``text2nerf_tpu/data/trajectories.py``):
the local support sets, the global paths, the local test spiral, and the
reference's other pose generators (circles, rocking, pretraining,
surround).  Randomness comes in through a numpy ``Generator`` (``rng``).

Host-side numpy.  The camera looks along +z with +y up and +x right; a
pose is a 4x4 camera-to-world matrix.
"""

from __future__ import annotations

import math

import numpy as np


def normalize(x):
    """Unit-normalize along the last axis."""
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def viewmatrix(z, up, pos):
    """Look-at c2w from forward z, up hint and position."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3] = np.stack([vec0, vec1, vec2, pos], 1)
    return m


def rot_x(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_y(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rot_z(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def euler_to_rotation(theta):
    """Rz(t2) @ Ry(t1) @ Rx(t0)."""
    return rot_z(theta[2]) @ rot_y(theta[1]) @ rot_x(theta[0])


# ---------------------------------------------------------------------------
# Local pose sets (support views around a basis pose)
# ---------------------------------------------------------------------------

_DIRS8 = ("R", "UR", "U", "UL", "L", "DL", "D", "DR")


def _compass_vectors(range_center, range_yaw, range_pitch, half_vertical=False):
    v = range_center / 2 if half_vertical else range_center
    rotvecs = {
        "R": np.array([0, range_yaw, 0]),
        "L": np.array([0, -range_yaw, 0]),
        "U": np.array([range_pitch, 0, 0]),
        "D": np.array([-range_pitch, 0, 0]),
        "UR": np.array([range_pitch / 2, range_yaw / 2, 0]),
        "UL": np.array([range_pitch / 2, -range_yaw / 2, 0]),
        "DR": np.array([-range_pitch / 2, range_yaw / 2, 0]),
        "DL": np.array([-range_pitch / 2, -range_yaw / 2, 0]),
    }
    posivecs = {
        "R": np.array([range_center, 0, 0]),
        "L": np.array([-range_center, 0, 0]),
        "U": np.array([0, -v, 0]),
        "D": np.array([0, v, 0]),
        "UR": np.array([range_center, -v, 0]),
        "UL": np.array([-range_center, -v, 0]),
        "DR": np.array([range_center, v, 0]),
        "DL": np.array([-range_center, v, 0]),
    }
    return rotvecs, posivecs


def local_fixed_poses(
    c2w_basis,
    angle=0.3,
    range_center=0.2,
    range_yaw=0.6,
    range_pitch=0.3,
    use_rand=False,
    angle_rand=0.05,
    posi_rand=0.05,
    rng=None,
):
    """9 poses: the basis and 8 compass directions with yaw/pitch and
    translation (the default support-pose set)."""
    rotvecs, posivecs = _compass_vectors(range_center, range_yaw, range_pitch)
    rng = rng or np.random.default_rng(0)
    poses = [np.asarray(c2w_basis, dtype=np.float64)]
    for d in _DIRS8:
        rot = rotvecs[d] * angle / np.linalg.norm(rotvecs[d])
        posi = posivecs[d].astype(np.float64)
        if use_rand:
            rot = rot + 0.5 * angle_rand * (rng.random(3) * 2 - 1) / 180 * np.pi
            posi = posi + 0.5 * posi_rand * (rng.random(3) * 2 - 1)
        c2w = np.eye(4)
        c2w[:3, :3] = euler_to_rotation(rot) @ c2w_basis[:3, :3]
        c2w[:3, 3] = posi + c2w_basis[:3, 3]
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def local_fixed_poses_v1(
    c2w_basis, angle=0.3, range_center=0.2, range_yaw=0.6, range_pitch=0.3
):
    """Variant with halved vertical translation and R,L,U,D,... ordering
    (get_local_fixed_poses, scene_util.py:517-552)."""
    rotvecs, posivecs = _compass_vectors(
        range_center, range_yaw, range_pitch, half_vertical=True
    )
    poses = [np.asarray(c2w_basis, dtype=np.float64)]
    for d in ("R", "L", "U", "D", "UR", "UL", "DR", "DL"):
        rot = rotvecs[d] * angle / np.linalg.norm(rotvecs[d])
        c2w = np.eye(4)
        c2w[:3, :3] = euler_to_rotation(rot) @ c2w_basis[:3, :3]
        c2w[:3, 3] = posivecs[d] + c2w_basis[:3, 3]
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def local_orbit_poses(c2w_basis, range_center=0.2):
    """9 look-at poses orbiting a far pivot."""
    focal = 6.0
    up = normalize(c2w_basis[:3, 1])
    center = c2w_basis[:3, 3]
    origin = center - focal * c2w_basis[:3, 2]
    _, posivecs = _compass_vectors(range_center, 0.0, 0.0)
    poses = [np.asarray(c2w_basis, dtype=np.float64)]
    for d in _DIRS8:
        c0 = posivecs[d] + c2w_basis[:3, 3]
        z = normalize(c0 - origin)
        c = focal * z + origin
        poses.append(viewmatrix(z, up, c))
    return np.stack(poses).astype(np.float32)


def r2l_poses(c2w_basis, range_center=0.2, num_frame=None):
    """Right-to-left sweep: with ``num_frame=None`` 5 poses (basis, R, RR,
    L, LL), else an out-and-back horizontal sweep of ``num_frame`` poses."""
    poses = []
    if num_frame is None:
        poses.append(np.asarray(c2w_basis, dtype=np.float64))
        for k in (1.0, 2.0, -1.0, -2.0):
            c2w = np.eye(4)
            c2w[:3, :3] = c2w_basis[:3, :3]
            c2w[:3, 3] = np.array([k * range_center, 0, 0]) + c2w_basis[:3, 3]
            poses.append(c2w)
    else:
        half = int(num_frame / 2)
        xs = list(np.linspace(2 * range_center, -2 * range_center, half)) + list(
            np.linspace(-2 * range_center, 2 * range_center, half)
        )
        for x in xs:
            c2w = np.eye(4)
            c2w[:3, :3] = c2w_basis[:3, :3]
            c2w[:3, 3] = np.array([x, 0, 0.0]) + c2w_basis[:3, 3]
            poses.append(c2w)
    return np.stack(poses).astype(np.float32)


# ---------------------------------------------------------------------------
# Global trajectories (training pose paths)
# ---------------------------------------------------------------------------


def camera_trajectory(
    num_frames,
    traj_type="rectangle",
    random_sample=False,
    radius=0.5,
    pose_ref=None,
    for_training=False,
    rng=None,
):
    """Global camera trajectory generator.

    Supported: ``rectangle``, ``circle0``, ``circle0_<deg>``, ``circle``,
    ``circle_<deg>``, ``line_<pitch>_<yaw>_<distance>``.
    """
    rng = rng or np.random.default_rng(0)
    circle_angle = None
    if traj_type.startswith("circle0_"):
        circle_angle = float(traj_type.split("_")[-1])
        traj_type = "circle0_angle"
    elif traj_type.startswith("circle_"):
        circle_angle = float(traj_type.split("_")[-1])
        traj_type = "circle_angle"
    elif traj_type.startswith("line_"):
        parts = traj_type.split("_")
        angle_pitch, angle_yaw, line_length = (
            float(parts[1]),
            float(parts[2]),
            float(parts[-1]),
        )
        traj_type = "line_move"

    def _jitter(rot, trans):
        if not random_sample:
            return rot, trans
        ang_x = rng.integers(-3, 4) * np.pi / 180
        ang_y = rng.integers(-3, 4) * np.pi / 180
        rot = rot_y(ang_y) @ rot_x(ang_x) @ rot
        trans = trans + np.array([0.005, 0.01, 0.01]) * (rng.random(3) * 2 - 1)
        return rot, trans

    poses = []
    if traj_type == "rectangle":
        # walk the perimeter of a unit square in the xz-plane, turning 90 deg
        # at each corner over 2*num_each transition frames
        num_frames = max(num_frames, 36)
        corners = np.array(
            [[1, 0, 1], [0, 0, 1], [0, 0, 0], [1, 0, 0], [1, 0, 1]], dtype=float
        )
        num_each = int(num_frames / ((len(corners) - 1) * 3))
        for i in range(len(corners) - 1):
            start, end = corners[i], corners[i + 1]
            vec = normalize(end - start)
            dis = np.sqrt(np.sum((end - start) ** 2)) / num_each
            rot_ref = rot_y(i * np.pi / 2)
            for j in range(num_each):
                rot, trans = _jitter(rot_ref.copy(), start + vec * dis * j)
                pose = np.eye(4)
                pose[:3, :3] = rot
                pose[:3, 3] = trans
                poses.append(pose)
            ang_j = np.pi / 2 / (2 * num_each + 1)
            for j in range(2 * num_each):
                pose = np.eye(4)
                pose[:3, :3] = rot_y(ang_j * (j + 1)) @ rot_ref
                pose[:3, 3] = end
                poses.append(pose)
    elif traj_type in ("circle0", "circle0_angle"):
        # pure rotation in place about y
        frac = 1.0 if circle_angle is None else circle_angle / 360.0
        ang_i = -2 * np.pi * frac / num_frames
        for i in range(num_frames):
            rot, trans = _jitter(rot_y(ang_i * i), np.zeros(3))
            pose = np.eye(4)
            pose[:3, :3] = rot
            pose[:3, 3] = trans
            poses.append(pose)
    elif traj_type == "circle":
        # orbit of the given radius; for_training interleaves forward and
        # backward halves so consecutive training views alternate sides
        part_num = int(num_frames / 2) if for_training else num_frames
        ang_i = -2 * np.pi / part_num
        ring = []
        for i in range(part_num):
            rot = rot_y(ang_i * i)
            pose = np.eye(4)
            pose[:3, :3] = rot
            pose[:3, 3] = radius * normalize(rot[:3, 2])
            ring.append(pose)
        if for_training:
            rev = ring[::-1]
            for i in range(int(part_num / 2)):
                poses.append(ring[i])
                poses.append(rev[i])
        else:
            poses = ring
    elif traj_type == "circle_angle":
        ang_i = -2 * np.pi * (circle_angle / 360.0) / num_frames
        for i in range(num_frames):
            rot = rot_y(ang_i * i)
            trans = radius * normalize(rot[:3, 2])
            rot, trans = _jitter(rot, trans)
            pose = np.eye(4)
            pose[:3, :3] = rot
            pose[:3, 3] = trans
            poses.append(pose)
    elif traj_type == "line_move":
        if pose_ref is None:
            pose_ref = np.eye(4)
        delta = line_length / num_frames
        up = normalize(pose_ref[:3, 1])
        h_v = normalize(pose_ref[:3, 0])
        z_v = normalize(pose_ref[:3, 2])
        direction = (
            z_v * np.cos(angle_pitch / 180 * np.pi)
            + up * np.sin(angle_pitch / 180 * np.pi)
        ) * np.cos(angle_yaw / 180 * np.pi) + h_v * np.sin(angle_yaw / 180 * np.pi)
        for i in range(num_frames):
            pose = pose_ref.copy()
            pose[:3, 3] = pose_ref[:3, 3] + i * delta * direction
            poses.append(pose)
    else:
        raise ValueError(f"unknown trajectory type: {traj_type}")
    return np.stack(poses)


def double_circle_poses(c2w, n_views, random_sample=False, rng=None):
    """Two concentric look-at circles at 15/30 deg half-angle."""
    rng = rng or np.random.default_rng(0)
    focal = np.linalg.norm(c2w[:3, 3])
    if focal <= 0.01:
        focal = 0.2
    up = normalize(c2w[:3, 1])
    center = c2w[:3, 3]
    origin = center - focal * c2w[:3, 2]
    n1 = (n_views - 1) // 2
    n2 = n_views - 1 - n1
    poses = [np.asarray(c2w, dtype=np.float64)]
    for angle_h, n in ((15, n1), (30, n2)):
        alphas = np.linspace(0, 360, n + 1)[:-1]
        f_delta = (
            0.05 * focal * (rng.random(n) * 2 - 1) if random_sample else np.zeros(n)
        )
        r = focal * np.sin(angle_h / 180 * np.pi)
        b = center - focal * (1 - np.cos(angle_h / 180 * np.pi)) * normalize(
            c2w[:3, 2]
        )
        for i, alpha in enumerate(alphas):
            a = alpha / 180 * np.pi
            c = b + r * (normalize(c2w[:3, 0]) * np.cos(a) - up * np.sin(a))
            z = normalize(c - origin)
            c = c + f_delta[i] * z
            poses.append(viewmatrix(z, up, c))
    return np.stack(poses)


def circle_spiral_poses(
    c2w, n_views=100, n_r=1, angle_h_start=0.2, trans_start=0.1, use_rand=False, rng=None
):
    """Forward-shifted spiral: the local test and video path."""
    rng = rng or np.random.default_rng(0)
    up = normalize(c2w[:3, 1])
    center = c2w[:3, 3]
    center0 = c2w[:3, 3] + 0.1 * normalize(c2w[:3, 2])
    poses = []
    alphas = np.linspace(0, 360 * n_r, n_views)
    posi_rand = 0.02 * (rng.random(3) * 2 - 1) if use_rand else np.zeros(3)
    for alpha in alphas:
        a = alpha / 180 * np.pi
        c = center0 + trans_start * (
            normalize(c2w[:3, 0]) * np.cos(a) - up * np.sin(a)
        )
        z = normalize(
            normalize(c2w[:3, 2]) + normalize(c - center) * np.sin(angle_h_start)
        )
        poses.append(viewmatrix(z, up, c + posi_rand))
    return np.stack(poses)


def circle_poses(c2w, n_views=120, n_r=2, angle_h_start=15, use_rand=False, rng=None):
    """Small look-at circle around the basis view
    (get_circle_poses_from_pose, scene_util.py:475-515)."""
    rng = rng or np.random.default_rng(0)
    focal = 0.1
    up = normalize(c2w[:3, 1])
    center = c2w[:3, 3]
    origin = center - focal * c2w[:3, 2]
    alphas = np.linspace(0, 360 * n_r, n_views)
    posi_rand = 0.02 * (rng.random(3) * 2 - 1) if use_rand else np.zeros(3)
    r = focal * np.sin(angle_h_start / 180 * np.pi)
    poses = []
    for alpha in alphas:
        a = alpha / 180 * np.pi
        b = center - focal * (1 - np.cos(angle_h_start / 180 * np.pi)) * normalize(
            c2w[:3, 2]
        )
        c = b + r * (normalize(c2w[:3, 0]) * np.cos(a) - up * np.sin(a))
        z = normalize(c - origin)
        poses.append(viewmatrix(z, up, c + posi_rand))
    return np.stack(poses)


def rocking_poses(c2w, angle_max=0.2, range_max=0.1, n_views=120, n_r=2):
    """Side-to-side rocking path (get_rocking_traj_pose, scene_util.py:425-445)."""
    focal = range_max / np.sin(angle_max) if np.sin(angle_max) != 0 else 10.0
    up = normalize(c2w[:3, 1])
    center = c2w[:3, 3]
    origin = center - focal * c2w[:3, 2]
    num_per_r = int(n_views / n_r)
    angle_delta = 2 * angle_max / num_per_r
    poses = []
    for i in range(num_per_r):
        angle = angle_max - angle_delta * i
        c = center - focal * (
            normalize(c2w[:3, 2]) * (1 - np.cos(angle))
            + normalize(c2w[:3, 0]) * np.sin(angle)
        )
        z = normalize(c - origin)
        poses.append(viewmatrix(z, up, c))
    return np.stack(poses + poses[::-1])


def pretraining_poses(
    c2w_basis, range_center=0.2, range_yaw=20, range_pitch=15,
    use_rand=False, angle_rand=5, posi_rand=0.05, rng=None,
):
    """9 poses with degree-valued yaw/pitch rotations and optional global +
    per-pose jitter (get_pretraining_poses, scene_util.py:675-710)."""
    rng = rng or np.random.default_rng(0)
    rotvecs = {
        "R": np.array([0, range_yaw, 0]), "L": np.array([0, -range_yaw, 0]),
        "U": np.array([range_pitch, 0, 0]), "D": np.array([-range_pitch, 0, 0]),
        "UR": np.array([range_pitch, range_yaw, 0]),
        "UL": np.array([range_pitch, -range_yaw, 0]),
        "DR": np.array([-range_pitch, range_yaw, 0]),
        "DL": np.array([-range_pitch, -range_yaw, 0]),
    }
    _, posivecs = _compass_vectors(range_center, 0.0, 0.0)
    c2w_basis = np.asarray(c2w_basis, np.float64)
    if use_rand:
        euler = 0.5 * angle_rand * (rng.random(3) * 2 - 1) / 180 * np.pi
        jitter = np.eye(4)
        jitter[:3, :3] = euler_to_rotation(euler)
        jitter[:3, 3] = 0.5 * posi_rand * (rng.random(3) * 2 - 1)
        c2w_basis = jitter @ c2w_basis
    poses = [c2w_basis]
    for d in ("R", "L", "U", "D", "UR", "UL", "DR", "DL"):
        rot = rotvecs[d] / 180 * np.pi
        posi = posivecs[d].astype(np.float64)
        if use_rand:
            rot = rot + 0.5 * angle_rand * (rng.random(3) * 2 - 1) / 180 * np.pi
            posi = posi + 0.5 * posi_rand * (rng.random(3) * 2 - 1)
        c2w = np.eye(4)
        c2w[:3, :3] = euler_to_rotation(rot) @ c2w_basis[:3, :3]
        c2w[:3, 3] = posi + c2w_basis[:3, 3]
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def circle_poses_from_basis_view(c2w, n_views=120, n_r=2):
    """Look-at circle with 15-degree start offset
    (get_circle_poses_from_basis_view, scene_util.py:713-746)."""
    focal = 0.1
    up = normalize(c2w[:3, 1])
    center = c2w[:3, 3]
    origin = center - focal * c2w[:3, 2]
    alphas = np.linspace(0, 360 * n_r, n_views)
    angle_h = 15.0
    r = focal * np.sin(angle_h / 180 * np.pi)
    poses = []
    for alpha in alphas:
        a = alpha / 180 * np.pi
        b = center - focal * (1 - np.cos(angle_h / 180 * np.pi)) * normalize(
            c2w[:3, 2]
        )
        c = b + r * (normalize(c2w[:3, 0]) * np.cos(a) - up * np.sin(a))
        poses.append(viewmatrix(normalize(c - origin), up, c))
    return np.stack(poses)


def surround_poses(c2w_basis, num_poses=8, range_center=0.2):
    """Basis + N translated poses on a circle in the image plane
    (get_sprt_poses, scene_util.py:653-673)."""
    if num_poses == 0:
        return np.asarray(c2w_basis)[None].astype(np.float32)
    poses = [np.asarray(c2w_basis, dtype=np.float64)]
    for i in range(num_poses):
        angle = i * 2 * np.pi / num_poses
        posi = np.array(
            [range_center * np.cos(angle), -range_center * np.sin(angle), 0.0]
        )
        c2w = np.eye(4)
        c2w[:3, :3] = c2w_basis[:3, :3]
        c2w[:3, 3] = posi + c2w_basis[:3, 3]
        poses.append(c2w)
    return np.stack(poses).astype(np.float32)


def test_trajectory(pose_traj, poses0, angle, trans_range, n_local=120, n_global=360):
    """Evaluation/video trajectory selection rule."""
    if pose_traj in ("local_fixed", "local_double", "local_circle"):
        return circle_spiral_poses(
            poses0, n_views=n_local, n_r=1, angle_h_start=angle - 0.03,
            trans_start=trans_range,
        )
    if pose_traj == "local_r2l":
        return r2l_poses(poses0, range_center=trans_range, num_frame=n_local)
    if pose_traj == "circle0":
        pose_traj = "circle"
    elif pose_traj.startswith("circle0_"):
        pose_traj = "circle_" + pose_traj.split("_")[-1]
    return camera_trajectory(
        n_global, traj_type=pose_traj, radius=trans_range, pose_ref=poses0
    )


def training_trajectory(pose_traj, num_training, angle, trans_range, pose_ref=None):
    """Training pose selection rule."""
    if pose_ref is None:
        pose_ref = np.eye(4)
    if pose_traj == "local_fixed":
        return local_fixed_poses(
            pose_ref, angle=angle, range_center=trans_range,
            range_yaw=0.6, range_pitch=0.2,
        )
    if pose_traj == "local_double":
        return double_circle_poses(pose_ref, num_training, random_sample=True)
    if pose_traj == "local_circle":
        return local_orbit_poses(pose_ref, range_center=trans_range)
    if pose_traj == "local_r2l":
        return r2l_poses(pose_ref, range_center=trans_range, num_frame=None)
    return camera_trajectory(
        num_training, traj_type=pose_traj, random_sample=False,
        radius=trans_range, pose_ref=pose_ref, for_training=True,
    )
