"""Mesh export (port of ``text2nerf_tpu/utils/mesh.py``): the isosurface
of the field's dense alpha volume by marching tetrahedra (each cube cut
into 6 tetrahedra sharing the diagonal 0-6, so no case table and a
watertight surface), written as a binary little-endian PLY.  numpy only,
on the host; :func:`export_field_mesh` computes the alpha volume on the
field's device.
"""

from __future__ import annotations

import numpy as np

# unit-cube corner offsets (x, y, z)
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float64,
)
# 6-tetrahedra decomposition of the cube sharing the main diagonal 0-6
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int64,
)


def _tet_triangles(p, v, level):
    """Triangles of the isosurface inside a batch of tetrahedra.

    Args:
      p: (M, 4, 3) tet corner positions.
      v: (M, 4) corner values.
      level: iso value.

    Returns (T, 3, 3) triangle vertices, oriented so the face normal points
    toward increasing field value.
    """
    inside = v < level  # (M, 4)
    code = (
        inside[:, 0].astype(np.int32)
        | (inside[:, 1].astype(np.int32) << 1)
        | (inside[:, 2].astype(np.int32) << 2)
        | (inside[:, 3].astype(np.int32) << 3)
    )

    def interp(a, b, sel):
        va, vb = v[sel, a], v[sel, b]
        denom = np.where(vb - va == 0, 1.0, vb - va)
        t = np.clip((level - va) / denom, 0.0, 1.0)
        return p[sel, a] + t[:, None] * (p[sel, b] - p[sel, a])

    tris = []
    # one-corner-inside cases (and complements): 1 triangle
    # two-corner cases: 2 triangles (a quad)
    one_cases = {1: 0, 2: 1, 4: 2, 8: 3}
    for c, corner in one_cases.items():
        others = [k for k in range(4) if k != corner]
        for cc, flip in ((c, False), (15 ^ c, True)):
            sel = np.nonzero(code == cc)[0]
            if sel.size == 0:
                continue
            e0 = interp(corner, others[0], sel)
            e1 = interp(corner, others[1], sel)
            e2 = interp(corner, others[2], sel)
            tri = np.stack([e0, e2, e1] if flip else [e0, e1, e2], 1)
            tris.append(tri)
    two_cases = [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))]
    for (a, b), (cc0, dd) in [(ab, cd) for ab, cd in two_cases]:
        c = (1 << a) | (1 << b)
        for code_val, flip in ((c, False), (15 ^ c, True)):
            sel = np.nonzero(code == code_val)[0]
            if sel.size == 0:
                continue
            # quad vertices: edges (a,c0), (a,d), (b,d), (b,c0)
            q0 = interp(a, cc0, sel)
            q1 = interp(a, dd, sel)
            q2 = interp(b, dd, sel)
            q3 = interp(b, cc0, sel)
            if flip:
                tris.append(np.stack([q0, q2, q1], 1))
                tris.append(np.stack([q0, q3, q2], 1))
            else:
                tris.append(np.stack([q0, q1, q2], 1))
                tris.append(np.stack([q0, q2, q3], 1))
    if not tris:
        return np.zeros((0, 3, 3))
    return np.concatenate(tris, 0)


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5, spacing=(1, 1, 1)):
    """Extract the isosurface of a 3D scalar field.

    Returns (verts (V, 3) in index*spacing units, faces (F, 3) int64).
    """
    vol = np.asarray(volume, np.float64)
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    corner_vals = np.empty((nx - 1, ny - 1, nz - 1, 8), np.float64)
    for k, (dx, dy, dz) in enumerate(_CORNERS.astype(int)):
        corner_vals[..., k] = vol[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]

    inside = corner_vals < level
    any_in = inside.any(-1)
    all_in = inside.all(-1)
    act = np.nonzero(any_in & ~all_in)
    if act[0].size == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    base = np.stack(act, -1).astype(np.float64)          # (M, 3)
    vals = corner_vals[act]                              # (M, 8)
    pos = base[:, None, :] + _CORNERS[None]              # (M, 8, 3)

    tri_batches = []
    for tet in _TETS:
        tri_batches.append(_tet_triangles(pos[:, tet], vals[:, tet], level))
    tris = np.concatenate(tri_batches, 0)                # (T, 3, 3)
    if tris.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    verts = tris.reshape(-1, 3)
    # weld duplicate vertices (quantized)
    key = np.round(verts * 1e6).astype(np.int64)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    verts_out = np.zeros((len(uniq), 3))
    verts_out[inverse] = verts
    faces = inverse.reshape(-1, 3)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts_out * np.asarray(spacing), faces[good]


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """Binary little-endian PLY writer (plyfile-compatible layout)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        verts.astype("<f4").tofile(f)
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        rec["n"] = 3
        rec["idx"] = faces
        rec.tofile(f)


def read_ply(path: str):
    """Minimal reader for files write_ply produces (for tests)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        nv = int([l for l in lines if l.startswith("element vertex")][0].split()[-1])
        nf = int([l for l in lines if l.startswith("element face")][0].split()[-1])
        verts = np.fromfile(f, "<f4", nv * 3).reshape(nv, 3)
        rec = np.fromfile(f, dtype=[("n", "u1"), ("idx", "<i4", (3,))], count=nf)
        return verts, rec["idx"]


def export_field_mesh(field, aabb, path: str, grid_size=(256, 256, 256),
                      level: float = 0.005):
    """The field's density → alpha on a dense ``grid_size`` lattice over
    ``aabb`` → isosurface at ``level`` → PLY at ``path``: vertices mapped
    into the box with per-axis voxel spacing, faces flipped as the
    reference flips them.  Returns (verts, faces)."""
    import torch

    from ..models import tensorf as tf

    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=next(field.parameters()).device)
    step = tf.step_size(aabb, tf.grid_resolution(field), field.cfg.step_ratio)
    with torch.no_grad():
        alpha, _ = tf.dense_alpha(field, aabb, grid_size, step)
    vol = alpha.cpu().numpy()
    box = aabb.cpu().numpy()
    spacing = (box[1] - box[0]) / np.asarray(vol.shape)
    verts, faces = marching_tetrahedra(vol, level=level, spacing=tuple(spacing))
    faces = faces[:, ::-1]
    verts = verts + box[0]
    write_ply(path, verts, faces)
    return verts, faces
