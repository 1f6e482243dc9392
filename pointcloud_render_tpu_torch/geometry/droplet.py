"""Procedural teardrop ("droplet") mesh and its capsule LOD — the PyTorch
twin of ``pointcloud_render_tpu.geometry.droplet``.

The reference writes a temp OBJ once per run and instances it per point via
Mitsuba (reference: traj_renderer.py:102-153).  Geometry: 16 rings x 20
segments over theta in [0, pi]; a spherical cap of radius 0.008 for
theta <= pi/3, then a tail tapering as r*(1-t)^2 with a z offset of
-0.035*t*0.8.  Quads are split into two triangles with the reference's
winding.  ``droplet_mesh`` and ``write_droplet_obj`` are host NumPy
(bit-equal to the JAX package's); ``instance_droplets`` and
``droplet_capsule_lod`` are float32 tensor builds on the inputs' device.
Rendering the mesh LOD needs the binned-triangle walk (ROADMAP queue A
item 12, queue B item 7); the capsule LOD is what the pipeline renders.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointcloud_render_tpu_torch.utils.consts import const
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

N_SEGMENTS = 20  # reference: traj_renderer.py:111
N_RINGS = 16  # reference: traj_renderer.py:112
BASE_RADIUS = 0.008  # reference: traj_renderer.py:113
LENGTH = 0.035  # reference: traj_renderer.py:114
CAP_THETA = np.pi / 3  # reference: traj_renderer.py:124
TAIL_Z_FACTOR = 0.8  # reference: traj_renderer.py:130
# Capsule LOD of the droplet: a head sphere plus a tapering tail capsule.
# The mesh's tail tip sits at z = r*cos(pi) - LENGTH*1.0*0.8 ~= -(LENGTH*0.8);
# rotation maps -z to the unit velocity, so the tail points ALONG +v
# (reference rest orientation: traj_renderer.py:171 with the tail at -z,
# traj_renderer.py:128-134).
TAIL_TIP_OFFSET = LENGTH * TAIL_Z_FACTOR  # 0.028 along +v from the center
# Tail radii of the capsule LOD: the mesh radius at the cap edge down to a
# point (the teardrop's r*(1-t)^2 profile, traj_renderer.py:129).
TAIL_RADII = (BASE_RADIUS * 0.6, BASE_RADIUS * 0.05)


def droplet_mesh(dtype=np.float32):
    """Returns (vertices (V,3), faces (F,3) int32); V=340, F=640."""
    i = np.arange(N_RINGS + 1, dtype=np.float64)  # ring index
    j = np.arange(N_SEGMENTS, dtype=np.float64)  # segment index
    theta = np.pi * i / N_RINGS  # (R+1,)
    phi = 2 * np.pi * j / N_SEGMENTS  # (S,)

    t = (theta - CAP_THETA) / (2 * np.pi / 3)
    in_cap = theta <= CAP_THETA
    r = np.where(in_cap, BASE_RADIUS, BASE_RADIUS * (1 - t) ** 2)
    z_offset = np.where(in_cap, 0.0, -LENGTH * t * TAIL_Z_FACTOR)

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    x = (r * sin_t)[:, None] * np.cos(phi)[None, :]
    y = (r * sin_t)[:, None] * np.sin(phi)[None, :]
    z = (r * cos_t + z_offset)[:, None] * np.ones_like(phi)[None, :]
    vertices = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(dtype)

    ri = np.arange(N_RINGS)[:, None]  # (R, 1)
    sj = np.arange(N_SEGMENTS)[None, :]  # (1, S)
    v0 = ri * N_SEGMENTS + sj
    v1 = ri * N_SEGMENTS + (sj + 1) % N_SEGMENTS
    v2 = (ri + 1) * N_SEGMENTS + sj
    v3 = (ri + 1) * N_SEGMENTS + (sj + 1) % N_SEGMENTS
    tri_a = np.stack([v0, v2, v1], axis=-1).reshape(-1, 3)
    tri_b = np.stack([v1, v2, v3], axis=-1).reshape(-1, 3)
    faces = np.stack([tri_a, tri_b], axis=1).reshape(-1, 3).astype(np.int32)
    return vertices, faces


def instance_droplets(rotations, translations=None):
    """Instance the droplet mesh per point: (N,4,4) | (N,3,3) + (N,3) ->
    world vertices (N*V, 3) float32 on the rotations' device and faces
    (N*F, 3) int32 (host).  The per-vertex transform is explicit broadcast
    multiply-adds in the JAX expression order, no matmul."""
    rot = torch.as_tensor(rotations, dtype=torch.float32)
    dev = rot.device
    if rot.ndim == 3 and rot.shape[1:] == (4, 4):
        t = rot[:, :3, 3]
        rot = rot[:, :3, :3]
    else:
        t = torch.as_tensor(translations, dtype=torch.float32, device=dev)
    mesh_v, mesh_f = droplet_mesh()
    v = const(mesh_v, np.float32, dev)  # (V, 3)
    n = rot.shape[0]
    # world[n, vtx, i] = sum_j rot[n, i, j] * v[vtx, j] + t[n, i]
    world = (rot[:, None, :, 0] * v[None, :, None, 0]
             + rot[:, None, :, 1] * v[None, :, None, 1]
             + rot[:, None, :, 2] * v[None, :, None, 2]
             + t[:, None, :])  # (N, V, 3)
    nv = v.shape[0]
    faces = (mesh_f[None, :, :]
             + (np.arange(n, dtype=np.int32) * nv)[:, None, None])
    return world.reshape(n * nv, 3), faces.reshape(-1, 3)


def droplet_capsule_lod(positions, velocities):
    """(N,3),(N,3) -> head centers (N,3), head radii (N,) and tail tips
    (N,3), float32 on the positions' device.  Zero/near-zero velocities
    keep the identity orientation (tail along -z world), matching the
    rotation contract."""
    dev = positions.device if isinstance(positions, torch.Tensor) else None
    p = torch.as_tensor(positions, dtype=torch.float32, device=dev)
    v = torch.as_tensor(velocities, dtype=torch.float32, device=p.device)
    one = const(1.0, np.float32, p.device)
    norm = sqrt_rn(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                   + v[:, 2] * v[:, 2])[:, None]
    still = norm < 1e-6
    unit = torch.where(still, const((0.0, 0.0, -1.0), np.float32, p.device),
                       v / torch.where(still, one, norm))
    tail_tip = p + unit * TAIL_TIP_OFFSET
    return (p, torch.full((p.shape[0],), BASE_RADIUS, dtype=torch.float32,
                          device=p.device), tail_tip)


def write_droplet_obj(path: str) -> str:
    """Export the droplet mesh as OBJ (reference temp-file parity,
    traj_renderer.py:147-153: 'v x y z' at 6 decimals, 1-based faces)."""
    from pointcloud_render_tpu_torch.io.obj import write_obj  # noqa: PLC0415

    vertices, faces = droplet_mesh(dtype=np.float64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_obj(path, vertices, faces)
    return os.path.abspath(path)
