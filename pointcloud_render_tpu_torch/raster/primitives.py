"""Screen-space primitive soup (SoA, fixed shapes) — the PyTorch twin of
``pointcloud_render_tpu.raster.primitives``.

Every scene element maps to one of three screen-space primitive kinds:
DISC (ball splats), CAPSULE (trail segments) and TRIANGLE (the ground and
mesh shapes).  All live in one padded (P, 12) float32 parameter block plus
a kind code, color, validity mask, screen bbox and camera-space normal.

Parameter layout (unused slots zero), precomputed so that the per-pixel
evaluation is pure multiply/add/compare plus the triangle's one division:

  DISC:     [px, py, z, r_px, 0, 0, 0, 0, 0]   (a zero-axis capsule)
  CAPSULE:  [x0, y0, z0, r0, dx, dy, dz, dr, inv_len2]
  TRIANGLE: [ex0, ey0, c0, ex1, ey1, c1, ex2, ey2, c2, a0, a1, a2]
            (edge functions e_i = ex_i*qy - ey_i*qx + c_i, inside when all
             e_i >= 0; inverse depth iz = e0*a0 + e1*a1 + e2*a2)

Winner per pixel = lexicographic min of (depth, primitive row index);
pixel centers sample at (col + 0.5, row + 0.5).  Expression order follows
the JAX builders term by term; see ``project.py`` for the exactness rules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster.project import (
    apply_world_to_camera,
    project_points,
)
from pointcloud_render_tpu_torch.utils.consts import as_f32
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

KIND_DISC = 0
KIND_CAPSULE = 1
KIND_TRIANGLE = 2

PARAM_WIDTH = 12


@dataclasses.dataclass(frozen=True)
class ScreenPrimitives:
    kind: torch.Tensor  # (P,) int32
    params: torch.Tensor  # (P, 12) float32
    color: torch.Tensor  # (P, 3) float32
    valid: torch.Tensor  # (P,) bool
    bbox: torch.Tensor  # (P, 4) float32: xmin, xmax, ymin, ymax (pixels)
    normal: torch.Tensor  # (P, 3) float32 camera-space normal (triangles only)

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kind.device

    @staticmethod
    def concatenate(parts):
        parts = [p for p in parts if p is not None and p.count > 0]
        if not parts:
            raise ValueError("no primitives")
        return ScreenPrimitives(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(ScreenPrimitives)})

    def to(self, device) -> "ScreenPrimitives":
        return ScreenPrimitives(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(ScreenPrimitives)})


def _pad_params(cols) -> torch.Tensor:
    """Stack (N,) columns into the padded (N, 12) parameter block."""
    block = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    if block.shape[1] < PARAM_WIDTH:
        block = torch.nn.functional.pad(block, (0, PARAM_WIDTH - block.shape[1]))
    return block


def _broadcast_color(colors, n, device) -> torch.Tensor:
    colors = as_f32(colors, device)
    return colors.expand(n, 3).contiguous() if colors.ndim == 1 else colors


def discs_from_points(positions, camera, radii, colors) -> ScreenPrimitives:
    """Ball splats: project sphere centers, keep the projected radius."""
    proj = project_points(positions, camera, radii=radii)
    px, py, z, r = proj["px"], proj["py"], proj["z"], proj["r_px"]
    n = px.shape[0]
    dev = px.device
    return ScreenPrimitives(
        kind=torch.full((n,), KIND_DISC, dtype=torch.int32, device=dev),
        params=_pad_params([px, py, z, r]),
        color=_broadcast_color(colors, n, dev),
        valid=proj["valid"],
        bbox=torch.stack([px - r, px + r, py - r, py + r], dim=1),
        normal=torch.zeros((n, 3), dtype=torch.float32, device=dev),
    )


def capsules_from_polylines(points, vertex_valid, camera, radius_world,
                            colors) -> ScreenPrimitives:
    """Trail polylines (N, V, 3) with an (N, V) per-vertex keep mask ->
    N*(V-1) screen capsules, point-major (``capsules_from_polylines`` of
    the JAX package).  A segment is emitted iff both endpoints are kept;
    the culls, zero-length drop and radii are those of
    :func:`capsules_from_vertex_columns`, which evaluates the same
    float32 expressions per element: the polyline's vertices go there as
    V columns."""
    v = points.shape[1]
    return capsules_from_vertex_columns(
        [points[:, j] for j in range(v)],
        [vertex_valid[:, j] for j in range(v)], camera, radius_world, colors)


def capsules_from_vertex_columns(vertex_cols, valid_cols, camera,
                                 radius_world, colors) -> ScreenPrimitives:
    """Trail polylines given as V (N, 3) vertex columns -> N*(V-1) screen
    capsules, point-major (prim id = point * (V-1) + segment).

    A segment is valid iff both endpoints pass the near/far cull and their
    ``valid_cols`` masks, it has nonzero screen length, and its bbox touches
    the film.  ``radius_world`` is a Python scalar (the constant trail
    radius) or (N, V) per-vertex radii (the droplets' tapered tails);
    ``colors`` one (3,) color or (N, 3) per polyline.
    """
    v = len(vertex_cols)
    n = vertex_cols[0].shape[0]
    dev = vertex_cols[0].device
    if np.ndim(radius_world) == 0:
        rw = torch.full((n,), float(radius_world), dtype=torch.float32,
                        device=dev)
        radii = [rw] * v
    else:
        rw = torch.as_tensor(radius_world, dtype=torch.float32, device=dev)
        radii = [rw[:, j] for j in range(v)]
    projs, pvalid = [], []
    for j in range(v):
        proj = project_points(vertex_cols[j], camera, radii=radii[j])
        projs.append(proj)
        zok = (proj["z"] > camera.near) & (proj["z"] < camera.far)
        pvalid.append(zok & valid_cols[j])

    names = ("x0", "y0", "z0", "r0", "dx", "dy", "dz", "dr", "il2")
    cols = {k: [] for k in names}
    bb = {k: [] for k in ("xmin", "xmax", "ymin", "ymax")}
    valids = []
    for s in range(v - 1):
        a, b = projs[s], projs[s + 1]
        x0, y0, z0, r0 = a["px"], a["py"], a["z"], a["r_px"]
        x1, y1, r1 = b["px"], b["py"], b["r_px"]
        dx, dy = x1 - x0, y1 - y0
        dz, dr = b["z"] - z0, r1 - r0
        len2 = dx * dx + dy * dy
        sv = pvalid[s] & pvalid[s + 1] & (len2 > 0)
        il2 = 1.0 / torch.where(len2 > 0, len2, torch.ones_like(len2))
        xmin = torch.minimum(x0 - r0, x1 - r1)
        xmax = torch.maximum(x0 + r0, x1 + r1)
        ymin = torch.minimum(y0 - r0, y1 - r1)
        ymax = torch.maximum(y0 + r0, y1 + r1)
        on_film = ((xmax >= 0) & (xmin <= camera.width)
                   & (ymax >= 0) & (ymin <= camera.height))
        sv = sv & on_film
        for k, val in zip(names, (x0, y0, z0, r0, dx, dy, dz, dr, il2)):
            cols[k].append(val)
        for k, val in zip(bb, (xmin, xmax, ymin, ymax)):
            bb[k].append(val)
        valids.append(sv)

    def interleave(cs):
        return torch.stack(cs, dim=1).reshape(-1)

    m = n * (v - 1)
    color = as_f32(colors, dev)
    color = (color.expand(m, 3).contiguous() if color.ndim == 1
             else color.repeat_interleave(v - 1, dim=0))
    return ScreenPrimitives(
        kind=torch.full((m,), KIND_CAPSULE, dtype=torch.int32, device=dev),
        params=_pad_params([interleave(cols[k]) for k in names]),
        color=color,
        valid=interleave(valids),
        bbox=torch.stack([interleave(bb[k]) for k in bb], dim=1),
        normal=torch.zeros((m, 3), dtype=torch.float32, device=dev),
    )


def _near_clip_triangles(cam_verts: torch.Tensor, near: float):
    """Sutherland-Hodgman near-plane clip with fixed shapes.

    cam_verts (F, 3, 3) -> (2F, 3, 3) clipped triangles, (2F,) validity and
    (2F,) source-face index; each input face yields 0-2 triangles.
    """
    dev = cam_verts.device
    plane = near * (1.0 + 1e-5)
    z = cam_verts[..., 2]
    inside = z > plane
    n_in = inside.to(torch.int32).sum(dim=1)
    i0, i1 = inside[:, 0], inside[:, 1]
    k_one = torch.where(i0, 0, torch.where(i1, 1, 2))
    k_two = torch.where(~i0, 1, torch.where(~i1, 2, 0))
    k = torch.where(n_in == 1, k_one, torch.where(n_in == 2, k_two, 0))

    f = cam_verts.shape[0]
    rows = torch.arange(f, device=dev)
    a = cam_verts[rows, k % 3]
    b = cam_verts[rows, (k + 1) % 3]
    c = cam_verts[rows, (k + 2) % 3]

    def isect(p, q):
        den = torch.where(q[:, 2] == p[:, 2], torch.ones_like(p[:, 2]),
                          q[:, 2] - p[:, 2])
        t = (plane - p[:, 2]) / den
        t = torch.clamp(t, 0.0, 1.0)[:, None]
        return p + t * (q - p)

    i_ab, i_bc, i_ca = isect(a, b), isect(b, c), isect(c, a)
    tri_all_1 = torch.stack([a, b, c], dim=1)
    tri_one_1 = torch.stack([a, i_ab, i_ca], dim=1)
    tri_two_1 = torch.stack([a, b, i_bc], dim=1)
    tri_two_2 = torch.stack([a, i_bc, i_ca], dim=1)
    out1 = torch.where((n_in == 3)[:, None, None], tri_all_1,
                       torch.where((n_in == 2)[:, None, None], tri_two_1,
                                   tri_one_1))
    out_verts = torch.cat([out1, tri_two_2], dim=0)
    out_valid = torch.cat([n_in >= 1, n_in == 2], dim=0)
    src = torch.cat([rows, rows]).to(torch.int64)
    return out_verts, out_valid, src


def triangles_from_mesh(vertices, faces, camera, colors,
                        face_normal=None) -> ScreenPrimitives:
    """World-space triangles -> oriented screen edge functions + 1/z.

    Faces are clipped against the near plane, then culled against the far
    plane and the screen bbox.  ``face_normal`` is one world-space normal
    shared by every face (planar meshes: the ground quad), transformed once
    so that all faces carry bit-identical normals.  Without it the normal
    is the per-face cross product (normalized by its length).
    """
    dev = camera.device
    verts = torch.as_tensor(vertices, dtype=torch.float32, device=dev)
    wm = camera.world_to_camera_matrix()
    wx, wy, wz = apply_world_to_camera(verts, wm)
    cam_pts = torch.stack([wx, wy, wz], dim=1)
    f0 = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    cam_tris = cam_pts[f0]  # (F, 3, 3)

    clipped, cvalid, src = _near_clip_triangles(cam_tris, camera.near)
    x, y, z = clipped[..., 0], clipped[..., 1], clipped[..., 2]
    focal = camera.width / (2.0 * camera.tan_half_fov_x)
    safe_z = torch.where(z <= 0, torch.ones_like(z), z)
    inv_z = 1.0 / safe_z
    px = camera.width * 0.5 + focal * x * inv_z
    py = camera.height * 0.5 - focal * y * inv_z
    vvalid = (z > 0) & (z < camera.far)

    vx = [px[:, k] for k in range(3)]
    vy = [py[:, k] for k in range(3)]
    viz = [inv_z[:, k] for k in range(3)]
    area = (vx[1] - vx[0]) * (vy[2] - vy[0]) - (vy[1] - vy[0]) * (vx[2] - vx[0])
    sign = torch.where(area >= 0, 1.0, -1.0).to(torch.float32)
    abs_area = torch.abs(area)
    degenerate = abs_area == 0
    inv_area = 1.0 / torch.where(degenerate, torch.ones_like(abs_area), abs_area)

    cols = []
    for a, b in ((1, 2), (2, 0), (0, 1)):
        ex = sign * (vx[b] - vx[a])
        ey = sign * (vy[b] - vy[a])
        c = ey * vx[a] - ex * vy[a]
        cols += [ex, ey, c]
    cols += [viz[k] * inv_area for k in range(3)]
    params = _pad_params(cols)

    tvalid = cvalid & vvalid.all(dim=1) & ~degenerate
    xs = torch.stack(vx, dim=1)
    ys = torch.stack(vy, dim=1)
    bbox = torch.stack([xs.amin(dim=1), xs.amax(dim=1),
                        ys.amin(dim=1), ys.amax(dim=1)], dim=1)
    tvalid = tvalid & (bbox[:, 1] >= 0) & (bbox[:, 0] <= camera.width)
    tvalid = tvalid & (bbox[:, 3] >= 0) & (bbox[:, 2] <= camera.height)
    m = src.shape[0]

    v0 = cam_tris[:, 0]
    if face_normal is not None:
        nw = [np.float32(c) for c in face_normal]
        ncam = torch.stack([wm[i, 0] * nw[0] + wm[i, 1] * nw[1]
                            + wm[i, 2] * nw[2] for i in range(3)])
        nrm = ncam[None, :].expand(f0.shape[0], 3)
    else:
        v1, v2 = cam_tris[:, 1], cam_tris[:, 2]
        e1, e2 = v1 - v0, v2 - v0
        nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                           e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                           e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
        nlen = sqrt_rn(nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1]
                       + nrm[:, 2] * nrm[:, 2])[:, None]
        nrm = nrm / torch.where(nlen > 0, nlen, torch.ones_like(nlen))
    dot = (nrm[:, 0] * v0[:, 0] + nrm[:, 1] * v0[:, 1]
           + nrm[:, 2] * v0[:, 2])[:, None]
    flip = torch.sign(dot)
    nrm = -nrm * torch.where(flip == 0, torch.ones_like(flip), flip)
    nrm = nrm[src]

    color = _broadcast_color(colors, f0.shape[0], dev)[src]
    return ScreenPrimitives(
        kind=torch.full((m,), KIND_TRIANGLE, dtype=torch.int32, device=dev),
        params=params,
        color=color,
        valid=tvalid,
        bbox=bbox,
        normal=nrm.contiguous(),
    )
