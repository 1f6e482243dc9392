"""Plain reference of the benchmark's scenes: cameras and primitive soups.

Everything here is worked out again from the benchmark's own inputs
(positions, velocities, colours, the frame index) and the scene constants
of the configuration file.  It is plain PyTorch and NumPy and imports
nothing of the program under test.

The rasterization contract of the reference renderer
(traj_ball_renderer.py and the engine it was ported to):

* camera space: +x image-right, +y image-up, +z viewing depth; focal
  length f = W / (2 tan(fov_x / 2)); pixel (px, py) = (W/2 + f x/z,
  H/2 - f y/z); a point is visible iff near < z < far;
* a sphere of world radius r is a disc of radius f r / z; a trail
  segment is a capsule between two projected vertices with linearly
  interpolated radius and depth; the ground is two triangles with edge
  functions and an inverse depth linear in screen space;
* the winner of a pixel is the lexicographic minimum of (depth, soup
  row) over the primitives that cover its centre (col + 0.5, row + 0.5).

Every field is written as one IEEE float32 operation at a time, in the
order of the expressions above (no matmul, no fused multiply-add, no
division by a Python scalar), so the soup is the same bits on the CPU and
on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

KIND_DISC = 0
KIND_CAPSULE = 1
KIND_TRIANGLE = 2
WIDTH_PARAMS = 12
NEAR = 0.1
FAR = 100.0
UP = (0.0, 0.0, 1.0)

# Velocity trails (traj_ball_renderer.py:112-150): 20 samples from the far
# end to the point, then the point itself.
N_TRAIL_POINTS = 20
VELOCITY_EPS = 1e-6
BASE_TRAIL_LENGTH = 0.07
MAX_TRAIL_LENGTH = 0.3
VEL_NORMALIZER = 10.0


def f32(value, device) -> torch.Tensor:
    """A host value as a float32 tensor on ``device``."""
    return torch.tensor(np.asarray(value, np.float32), device=device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device (the CPU's
    vectorized ``torch.sqrt`` is not; NumPy's and CUDA's are)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


@dataclasses.dataclass
class Camera:
    """A pinhole camera: (3, 4) world-to-camera matrix and the film."""

    w2c: torch.Tensor
    width: int
    height: int
    fov_x_degrees: float

    @property
    def focal(self) -> float:
        return self.width / (2.0 * math.tan(math.radians(self.fov_x_degrees)
                                             * 0.5))


def _norm3(v):
    return sqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def look_at(origin: torch.Tensor, target, width: int, height: int,
            fov_x_degrees: float) -> Camera:
    """The camera at ``origin`` ((3,) float32) looking at ``target``:
    forward = normalised (target - origin), right = forward x up, camera
    up = right x forward."""
    dev = origin.device
    forward = f32(target, dev) - origin
    forward = forward / _norm3(forward)
    right = _cross3(forward, f32(UP, dev))
    right = right / _norm3(right)
    cam_up = _cross3(right, forward)
    rot = torch.stack([right, cam_up, forward])
    trans = -(rot[:, 0] * origin[0] + rot[:, 1] * origin[1]
              + rot[:, 2] * origin[2])
    return Camera(torch.cat([rot, trans[:, None]], dim=1), width, height,
                  fov_x_degrees)


def dolly_origin(waypoints, frame: torch.Tensor, last_motion: int,
                 fade: int) -> torch.Tensor:
    """The reference's two-phase dolly (traj_ball_renderer.py:287-305):
    start -> mid over frames 0..last_motion, then mid -> final over the
    ``fade`` frames after it; ``frame`` a float32 scalar tensor."""
    dev = frame.device
    start, mid, final = (np.asarray(w, np.float32) for w in waypoints)
    p1 = frame / f32(last_motion, dev)
    p2 = (frame - last_motion) / f32(fade, dev)
    phase1 = f32(start, dev) + f32(mid - start, dev) * p1
    phase2 = f32(mid, dev) + f32(final - mid, dev) * p2
    return torch.where(frame <= last_motion, phase1, phase2)


@dataclasses.dataclass
class Soup:
    """Screen-space primitives, one row each."""

    kind: torch.Tensor  # (P,) int32
    params: torch.Tensor  # (P, 12) float32
    color: torch.Tensor  # (P, 3) float32
    valid: torch.Tensor  # (P,) bool
    bbox: torch.Tensor  # (P, 4) float32 xmin, xmax, ymin, ymax
    normal: torch.Tensor  # (P, 3) float32 camera-space (triangles)

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    @staticmethod
    def cat(parts) -> "Soup":
        return Soup(*(torch.cat([getattr(p, f.name) for p in parts])
                      for f in dataclasses.fields(Soup)))


def _params(cols) -> torch.Tensor:
    block = torch.stack(cols, dim=1)
    return torch.nn.functional.pad(block, (0, WIDTH_PARAMS - block.shape[1]))


def _colors(color, n, device) -> torch.Tensor:
    """One RGB colour for ``n`` primitives."""
    return torch.as_tensor(color, dtype=torch.float32,
                           device=device).expand(n, 3).contiguous()


def world_to_camera(p: torch.Tensor, m: torch.Tensor):
    x = p[:, 0] * m[0, 0] + p[:, 1] * m[0, 1] + p[:, 2] * m[0, 2] + m[0, 3]
    y = p[:, 0] * m[1, 0] + p[:, 1] * m[1, 1] + p[:, 2] * m[1, 2] + m[1, 3]
    z = p[:, 0] * m[2, 0] + p[:, 1] * m[2, 1] + p[:, 2] * m[2, 2] + m[2, 3]
    return x, y, z


def project(p: torch.Tensor, cam: Camera, radii: torch.Tensor):
    """(px, py, z, r_px, visible) of world points with world radii."""
    x, y, z = world_to_camera(p, cam.w2c)
    focal = cam.focal
    inv_z = 1.0 / torch.where(z <= 0, torch.ones_like(z), z)
    px = cam.width * 0.5 + focal * x * inv_z
    py = cam.height * 0.5 - focal * y * inv_z
    r = focal * radii * inv_z
    ok = (z > NEAR) & (z < FAR)
    ok = ok & (px + r >= 0) & (px - r <= cam.width)
    ok = ok & (py + r >= 0) & (py - r <= cam.height)
    return px, py, z, r, ok


def discs(positions, cam: Camera, radius: float, color) -> Soup:
    """Sphere splats of one world radius."""
    n = positions.shape[0]
    dev = positions.device
    radii = torch.full((n,), radius, dtype=torch.float32, device=dev)
    px, py, z, r, ok = project(positions, cam, radii)
    return Soup(
        kind=torch.full((n,), KIND_DISC, dtype=torch.int32, device=dev),
        params=_params([px, py, z, r]), color=_colors(color, n, dev),
        valid=ok, bbox=torch.stack([px - r, px + r, py - r, py + r], dim=1),
        normal=torch.zeros((n, 3), dtype=torch.float32, device=dev))


def capsules(vertex_cols, valid, cam: Camera, radius: float, color) -> Soup:
    """Polylines given as V (N, 3) vertex columns -> N (V - 1) capsules,
    point-major.  A segment is drawn iff both ends are visible and kept
    (``valid`` (N,)), its screen length is not zero and its bbox meets
    the film."""
    v = len(vertex_cols)
    n = vertex_cols[0].shape[0]
    dev = vertex_cols[0].device
    radii = torch.full((n,), float(radius), dtype=torch.float32, device=dev)
    proj = []
    for col in vertex_cols:
        px, py, z, r, _ = project(col, cam, radii)
        proj.append((px, py, z, r, (z > NEAR) & (z < FAR) & valid))
    fields = [[] for _ in range(9)]
    boxes = [[] for _ in range(4)]
    keep = []
    for s in range(v - 1):
        x0, y0, z0, r0, ok0 = proj[s]
        x1, y1, z1, r1, ok1 = proj[s + 1]
        dx, dy = x1 - x0, y1 - y0
        dz, dr = z1 - z0, r1 - r0
        len2 = dx * dx + dy * dy
        il2 = 1.0 / torch.where(len2 > 0, len2, torch.ones_like(len2))
        xmin = torch.minimum(x0 - r0, x1 - r1)
        xmax = torch.maximum(x0 + r0, x1 + r1)
        ymin = torch.minimum(y0 - r0, y1 - r1)
        ymax = torch.maximum(y0 + r0, y1 + r1)
        on = ((xmax >= 0) & (xmin <= cam.width)
              & (ymax >= 0) & (ymin <= cam.height))
        keep.append(ok0 & ok1 & (len2 > 0) & on)
        for k, val in enumerate((x0, y0, z0, r0, dx, dy, dz, dr, il2)):
            fields[k].append(val)
        for k, val in enumerate((xmin, xmax, ymin, ymax)):
            boxes[k].append(val)

    def point_major(cols):
        return torch.stack(cols, dim=1).reshape(-1)

    m = n * (v - 1)
    return Soup(
        kind=torch.full((m,), KIND_CAPSULE, dtype=torch.int32, device=dev),
        params=_params([point_major(c) for c in fields]),
        color=_colors(color, m, dev), valid=point_major(keep),
        bbox=torch.stack([point_major(c) for c in boxes], dim=1),
        normal=torch.zeros((m, 3), dtype=torch.float32, device=dev))


def trail_vertices(positions, velocities, frame: torch.Tensor, segments: int,
                   ramp_frames: int = 19):
    """The straight velocity trail of each point, sampled at ``segments``
    + 1 of its 21 vertices (round(linspace(0, 20, segments + 1))), as
    columns, and the (N,) trail mask.  Vertex i of the full trail lies at
    p - v / |v| * L * (19 - i) / 19, vertex 20 at p; L = (0.07 + 0.23 min(
    |v| / 10, 1)) * s with the "ball" length scale s = min(frame / 19, 1)
    (traj_ball_renderer.py:119-150)."""
    p, v = positions, velocities
    dev = p.device
    ramp = frame / f32(float(ramp_frames), dev)
    scale = torch.where(frame <= ramp_frames, ramp, torch.ones_like(frame))
    speed = sqrt_rn(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                    + v[:, 2] * v[:, 2])
    valid = (speed >= VELOCITY_EPS) & (scale > 0)
    norm = torch.minimum(speed / f32(VEL_NORMALIZER, dev),
                         torch.ones_like(speed))
    length = (BASE_TRAIL_LENGTH
              + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * norm) * scale
    safe = torch.where(speed < VELOCITY_EPS, torch.ones_like(speed), speed)
    direction = -v / safe[:, None]
    ts = (N_TRAIL_POINTS - 1 - np.arange(N_TRAIL_POINTS, dtype=np.float32)
          ) / (N_TRAIL_POINTS - 1)
    idx = np.round(np.linspace(0, N_TRAIL_POINTS, segments + 1)).astype(
        np.int64)
    cols = []
    for j in idx:
        col = p if j >= N_TRAIL_POINTS else \
            p + direction * (length * np.float32(ts[j]))[:, None]
        cols.append(col)
        valid = valid & torch.isfinite(col).all(dim=1)
    return cols, valid


def _clip_near(tris: torch.Tensor):
    """Near-plane clip of (F, 3, 3) camera-space triangles -> (2F, 3, 3),
    (2F,) kept, (2F,) source face (each face gives 0-2 triangles)."""
    dev = tris.device
    plane = NEAR * (1.0 + 1e-5)
    inside = tris[..., 2] > plane
    n_in = inside.to(torch.int32).sum(dim=1)
    i0, i1 = inside[:, 0], inside[:, 1]
    k_one = torch.where(i0, 0, torch.where(i1, 1, 2))
    k_two = torch.where(~i0, 1, torch.where(~i1, 2, 0))
    k = torch.where(n_in == 1, k_one, torch.where(n_in == 2, k_two, 0))
    rows = torch.arange(tris.shape[0], device=dev)
    a, b, c = (tris[rows, (k + j) % 3] for j in range(3))

    def cut(p, q):
        den = torch.where(q[:, 2] == p[:, 2], torch.ones_like(p[:, 2]),
                          q[:, 2] - p[:, 2])
        t = torch.clamp((plane - p[:, 2]) / den, 0.0, 1.0)[:, None]
        return p + t * (q - p)

    ab, bc, ca = cut(a, b), cut(b, c), cut(c, a)
    first = torch.where((n_in == 3)[:, None, None],
                        torch.stack([a, b, c], dim=1),
                        torch.where((n_in == 2)[:, None, None],
                                    torch.stack([a, b, bc], dim=1),
                                    torch.stack([a, ab, ca], dim=1)))
    out = torch.cat([first, torch.stack([a, bc, ca], dim=1)])
    kept = torch.cat([n_in >= 1, n_in == 2])
    return out, kept, torch.cat([rows, rows])


def ground(cam: Camera, half_extent: float, center, color) -> Soup:
    """The ground rectangle as two triangles with the plane's normal."""
    dev = cam.w2c.device
    cx, cy, cz = center
    e = half_extent
    verts = f32([[cx - e, cy - e, cz], [cx + e, cy - e, cz],
                 [cx + e, cy + e, cz], [cx - e, cy + e, cz]], dev)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], dtype=torch.int64,
                         device=dev)
    m = cam.w2c
    wx, wy, wz = world_to_camera(verts, m)
    tris = torch.stack([wx, wy, wz], dim=1)[faces]
    clipped, kept, src = _clip_near(tris)
    x, y, z = clipped[..., 0], clipped[..., 1], clipped[..., 2]
    focal = cam.focal
    inv_z = 1.0 / torch.where(z <= 0, torch.ones_like(z), z)
    px = cam.width * 0.5 + focal * x * inv_z
    py = cam.height * 0.5 - focal * y * inv_z
    vis = ((z > 0) & (z < FAR)).all(dim=1)
    vx = [px[:, k] for k in range(3)]
    vy = [py[:, k] for k in range(3)]
    area = (vx[1] - vx[0]) * (vy[2] - vy[0]) - (vy[1] - vy[0]) * (vx[2] - vx[0])
    sign = torch.where(area >= 0, 1.0, -1.0).to(torch.float32)
    flat = torch.abs(area) == 0
    inv_area = 1.0 / torch.where(flat, torch.ones_like(area),
                                 torch.abs(area))
    cols = []
    for a, b in ((1, 2), (2, 0), (0, 1)):
        ex = sign * (vx[b] - vx[a])
        ey = sign * (vy[b] - vy[a])
        cols += [ex, ey, ey * vx[a] - ex * vy[a]]
    cols += [inv_z[:, k] * inv_area for k in range(3)]
    xs, ys = torch.stack(vx, dim=1), torch.stack(vy, dim=1)
    bbox = torch.stack([xs.amin(dim=1), xs.amax(dim=1),
                        ys.amin(dim=1), ys.amax(dim=1)], dim=1)
    ok = kept & vis & ~flat
    ok = ok & (bbox[:, 1] >= 0) & (bbox[:, 0] <= cam.width)
    ok = ok & (bbox[:, 3] >= 0) & (bbox[:, 2] <= cam.height)
    # One world normal (0, 0, 1) for both faces, turned to face the camera.
    nrm = torch.stack([m[i, 0] * np.float32(0.0) + m[i, 1] * np.float32(0.0)
                       + m[i, 2] * np.float32(1.0) for i in range(3)])
    nrm = nrm[None, :].expand(faces.shape[0], 3)
    v0 = tris[:, 0]
    side = torch.sign((nrm[:, 0] * v0[:, 0] + nrm[:, 1] * v0[:, 1]
                       + nrm[:, 2] * v0[:, 2])[:, None])
    nrm = (-nrm * torch.where(side == 0, torch.ones_like(side), side))[src]
    n = src.shape[0]
    return Soup(
        kind=torch.full((n,), KIND_TRIANGLE, dtype=torch.int32, device=dev),
        params=_params(cols), color=_colors(color, faces.shape[0], dev)[src],
        valid=ok, bbox=bbox, normal=nrm.contiguous())


def quantized(soup: Soup, dtype) -> Soup:
    """The soup with its float fields stored in ``dtype`` (the control's
    lower precision), read back as float32."""
    def q(t):
        return t.to(dtype).to(torch.float32)
    return dataclasses.replace(soup, params=q(soup.params),
                               color=q(soup.color), bbox=q(soup.bbox),
                               normal=q(soup.normal))
