"""Shadow-map look pass: one light-view depth raster and a per-pixel test
(PyTorch twin of ``pointcloud_render_tpu.shading.shadow``).

The reference's soft shadows come from an 8x8 area emitter at (0, 0, 15)
(traj_ball_renderer.py:67-75).  The same primitive soup is built from the
emitter's viewpoint and rasterized to a z-buffer; at shade time every hit
pixel is re-projected into the light view and its diffuse term darkened
where a nearer occluder wins there (PCSS-lite penumbra: a blocker search,
then a poisson filter of the depth test whose radius grows with the
blocker gap).  rgb only: depth and index never change.

The light view is rasterized as the JAX package does it, through its capped
``tiled`` backend (8x128 strips, 1,024 entries per strip, 16 strips per
prim, 64 big prims): ``raster/tiles.rasterize_tiled``, whose walk is the
``csr1_raster`` kernel on CUDA tensors.  Occluders past the caps are
dropped, as in the JAX package (a missing shadow, never a wrong winner;
ROADMAP queue C).

Exactness: the JAX package's expressions one IEEE float32 operation at a
time; no division with a Python scalar on either side; float-to-int casts
truncate toward zero and saturate, as XLA's convert does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import tiles
from pointcloud_render_tpu_torch.scene.camera import Camera
from pointcloud_render_tpu_torch.utils.consts import const

# The reference emitter's pose (traj_ball_renderer.py:67-75): an 8x8
# rectangle at z = 15 pointing down.
LIGHT_POS = (0.0, 0.0, 15.0)
DEFAULT_SHADOW_SIZE = 1024
DEFAULT_BIAS = 0.05
# The light view's capped tiled raster (JAX shading/shadow.py:170).
SHADOW_MAX_PER_TILE = 1024

# The JAX package's deterministic 12-tap poisson disk (a Vogel spiral of
# radius sqrt((k + 0.5) / 12)), computed in float64 and stored as float32.
_POISSON_12 = np.array(
    [[math.sqrt((k + 0.5) / 12.0) * math.cos(k * 2.399963),
      math.sqrt((k + 0.5) / 12.0) * math.sin(k * 2.399963)]
     for k in range(12)], np.float32)


def light_camera(extent: float = 2.5, size: int = DEFAULT_SHADOW_SIZE,
                 light_pos=LIGHT_POS, device="cuda") -> Camera:
    """A perspective camera at the emitter looking straight down, sized so
    the z = 0 plane's +-``extent`` square fills the ``size`` x ``size``
    film."""
    h = float(light_pos[2])
    fov = 2.0 * math.degrees(math.atan(extent / h))
    return Camera(
        origin=const(light_pos, np.float32, device),
        target=const([light_pos[0], light_pos[1], 0.0], np.float32, device),
        up=(0.0, 1.0, 0.0), fov_x_degrees=fov, width=size, height=size)


def render_shadow_depth(prims_light, light_cam) -> torch.Tensor:
    """Light-view z-buffer of the soup ((S, S) float32, +inf empty): the
    capped ``tiled`` raster at ``max_per_tile`` 1,024."""
    depth, _, _ = tiles.rasterize_tiled(
        prims_light, light_cam.width, light_cam.height,
        max_per_tile=SHADOW_MAX_PER_TILE)
    return depth


def _texel(v: torch.Tensor, n: int) -> torch.Tensor:
    """int64 ``clip(v.astype(int32), 0, n - 1)`` as XLA evaluates it: the
    cast truncates toward zero, saturates and maps NaN to 0."""
    v = torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, float(n))
    return torch.clamp(v.to(torch.int64), 0, n - 1)


def shadow_factor(camera, depth, index, light_cam, shadow_depth,
                  bias: float = DEFAULT_BIAS, min_light: float = 0.35,
                  taps: int = 12, emitter_half: float = 4.0,
                  max_radius_px: float = 24.0) -> torch.Tensor:
    """(H, W) diffuse scale in [min_light, 1]: each hit pixel's world
    position (from the camera's depth buffer) projected into the light
    view and tested against ``shadow_depth``.  ``taps`` > 0: the PCSS-lite
    penumbra (a blocker search over the poisson disk at ``max_radius_px``,
    the penumbra width emitter_half * (d_receiver - d_blocker) / d_blocker
    in light-view texels, the depth test averaged over the disk at that
    radius); ``taps`` 0: the 2x2 PCF."""
    h, w = depth.shape
    dev = depth.device
    hit = index >= 0
    one = torch.ones_like(depth)
    focal = const(w / (2.0 * camera.tan_half_fov_x), np.float32, dev)
    qx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    qy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    z = torch.where(hit, depth, one)
    cx = (qx - w * 0.5) * z / focal
    cy = -(qy - h * 0.5) * z / focal
    m = camera.world_to_camera_matrix()
    rot, t = m[:, :3], m[:, 3]
    dxc = cx - t[0]
    dyc = cy - t[1]
    dzc = z - t[2]
    wx = rot[0, 0] * dxc + rot[1, 0] * dyc + rot[2, 0] * dzc
    wy = rot[0, 1] * dxc + rot[1, 1] * dyc + rot[2, 1] * dzc
    wz = rot[0, 2] * dxc + rot[1, 2] * dyc + rot[2, 2] * dzc

    ml = light_cam.world_to_camera_matrix()
    lx = ml[0, 0] * wx + ml[0, 1] * wy + ml[0, 2] * wz + ml[0, 3]
    ly = ml[1, 0] * wx + ml[1, 1] * wy + ml[1, 2] * wz + ml[1, 3]
    lz = ml[2, 0] * wx + ml[2, 1] * wy + ml[2, 2] * wz + ml[2, 3]

    sw, sh = light_cam.width, light_cam.height
    lfocal_f = sw / (2.0 * light_cam.tan_half_fov_x)
    lfocal = const(lfocal_f, np.float32, dev)
    safe_lz = torch.where(lz > 0, lz, one)
    lpx = sw * 0.5 + lfocal * lx / safe_lz
    lpy = sh * 0.5 - lfocal * ly / safe_lz
    inside = (lz > 0) & (lpx >= 0) & (lpx < sw) & (lpy >= 0) & (lpy < sh)

    sd = torch.where(torch.isfinite(shadow_depth), shadow_depth,
                     torch.full_like(shadow_depth, float("inf")))
    sd_flat = sd.reshape(-1)

    def lookup(ix, iy):
        return sd_flat[iy * sw + ix]

    lit = torch.ones_like(z)
    dark = torch.zeros_like(z)
    if taps <= 0:
        ix0 = _texel(torch.floor(lpx - 0.5), sw)
        iy0 = _texel(torch.floor(lpy - 0.5), sh)
        vis = torch.zeros_like(z)
        for dy in (0, 1):
            for dx in (0, 1):
                occ = lookup(torch.clamp(ix0 + dx, max=sw - 1),
                             torch.clamp(iy0 + dy, max=sh - 1))
                vis = vis + torch.where(lz <= occ + bias, lit, dark)
        vis = vis * 0.25
    else:
        disk = _POISSON_12[
            np.linspace(0, len(_POISSON_12) - 1, taps).astype(np.int32)]
        search_r = np.float32(max_radius_px)

        def gather(k, radius=None):
            if radius is None:  # the search radius: a host constant
                ox = float(disk[k, 0] * search_r)
                oy = float(disk[k, 1] * search_r)
                return lookup(_texel(lpx + ox, sw), _texel(lpy + oy, sh))
            return lookup(_texel(lpx + float(disk[k, 0]) * radius, sw),
                          _texel(lpy + float(disk[k, 1]) * radius, sh))

        safe = torch.clamp(lz, min=1e-3)
        occ_sum = torch.zeros_like(z)
        occ_cnt = torch.zeros_like(z)
        for k in range(taps):
            occ = gather(k)
            is_b = (occ + bias < lz).to(torch.float32)
            occ_sum = occ_sum + torch.where(is_b > 0, occ, dark)
            occ_cnt = occ_cnt + is_b
        d_b = occ_sum / torch.clamp(occ_cnt, min=1.0)
        pen = emitter_half * (safe - d_b) / torch.clamp(d_b, min=1e-3)
        radius = torch.where(
            occ_cnt > 0,
            torch.clamp(lfocal * pen / safe, 1.0, max_radius_px), lit)
        vis = torch.zeros_like(z)
        for k in range(taps):
            occ = gather(k, radius)
            vis = vis + torch.where(lz <= occ + bias, lit, dark)
        vis = vis / const(taps, np.float32, dev)
    factor = min_light + (1.0 - min_light) * vis
    return torch.where(hit & inside, factor, lit)
