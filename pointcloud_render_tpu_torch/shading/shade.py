"""Screen-space shading pass: id/depth buffers -> RGB (PyTorch twin of
``pointcloud_render_tpu.shading.shade``, lambert and flat modes).

* sphere-normal Lambert for disc splats (normal from the pixel's offset
  inside the disc);
* face-normal Lambert for triangles (the ground);
* the flat ``trail_boost`` color for capsules (reference trail specular,
  traj_ball_renderer.py:179-182);
* one directional key light straight down (-z world) plus an ambient floor.

The look passes beyond that — shadows, the GGX ground lobe and the
ground-bounce fill — are not ported yet (ROADMAP queue A item 13) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
)
from pointcloud_render_tpu_torch.utils.consts import const, device_key
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

LOOK_ITEM = "ROADMAP queue A item 13 (shading/shadow.py, GGX and GI terms)"


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """The JAX package's ShadingConfig, every field kept so configs stay
    compatible; only the lambert/flat terms are implemented."""

    mode: str = "lambert"
    ambient: float = 0.3
    diffuse: float = 0.7
    # Reference trail specular: clip(1.5 * color, 0, 1)
    # (traj_ball_renderer.py:179-182).
    trail_boost: float = 1.5
    background: tuple = (1.0, 1.0, 1.0)
    shadows: bool = False
    shadow_size: int = 1024
    shadow_bias: float = 0.05
    shadow_min_light: float = 0.35
    shadow_taps: int = 12
    shadow_emitter_half: float = 4.0
    shadow_max_radius_px: float = 24.0
    ground_spec: float = 0.0
    ground_alpha: float = 0.1
    ground_f0: float = 0.0349
    gi: float = 0.0
    gi_albedo: tuple = (1.0, 1.0, 1.0)


def check_supported(config: ShadingConfig) -> None:
    """Raise for the look passes the port does not have yet."""
    if config.shadows or config.ground_spec > 0.0 or config.gi > 0.0:
        raise NotImplementedError(
            "shadows / ground_spec / gi are not ported yet: " + LOOK_ITEM)
    if config.mode not in ("lambert", "flat"):
        raise ValueError(f"unknown shading mode {config.mode!r}")


def key_light(camera) -> torch.Tensor:
    """The overhead key light (world +z) in camera space: R @ (0, 0, 1)."""
    m = camera.world_to_camera_matrix()
    return torch.stack([m[0, 2], m[1, 2], m[2, 2]])


@functools.lru_cache(maxsize=8)
def _pixel_centers(width: int, height: int, device: torch.device):
    half = np.float32(0.5)
    qx = torch.arange(width, dtype=torch.float32, device=device) + half
    qy = torch.arange(height, dtype=torch.float32, device=device) + half
    return qx[None, :], qy[:, None]


def pixel_centers(width: int, height: int, device):
    """(1, W) and (H, 1) float32 pixel-center coordinates, made on the
    device and kept for the last few film sizes (shared: read only)."""
    return _pixel_centers(width, height, device_key(device))


def background(config: ShadingConfig, device) -> torch.Tensor:
    return const(config.background, np.float32, device)


def shade_framebuffer(prims, camera, depth, index,
                      config: ShadingConfig) -> torch.Tensor:
    """Resolve winning primitives to shaded (H, W, 3) float32 RGB in [0, 1]."""
    check_supported(config)
    h, w = depth.shape
    dev = depth.device
    hit = index >= 0
    safe_idx = torch.clamp(index, min=0).long()

    if config.mode == "flat":
        rgb = prims.color[safe_idx]
    else:
        table = torch.cat([
            prims.kind.to(torch.float32)[:, None],
            prims.params[:, 0:2],
            torch.clamp(prims.params[:, 3:4], min=1e-6),
            prims.color,
            prims.normal,
        ], dim=1)
        attr = table[safe_idx]  # (H, W, 10)
        kind = attr[..., 0]
        color = attr[..., 4:7]
        l_cam = key_light(camera)
        qx, qy = pixel_centers(w, h, dev)
        inv_r = 1.0 / attr[..., 3]
        u = (qx - attr[..., 1]) * inv_r
        v = -(qy - attr[..., 2]) * inv_r
        w2 = torch.clamp(1.0 - u * u - v * v, min=0.0)
        nz = -sqrt_rn(w2)
        ndotl_disc = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
        ndotl_tri = (attr[..., 7] * l_cam[0] + attr[..., 8] * l_cam[1]
                     + attr[..., 9] * l_cam[2])
        ndotl = torch.where(kind == KIND_DISC, ndotl_disc, ndotl_tri)
        lit = config.ambient + config.diffuse * torch.clamp(ndotl, min=0.0)
        lit = torch.where(kind == KIND_CAPSULE,
                          torch.full_like(lit, config.trail_boost), lit)
        rgb = color * lit[..., None]
    rgb = torch.where(hit[..., None], rgb, background(config, dev))
    return torch.clamp(rgb, 0.0, 1.0)
