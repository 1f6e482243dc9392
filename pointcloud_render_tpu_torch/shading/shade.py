"""Screen-space shading pass: id/depth buffers -> RGB (PyTorch twin of
``pointcloud_render_tpu.shading.shade``).

* sphere-normal Lambert for disc splats (normal from the pixel's offset
  inside the disc);
* face-normal Lambert for triangles (the ground);
* the flat ``trail_boost`` color for capsules (reference trail specular,
  traj_ball_renderer.py:179-182);
* one directional key light straight down (-z world) plus an ambient floor;
* the look passes: a shadow factor on the diffuse term
  (``shading/shadow.py``), the GGX lobe of the roughplastic ground on
  triangle winners (``ground_spec``) and the ground-bounce fill on disc
  winners (``gi``).  They change rgb only.

:func:`shade_framebuffer` and :func:`shade_winner_attrs` evaluate every
term.  The fused kernel epilogues (``csr6``, ``csr4``, ``csr3``, ``csr5``)
evaluate the lambert and flat terms only and call :func:`check_supported`,
which raises for the look knobs (the JAX package's fused kernels drop them
without a word; ROADMAP queue C).

Exactness: every expression is the JAX package's, one IEEE float32
operation at a time: no division with a Python scalar on either side (a
tensor is divided by a tensor), ``x ** 5`` as ``x * ((x * x) * (x * x))``
(XLA's ``integer_pow``) and square roots through ``utils/ieee.sqrt_rn``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    KIND_TRIANGLE,
)
from pointcloud_render_tpu_torch.utils.consts import const, device_key
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn



# ``np.float32(np.pi)`` of the JAX package's GGX term, as a Python float
# (a NumPy scalar on the left of a tensor would convert the tensor).
PI_F32 = float(np.float32(np.pi))


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """The JAX package's ShadingConfig, every field kept (the look passes'
    fields are documented there: shading/shade.py:46-80)."""

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


def has_look(config: ShadingConfig) -> bool:
    """Whether a look pass is on (shadows, the GGX lobe or the GI fill)."""
    return config.shadows or config.ground_spec > 0.0 or config.gi > 0.0


def check_mode(config: ShadingConfig) -> None:
    if config.mode not in ("lambert", "flat"):
        raise ValueError(f"unknown shading mode {config.mode!r}")


def check_supported(config: ShadingConfig) -> None:
    """The fused epilogues' check: raise for the look passes, which they do
    not evaluate, and for an unknown mode."""
    if has_look(config):
        raise NotImplementedError(
            "the fused kernel epilogues do not evaluate shadows, ground_spec "
            "or gi (the JAX package's fused kernels drop them: ROADMAP "
            "queue C); FramePipeline re-shades through shade_framebuffer, "
            "and the backends cpu, tiled, bruteforce and pallas shade "
            "through it")
    check_mode(config)


def without_look(config: ShadingConfig) -> ShadingConfig:
    """``config`` with the look passes off (the camera raster's shading in
    the pipeline's look branch, whose rgb is discarded)."""
    return dataclasses.replace(config, shadows=False, ground_spec=0.0,
                               gi=0.0)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A host value as a float32 tensor on ``like``'s device (a divisor or
    dividend: a Python scalar never takes part in a division)."""
    return const(value, np.float32, like.device)


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """``x ** 5`` as XLA's ``integer_pow`` evaluates it."""
    x2 = x * x
    return x * (x2 * x2)


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


def shade_winner_attrs(px, py, rflag, rgb, hit, camera,
                       config: ShadingConfig = ShadingConfig()):
    """Shade winner-attribute buffers ((H, W) ``px``, ``py``, ``rflag``,
    ``hit`` and (H, W, 3) ``rgb``; no soup needed): the disc branch of
    :func:`shade_framebuffer` where ``rflag`` (the projected radius) > 0,
    the flat ``trail_boost`` where it is < 0 (capsules) and the rgb as
    given where it is 0 (pre-lit winners), with the GI fill on discs."""
    h, w = hit.shape
    if config.mode == "flat":
        out = rgb
    else:
        check_mode(config)
        l_cam = key_light(camera)
        qx, qy = pixel_centers(w, h, hit.device)
        r = torch.clamp(rflag, min=1e-6)
        inv_r = torch.ones_like(r) / r
        u = (qx - px) * inv_r
        v = -(qy - py) * inv_r
        w2 = torch.clamp(1.0 - u * u - v * v, min=0.0)
        nz = -sqrt_rn(w2)
        ndotl = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
        lit = config.ambient + config.diffuse * torch.clamp(ndotl, min=0.0)
        lit = torch.where(rflag > 0, lit, torch.where(
            rflag < 0, torch.full_like(lit, config.trail_boost),
            torch.ones_like(lit)))
        out = rgb * lit[..., None]
        if config.gi > 0.0:
            bounce = config.gi * torch.clamp(-ndotl, min=0.0)
            bounce = torch.where(rflag > 0, bounce, torch.zeros_like(bounce))
            out = out + rgb * bounce[..., None] * _f32(config.gi_albedo, rgb)
    out = torch.where(hit[..., None], out, background(config, hit.device))
    return torch.clamp(out, 0.0, 1.0)


def _ggx_specular(qx, qy, w: int, h: int, camera, attr, l_cam,
                 config: ShadingConfig):
    """Per-pixel GGX (Trowbridge-Reitz) lobe of triangle winners ->
    ``(spec, f_view)``, both scaled by ``ground_spec``: Cook-Torrance with
    the height-correlated Smith visibility and Schlick's Fresnel at the
    roughplastic ground's ``ground_alpha`` and ``ground_f0``.  View: the
    pixel's camera-space ray; light: ``l_cam``; normal: the triangle's
    camera-space face normal (``attr`` lanes 7..9).  ``f_view`` is the
    view-angle Fresnel that scales the substrate's transmission."""
    focal = w / (2.0 * camera.tan_half_fov_x)
    rx = (qx - w * 0.5) / _f32(focal, qx)
    ry = -(qy - h * 0.5) / _f32(focal, qy)
    rn = sqrt_rn(rx * rx + ry * ry + 1.0)
    inv_n = torch.ones_like(rn) / rn
    vx, vy, vz = -rx * inv_n, -ry * inv_n, -inv_n
    hx = vx + l_cam[0]
    hy = vy + l_cam[1]
    hz = vz + l_cam[2]
    hn = torch.clamp(sqrt_rn(hx * hx + hy * hy + hz * hz), min=1e-6)
    inv_h = torch.ones_like(hn) / hn
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    nx, ny, nz = attr[..., 7], attr[..., 8], attr[..., 9]
    ndoth = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
    ndotv = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    ndotl = torch.clamp(nx * l_cam[0] + ny * l_cam[1] + nz * l_cam[2],
                        min=0.0)
    vdoth = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)
    # The JAX package squares alpha in float64 (a Python float); each
    # constant is rounded to float32 where it meets a tensor.
    a2 = config.ground_alpha * config.ground_alpha
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    d_ggx = _f32(a2, denom) / (PI_F32 * denom * denom)
    lv = ndotl * sqrt_rn(ndotv * ndotv * (1.0 - a2) + a2)
    ll = ndotv * sqrt_rn(ndotl * ndotl * (1.0 - a2) + a2)
    s = torch.clamp(lv + ll, min=1e-6)
    vis = _f32(0.5, s) / s
    f0 = config.ground_f0
    f = f0 + (1.0 - f0) * _pow5(1.0 - vdoth)
    spec = config.ground_spec * d_ggx * vis * f * ndotl
    f_view = f0 + (1.0 - f0) * _pow5(1.0 - ndotv)
    return spec, config.ground_spec * f_view


def shade_framebuffer(prims, camera, depth, index, config: ShadingConfig,
                      shadow=None) -> torch.Tensor:
    """Resolve winning primitives to shaded (H, W, 3) float32 RGB in [0, 1].

    ``shadow``: optional (H, W) diffuse scale in [0, 1]
    (``shading.shadow.shadow_factor``), which also scales the GGX lobe.
    """
    check_mode(config)
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
        inv_r = torch.ones_like(attr[..., 3]) / attr[..., 3]
        u = (qx - attr[..., 1]) * inv_r
        v = -(qy - attr[..., 2]) * inv_r
        w2 = torch.clamp(1.0 - u * u - v * v, min=0.0)
        nz = -sqrt_rn(w2)
        ndotl_disc = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
        ndotl_tri = (attr[..., 7] * l_cam[0] + attr[..., 8] * l_cam[1]
                     + attr[..., 9] * l_cam[2])
        ndotl = torch.where(kind == KIND_DISC, ndotl_disc, ndotl_tri)
        diff = config.diffuse * torch.clamp(ndotl, min=0.0)
        if shadow is not None:
            diff = diff * shadow
        lit = config.ambient + diff
        lit = torch.where(kind == KIND_CAPSULE,
                          torch.full_like(lit, config.trail_boost), lit)
        rgb = color * lit[..., None]
        if config.gi > 0.0:
            bounce = config.gi * torch.clamp(-ndotl, min=0.0)
            bounce = torch.where(kind == KIND_DISC, bounce,
                                 torch.zeros_like(bounce))
            rgb = rgb + color * bounce[..., None] * _f32(config.gi_albedo,
                                                         color)
        if config.ground_spec > 0.0:
            spec, f_view = _ggx_specular(qx, qy, w, h, camera, attr,
                                         l_cam, config)
            is_tri = kind == KIND_TRIANGLE
            spec = torch.where(is_tri, spec, torch.zeros_like(spec))
            if shadow is not None:
                spec = spec * shadow
            trans = torch.where(is_tri, 1.0 - f_view,
                                torch.ones_like(f_view))
            rgb = rgb * trans[..., None] + spec[..., None]
    rgb = torch.where(hit[..., None], rgb, background(config, dev))
    return torch.clamp(rgb, 0.0, 1.0)
