"""Order-independent alpha compositing of disc splats, weighted-blended OIT
(PyTorch twin of ``pointcloud_render_tpu.raster.alpha``; BASELINE.json
config 3: sphere splats with a per-point radius and alpha):

    w_i(q)   = alpha_i * exp(-d_i(q)^2 / (2 sigma_i^2)),  sigma = r / 2,
               inside the splat's disc (d_i(q) <= r_i), else 0
    rgb(q)   = (sum_i w_i c_i) / (sum_i w_i)
    cover(q) = 1 - exp(-sum_i w_i)
    out      = cover * rgb + (1 - cover) * background

Commutative sums only: the image does not depend on the order of the
points, up to the order of float additions.  Plain torch ops (the JAX
package computes it in XLA, not Pallas), differentiable in the positions,
radii, colors and alphas.  :func:`composite_tiled` bins the splats as the
JAX package does (``raster/tiles.bin_primitives``: 8x128 strips, the first
``max_per_tile`` splats of a strip in id order, splats wider than 16
strips dropped with the rest of the big list, which the JAX function never
reads).
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import tiles
from pointcloud_render_tpu_torch.raster.coverage import pixel_centers
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives
from pointcloud_render_tpu_torch.raster.project import project_points
from pointcloud_render_tpu_torch.utils.consts import const


def splat_gaussians(positions, camera, radii, colors, alphas) -> dict:
    """Project world points -> per-splat screen gaussians: a dict of px,
    py, r (projected radius), valid (N,), color (N, 3) and alpha (N,)."""
    dev = camera.device
    positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
    n = positions.shape[0]
    proj = project_points(positions, camera, radii=torch.as_tensor(
        radii, dtype=torch.float32, device=dev))
    colors = torch.as_tensor(colors, dtype=torch.float32,
                             device=dev).expand(n, 3)
    alphas = torch.as_tensor(alphas, dtype=torch.float32,
                             device=dev).expand(n)
    return dict(px=proj["px"], py=proj["py"], r=proj["r_px"],
                valid=proj["valid"], color=colors, alpha=alphas)


def _weights(qx, qy, px, py, r2, alpha, valid):
    """The splats' weights at the pixel centres (one splat per leading
    index of px, py, r2, alpha and valid, each shaped (..., 1, 1))."""
    dx = qx - px
    dy = qy - py
    d2 = dx * dx + dy * dy
    sigma2 = torch.clamp(r2 * 0.25, min=1e-12)
    g = torch.exp(-d2 / (2.0 * sigma2))
    inside = (d2 <= r2) & valid
    return torch.where(inside, alpha * g, torch.zeros_like(g))


def _weighted_colors(w, color, dim):
    """(..., 3): the sum over ``dim`` of ``w`` times each splat's color
    (``color`` broadcastable against ``w`` once a channel is picked)."""
    return torch.stack([(w * color[..., k]).sum(dim) for k in range(3)],
                       dim=-1)


def _resolve(acc_c, acc_w, background):
    """The weight sum is both the colour normalizer and the opacity's
    exponent (w_i = alpha_i G_i)."""
    rgb = acc_c / torch.clamp(acc_w, min=1e-12)[..., None]
    cover = 1.0 - torch.exp(-acc_w)
    bg = const(background, np.float32, acc_w.device)
    return torch.clamp(cover[..., None] * rgb
                       + (1 - cover[..., None]) * bg, 0.0, 1.0)


def composite_bruteforce(splats: dict, width: int, height: int,
                         chunk: int = 32, background=(1.0, 1.0, 1.0)):
    """The accumulating reference: every splat at every pixel, ``chunk``
    splats at a time -> (H, W, 3) float32."""
    dev = splats["px"].device
    qx, qy = pixel_centers(height, width, device=dev)
    acc_c = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    acc_w = torch.zeros((height, width), dtype=torch.float32, device=dev)
    n = splats["px"].shape[0]
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)

        def col(name):
            return splats[name][sl][:, None, None]

        r = splats["r"][sl]
        w = _weights(qx, qy, col("px"), col("py"), (r * r)[:, None, None],
                     col("alpha"), col("valid"))
        acc_w = acc_w + w.sum(0)
        acc_c = acc_c + _weighted_colors(
            w, splats["color"][sl][:, None, None, :], 0)
    return _resolve(acc_c, acc_w, background)


def splat_prims(splats: dict) -> ScreenPrimitives:
    """The splats as the soup :func:`composite_tiled` bins: disc rows
    [px, py, r * r, alpha, r, g, b, 0 ...] with the bbox px +- r, py +- r."""
    px, py, r = splats["px"], splats["py"], splats["r"]
    n = px.shape[0]
    zero = torch.zeros_like(px)
    color = splats["color"]
    return ScreenPrimitives(
        kind=torch.zeros((n,), dtype=torch.int32, device=px.device),
        params=torch.stack([px, py, r * r, splats["alpha"], color[:, 0],
                            color[:, 1], color[:, 2]] + [zero] * 5, dim=1),
        color=color, valid=splats["valid"],
        bbox=torch.stack([px - r, px + r, py - r, py + r], dim=1).detach(),
        normal=torch.zeros((n, 3), dtype=torch.float32, device=px.device))


def composite_tiled(splats: dict, width: int, height: int, tile_h: int = 8,
                    tile_w: int = 128, max_per_tile: int = 1024,
                    chunk: int = 32, background=(1.0, 1.0, 1.0)):
    """Binned accumulation -> (H, W, 3) float32: each strip's kept splats
    (``tiles.bin_primitives`` at ``max_per_tile``), ``chunk`` ranks of every
    strip at a time."""
    prims = splat_prims(splats)
    params = prims.params
    dev = params.device
    bins = tiles.bin_primitives(prims, width, height, tile_h, tile_w,
                                max_per_tile)
    tiles_y, tiles_x = bins.tiles_y, bins.tiles_x
    num_tiles = tiles_y * tiles_x
    tid = torch.arange(num_tiles, device=dev)
    ox = torch.arange(tile_w, dtype=torch.float32, device=dev) + 0.5
    oy = torch.arange(tile_h, dtype=torch.float32, device=dev) + 0.5
    qx = ((tid % tiles_x) * tile_w).to(torch.float32)[:, None, None] \
        + ox[None, None, :]
    qy = ((tid // tiles_x) * tile_h).to(torch.float32)[:, None, None] \
        + oy[None, :, None]
    qx, qy = qx[:, None], qy[:, None]  # (T, 1, th, tw) against (T, C)
    acc_c = torch.zeros((num_tiles, tile_h, tile_w, 3), dtype=torch.float32,
                        device=dev)
    acc_w = torch.zeros((num_tiles, tile_h, tile_w), dtype=torch.float32,
                        device=dev)
    # Ranks past every strip's count hold no splat (their weights add
    # nothing): walk only as far as the fullest strip.
    ranks = min(int(bins.counts.max()) if num_tiles else 0, max_per_tile)
    for c in range(0, ranks, chunk):
        ids = bins.table[:, c:c + chunk]
        safe = torch.clamp(ids, min=0).long()
        pr = params[safe]  # (T, C, 12)
        va = prims.valid[safe] & (ids >= 0)

        def lane(i):
            return pr[..., i][..., None, None]

        w = _weights(qx, qy, lane(0), lane(1), lane(2), lane(3),
                     va[..., None, None])
        acc_w = acc_w + w.sum(1)
        acc_c = acc_c + _weighted_colors(w, pr[:, :, None, None, 4:7], 1)
    acc_c = acc_c.reshape(tiles_y, tiles_x, tile_h, tile_w, 3) \
        .permute(0, 2, 1, 3, 4).reshape(tiles_y * tile_h, tiles_x * tile_w,
                                         3)[:height, :width]
    acc_w = acc_w.reshape(tiles_y, tiles_x, tile_h, tile_w) \
        .permute(0, 2, 1, 3).reshape(tiles_y * tile_h,
                                     tiles_x * tile_w)[:height, :width]
    return _resolve(acc_c, acc_w, background)
