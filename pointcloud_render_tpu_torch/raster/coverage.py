"""The per-pixel coverage and depth evaluator (PyTorch twin of
``pointcloud_render_tpu.raster.coverage``).

Pure multiply/add/compare float32 (no square root; the one division is the
triangle's perspective 1 / iz, a tensor divided by a tensor), in the JAX
package's expression order: each element is the IEEE float32 value of the
written expression on the CPU and on the card.
"""

from __future__ import annotations

import torch

from pointcloud_render_tpu_torch.raster.primitives import KIND_TRIANGLE


def eval_coverage_depth(kind, params, qx, qy):
    """Evaluate primitives against pixel centres, fully broadcast.

    ``kind`` (...,) int32, ``params`` (..., 12) float32, ``qx``/``qy`` pixel
    centres broadcastable against (..., 1, 1) -> (covered (..., H, W) bool,
    depth (..., H, W) float32, garbage where not covered)."""

    def p(i):
        return params[..., i][..., None, None]

    k = kind[..., None, None]
    # A disc or a capsule (a disc is a capsule with a zero axis).
    dxd = qx - p(0)
    dyd = qy - p(1)
    t = torch.clamp((dxd * p(4) + dyd * p(5)) * p(8), 0.0, 1.0)
    cx = dxd - t * p(4)
    cy = dyd - t * p(5)
    rad = p(3) + p(7) * t
    cap_cov = cx * cx + cy * cy <= rad * rad
    cap_depth = p(2) + p(6) * t
    # A triangle: [ex0, ey0, c0, ex1, ey1, c1, ex2, ey2, c2, a0, a1, a2].
    e0 = p(0) * qy - p(1) * qx + p(2)
    e1 = p(3) * qy - p(4) * qx + p(5)
    e2 = p(6) * qy - p(7) * qx + p(8)
    iz = e0 * p(9) + e1 * p(10) + e2 * p(11)
    tri_cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (iz > 0)
    safe_iz = torch.where(iz > 0, iz, torch.ones_like(iz))
    tri_depth = torch.ones_like(safe_iz) / safe_iz
    is_tri = k == KIND_TRIANGLE
    return (torch.where(is_tri, tri_cov, cap_cov),
            torch.where(is_tri, tri_depth, cap_depth))


def pixel_centers(height: int, width: int, y0: int = 0, x0: int = 0,
                  device=None):
    """(H, W) float32 pixel-centre coordinate grids (qx, qy) of a screen
    region whose top-left pixel is (x0, y0)."""
    qy = torch.arange(height, dtype=torch.float32, device=device) \
        + float(y0) + 0.5
    qx = torch.arange(width, dtype=torch.float32, device=device) \
        + float(x0) + 0.5
    return (qx[None, :].expand(height, width),
            qy[:, None].expand(height, width))
