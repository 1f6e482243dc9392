"""Reconstruction-filter antialiasing of a supersampled render (PyTorch twin
of ``pointcloud_render_tpu.shading.aa``).

``supersample`` renders at ``ss`` times the film and collapses the rgb with
the reference film's gaussian reconstruction filter (Mitsuba's hdrfilm
rfilter: stddev 0.5 target px, radius 2 target px, offset-truncated per
axis; reference: traj_ball_renderer.py:20-27).  Depth and index keep every
``ss``-th sample (the caller slices them).

The JAX package runs the filter as one depthwise strided convolution.  Here
it is a fixed-order loop of strided multiplies and adds over the K x K taps
(K = 4 * ss): one IEEE float32 operation at a time, so the CPU and the card
give the same bits (a cuDNN convolution may run in TF32 and sums in an
order of its own).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def gaussian_kernel(ss: int, stddev_px: float = 0.5, radius_px: float = 2.0):
    """(K, K) float32 filter over supersampled texels for one target pixel
    (K = 2 * radius * ss texels, normalized to sum 1): the separable
    max(0, exp(-x^2 / 2s^2) - exp(-r^2 / 2s^2)) at the texel centres, x in
    target pixels.  A copy of the JAX package's NumPy function."""
    k = int(2 * radius_px * ss)
    coords = (np.arange(k) - (k - 1) / 2.0) / ss
    offset = np.exp(-0.5 * (radius_px / stddev_px) ** 2)
    g = np.maximum(0.0, np.exp(-0.5 * (coords / stddev_px) ** 2) - offset)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def downsample(rgb: torch.Tensor, ss: int, stddev_px: float = 0.5,
               radius_px: float = 2.0) -> torch.Tensor:
    """(H * ss, W * ss, 3) -> (H, W, 3) gaussian-filtered rgb, clipped to
    [0, 1]; the film is zero-padded by (K - ss) // 2 texels in front and the
    rest behind, as the JAX package's convolution pads it.  ``ss`` 1 returns
    ``rgb`` itself."""
    if ss == 1:
        return rgb
    k = gaussian_kernel(ss, stddev_px, radius_px)
    ksz = k.shape[0]
    lo = (ksz - ss) // 2
    hi = ksz - ss - lo
    hs, ws, _ = rgb.shape
    h, w = hs // ss, ws // ss
    padded = torch.nn.functional.pad(rgb.permute(2, 0, 1),
                                     (lo, hi, lo, hi))
    out = torch.zeros((3, h, w), dtype=torch.float32, device=rgb.device)
    for dy in range(ksz):
        for dx in range(ksz):
            tap = padded[:, dy:dy + h * ss:ss, dx:dx + w * ss:ss]
            out += tap * float(k[dy, dx])
    return torch.clamp(out.permute(1, 2, 0), 0.0, 1.0)
