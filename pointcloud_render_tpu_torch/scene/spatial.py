"""Spatial (Morton) ordering of point clouds (``pointcloud_render_tpu.scene
.spatial``).

The v5 chunk-binned rasterizer (``raster/csr5.py``) bins chunks of 16
consecutive primitives by their joint screen bbox, so its work depends on
consecutive points being world-space neighbours.  ``spatial_sort``
establishes that once per cloud: positions are quantized to a 2^bits-per-
axis grid over the cloud's own bounding box (float64, non-finite
coordinates clamped to the grid's far edge) and sorted stably by their
interleaved (Morton / Z-order) code.  The reorder is a permutation of the
scene: every backend renders the reordered soup with the same winners.

The codes are computed on the host in NumPy, as in the JAX package
(uint64 interleaving, which torch has no full arithmetic for), so the
permutation is bit-equal to the JAX one.  Tensors passed to
:func:`spatial_sort` are permuted on their own device.
"""

from __future__ import annotations

import numpy as np
import torch


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are two zero bits between
    every payload bit (uint64 in, uint64 out)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def morton_codes(positions, bits: int = 10) -> np.ndarray:
    """(N, 3) float positions (an array or a tensor on any device) ->
    (N,) uint64 Morton codes on a 2^bits-per-axis grid over the cloud's
    own AABB (non-finite coordinates clamp to the grid edge)."""
    p = _host(positions).astype(np.float64)
    finite = np.isfinite(p)
    safe = np.where(finite, p, 0.0)
    lo = safe.min(axis=0)
    hi = safe.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    n = (1 << bits) - 1
    q = np.clip(((safe - lo) / span) * n, 0, n).astype(np.uint64)
    q = np.where(finite, q, n).astype(np.uint64)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << np.uint64(1))
            | (_part1by2(q[:, 2]) << np.uint64(2)))


def spatial_order(positions, bits: int = 10) -> np.ndarray:
    """(N,) int64 permutation sorting the cloud into Morton order
    (stable: equal cells keep their original relative order)."""
    return np.argsort(morton_codes(positions, bits=bits), kind="stable")


def _permute(a, order):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(order, device=a.device)]
    return np.asarray(a)[order]


def spatial_sort(positions, *arrays, bits: int = 10):
    """Reorder positions (and any per-point companion arrays; None stays
    None) into Morton order -> (sorted_positions, *sorted_arrays, order).
    NumPy arrays come back as NumPy arrays, tensors as tensors on their
    own device; ``order`` is the host permutation."""
    order = spatial_order(positions, bits=bits)
    return (_permute(positions, order),
            *(_permute(a, order) for a in arrays), order)
