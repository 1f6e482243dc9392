"""v2 strip-tile rasterizer (backend ``"pallas"``): the counterpart of
``pointcloud_render_tpu.raster.pallas_csr2``.

v2 runs v1's walk over v1's binning (``raster/csr.py``): strip tiles of
``tile_h`` x ``tile_w`` pixels, the big list first, then each tile's
sorted rows front to back by depth bucket with the saturation early exit.
Its rows are the 16-float generic rows, or under ``discs_only`` the
8-float disc rows of :func:`pack_rows_disc` (capsules and triangles ride
the big list).  The CUDA kernels are ``csr2_raster`` and ``csr2_disc8``
of ``csrc/csr2_raster.cu``; CPU tensors take the plain walk.

Semantic knobs here: ``tile_h``/``tile_w`` and ``max_tiles_per_prim``
decide what bins and what rides the big list, ``no_triangles`` and
``discs_only`` force kinds onto it, and a finite ``entry_capacity`` keeps
only the first that many sorted entries (the TPU's static row gather):
``true_entry_count(...) <= entry_capacity`` is the exactness condition.
The big list holds ``max_big`` prims (1024 under ``render``, which does
not forward ``RasterConfig.max_big``, as in the JAX package); prims past
it are dropped and ``diag["big_overflow"]`` counts them.  The JAX
function's ``unroll``, ``group`` and ``chunk_rows`` are TPU mechanics and
have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from pointcloud_render_tpu_torch.raster import csr, csr6
from pointcloud_render_tpu_torch.raster.csr import (
    DEFAULT_MAX_BIG,
    ROW_F_DISC,
    TILE_H,
    TILE_W,
    pack_rows_generic,
    raster_strips_plain,
)
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives

MAX_TILES_PER_PRIM = 4  # rasterize_pallas_csr2's default

def pack_rows_disc(prims: ScreenPrimitives, sorted_prims, sorted_keys,
                   zmin, span) -> torch.Tensor:
    """(E, 8) float32 disc rows of the sorted entries
    (``pallas_csr2._pack_rows_disc``): [px, py, z, r*r, id, bucket_low of
    the entry's bucket, 0, 0]."""
    ids = torch.clamp(sorted_prims, min=0).long()
    g = prims.params[ids, 0:4]
    low = csr.bucket_low(torch.remainder(sorted_keys, csr.N_BUCKETS), zmin,
                         span)
    zero = torch.zeros_like(g[:, :2])
    return torch.cat([g[:, 0:3], (g[:, 3] * g[:, 3])[:, None],
                      sorted_prims.to(torch.float32)[:, None], low[:, None],
                      zero], dim=1).contiguous()


def true_entry_count(prims: ScreenPrimitives, width: int, height: int,
                     tile_h: int = TILE_H, tile_w: int = TILE_W,
                     max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
                     no_triangles: bool = False) -> torch.Tensor:
    """() int32 binned (tile, prim) entries of this config
    (``pallas_csr2.true_entry_count``): a finite ``entry_capacity`` is
    exact iff it is at least this.  Capsules count as binned (the JAX
    function takes no ``discs_only``, so under it this over-counts)."""
    return csr.count_entries(prims, width, height, tile_h, tile_w,
                             max_tiles_per_prim, no_triangles)


def raster_tiles2(rows, starts, big_rows, big_n, width: int, height: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W,
                  no_triangles: bool = False, walked=None,
                  allow_exit: bool = True,
                  split_rows: int = csr6.SPLIT_ROWS):
    """The v2 walk -> (depth (H, W) f32 +inf-empty, index (H, W) i32
    -1-empty), as :func:`csr.raster_tiles1` over 16-float rows; 8-float
    disc rows hand the call to :func:`raster_tiles2_disc8`.  CUDA tensors
    launch the ``csr2_raster`` kernel of ``csrc/csr2_raster.cu``; CPU
    tensors take ``csr.raster_strips_plain``.  ``walked`` and
    ``allow_exit`` as in :func:`csr.raster_tiles1` (``walked`` sums a
    tile's passes of 1024 pixels).  A pass of a tile with more than
    ``split_rows`` rows (big rows included) is walked by several CTAs
    whose minima are merged; with the exit on they share their depths as
    they run, so ``walked`` may differ between runs, the images do not.
    ``.launches`` counts calls over 16-float rows."""
    if split_rows < 1:
        raise ValueError("split_rows must be >= 1")
    if rows.ndim == 2 and rows.shape[1] == ROW_F_DISC:
        return raster_tiles2_disc8(rows, starts, big_rows, big_n, width,
                                   height, tile_h, tile_w, walked,
                                   allow_exit)
    return csr.launch_strips(raster_tiles2, "csr2_raster", rows, starts,
                             big_rows, big_n, width, height, tile_h, tile_w,
                             no_triangles, walked, allow_exit, split_rows)


raster_tiles2.launches = 0


def raster_tiles2_disc8(rows, starts, big_rows, big_n, width: int,
                        height: int, tile_h: int = TILE_H,
                        tile_w: int = TILE_W, walked=None,
                        allow_exit: bool = True):
    """:func:`raster_tiles2` over the ``discs_only`` 8-float disc rows
    (covered where dx * dx + dy * dy <= r * r): the ``csr2_disc8`` kernel
    on CUDA tensors.  ``.launches`` counts launches."""
    return csr.launch_strips(raster_tiles2_disc8, "csr2_disc8", rows, starts,
                             big_rows, big_n, width, height, tile_h, tile_w,
                             False, walked, allow_exit)


raster_tiles2_disc8.launches = 0


def rasterize_csr2(prims: ScreenPrimitives, width: int, height: int,
                   tile_h: int = TILE_H, tile_w: int = TILE_W,
                   max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
                   max_big: int = DEFAULT_MAX_BIG, no_triangles: bool = False,
                   discs_only: bool = False,
                   entry_capacity: Optional[int] = None, plain: bool = False):
    """Bin, build the rows and walk the tiles -> (depth, index, diag)
    (``rasterize_pallas_csr2``, with the diag that the JAX package's
    ``render`` computes for this backend): ``diag["true_entries"]`` is
    :func:`true_entry_count` with ``no_triangles or discs_only``,
    ``diag["big_overflow"]`` the big prims past ``max_big``.

    ``discs_only`` walks 8-float disc rows (capsules and triangles ride the
    big list); ``no_triangles`` forces triangles onto the big list.  A
    finite ``entry_capacity`` keeps the first that many sorted entries;
    without one only the binned entries get rows (one host read of their
    count).  ``plain=True`` runs the plain walk on any device; otherwise
    the device decides."""
    csr6.check_id_range(prims)
    force_big = no_triangles or discs_only
    b = csr.bin_csr(prims, width, height, tile_h, tile_w, max_tiles_per_prim,
                    max_big, force_tri_big=force_big,
                    force_capsule_big=discs_only)
    starts = b["starts"]
    if entry_capacity is not None:
        n_rows = min(b["prims"].shape[0], int(entry_capacity))
        starts = torch.clamp(starts, max=n_rows)
    else:
        n_rows = int(starts[-1])
    pack = pack_rows_disc if discs_only else pack_rows_generic
    rows = pack(prims, b["prims"][:n_rows], b["keys"][:n_rows], b["zmin"],
                b["span"])
    walk = raster_strips_plain if plain else raster_tiles2
    depth, index = walk(rows, starts, csr.pack_big_rows(prims, b["big_ids"]),
                        b["big_n"], width, height, tile_h, tile_w,
                        no_triangles)
    diag = dict(
        true_entries=true_entry_count(prims, width, height, tile_h, tile_w,
                                      max_tiles_per_prim, force_big),
        big_overflow=torch.clamp(b["big_count"] - max_big, min=0).to(
            torch.int32))
    return depth, index, diag
