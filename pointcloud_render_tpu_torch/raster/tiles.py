"""Capacity-capped tile binning (PyTorch twin of
``pointcloud_render_tpu.raster.tiles``).

The screen is cut into ``tile_h`` x ``tile_w`` strips.  A valid primitive
whose bbox covers at most ``max_tiles_per_prim`` strips is binned into each
of them; wider ones go to the big list.  Each strip keeps its first
``max_per_tile`` entries in ascending primitive id, and the big list its
first ``max_big`` primitives in id order: the rest are dropped and
counted.  This is the binning of the JAX package's ``tiled`` backend,
which the shadow map (``shading/shadow.py``) and ``raster/alpha.py`` use;
the port mirrors its caps, so a frame that overflows them loses the same
entries as in the JAX package (ROADMAP queue C).

:func:`rasterize_tiled` is that backend: the kept entries become v1's
strip CSR (``raster/csr.py``: keyed by strip and depth bucket, sorted
stably, 16-float rows) and the ``csr1_raster`` kernel walks them on CUDA
tensors, its plain version on CPU tensors.  Within a strip the order of
the rows never changes the lexicographic (depth, id) winner, so the
z-bucket exit stays exact.

The JAX package expands every primitive into ``max_tiles_per_prim`` slots
and sorts them all; here only the live slots are expanded (prim-major, in
ascending strip order within a primitive), and a stable sort by strip
keeps each strip's entries in ascending primitive id, which is the same
table.
"""

from __future__ import annotations

import dataclasses

import torch

from pointcloud_render_tpu_torch.raster import csr, csr6
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives

TILE_H, TILE_W = 8, 128
MAX_PER_TILE = 512
MAX_TILES_PER_PRIM = 16
MAX_BIG = 64


@dataclasses.dataclass(frozen=True)
class TileBins:
    table: torch.Tensor  # (num_tiles, max_per_tile) int32 prim ids, -1 pad
    counts: torch.Tensor  # (num_tiles,) int32 true per-tile counts (uncapped)
    big_list: torch.Tensor  # (max_big,) int32 prim ids, -1 pad
    big_count: torch.Tensor  # () int32 true big-prim count (uncapped)
    tiles_y: int = 0
    tiles_x: int = 0

    @property
    def overflowed(self) -> torch.Tensor:
        """() int32: entries dropped by the two caps."""
        cap = self.table.shape[1]
        tile_drop = torch.clamp(self.counts - cap, min=0).sum()
        big_drop = torch.clamp(self.big_count - self.big_list.shape[0],
                               min=0)
        return (tile_drop + big_drop).to(torch.int32)


def _live_slots(prims: ScreenPrimitives, width: int, height: int,
                tile_h: int, tile_w: int, max_tiles_per_prim: int):
    """(tile ids, prim ids) of every binned entry in prim-major order (a
    prim's strips row-major over its bbox), the big mask, and the grid."""
    dev = prims.device
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)
    tx0, tx1, ty0, ty1 = csr6.tile_span(prims, tiles_x, tiles_y, tile_w,
                                        tile_h)
    ntx = tx1 - tx0 + 1
    span = ntx * (ty1 - ty0 + 1)
    is_big = (span > max_tiles_per_prim) & prims.valid
    is_small = (span <= max_tiles_per_prim) & prims.valid
    n_slots = torch.where(is_small, torch.clamp(span, min=0),
                          torch.zeros_like(span)).long()
    prim_id = torch.repeat_interleave(
        torch.arange(prims.count, device=dev), n_slots)
    first = torch.cumsum(n_slots, 0) - n_slots
    slot = torch.arange(prim_id.shape[0], device=dev) - first[prim_id]
    ntx_p = ntx.long()[prim_id]
    # Python's floor division and remainder, as jnp's (a zero width takes
    # no slot).
    ex = torch.remainder(slot, ntx_p)
    ey = torch.div(slot, ntx_p, rounding_mode="floor")
    tile_id = (ty0.long()[prim_id] + ey) * tiles_x + (tx0.long()[prim_id]
                                                      + ex)
    return tile_id, prim_id, is_big, tiles_x, tiles_y


def tile_overflow(prims: ScreenPrimitives, width: int, height: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W,
                  max_per_tile: int = MAX_PER_TILE,
                  max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
                  max_big: int = MAX_BIG) -> torch.Tensor:
    """() int32: the entries :func:`bin_primitives` drops at these caps,
    counted without the sort."""
    tile_id, _, is_big, tiles_x, tiles_y = _live_slots(
        prims, width, height, tile_h, tile_w, max_tiles_per_prim)
    counts = torch.bincount(tile_id, minlength=tiles_x * tiles_y)
    tile_drop = torch.clamp(counts - max_per_tile, min=0).sum()
    big_drop = torch.clamp(is_big.sum() - max_big, min=0)
    return (tile_drop + big_drop).to(torch.int32)


def bin_primitives(prims: ScreenPrimitives, width: int, height: int,
                   tile_h: int = TILE_H, tile_w: int = TILE_W,
                   max_per_tile: int = MAX_PER_TILE,
                   max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
                   max_big: int = MAX_BIG) -> TileBins:
    """The capped table and big list (``tiles.bin_primitives``)."""
    dev = prims.device
    tile_id, prim_id, is_big, tiles_x, tiles_y = _live_slots(
        prims, width, height, tile_h, tile_w, max_tiles_per_prim)
    num_tiles = tiles_x * tiles_y
    sorted_tiles, order = torch.sort(tile_id, stable=True)
    sorted_prims = prim_id[order]
    starts = torch.searchsorted(
        sorted_tiles, torch.arange(num_tiles + 1, device=dev))
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    rank = torch.arange(sorted_tiles.shape[0], device=dev) \
        - starts[sorted_tiles]
    keep = rank < max_per_tile
    table = torch.full((num_tiles * max_per_tile,), -1, dtype=torch.int32,
                       device=dev)
    table[sorted_tiles[keep] * max_per_tile + rank[keep]] = \
        sorted_prims[keep].to(torch.int32)
    big_rank = torch.cumsum(is_big.to(torch.int32), 0) - 1
    where = torch.where(is_big & (big_rank < max_big), big_rank,
                        torch.full_like(big_rank, max_big)).long()
    big_list = torch.full((max_big + 1,), -1, dtype=torch.int32, device=dev)
    big_list.scatter_(0, where, torch.arange(prims.count, dtype=torch.int32,
                                             device=dev))
    return TileBins(table=table.reshape(num_tiles, max_per_tile),
                    counts=counts, big_list=big_list[:max_big],
                    big_count=is_big.sum().to(torch.int32),
                    tiles_y=tiles_y, tiles_x=tiles_x)


def strip_rows(prims: ScreenPrimitives, bins: TileBins):
    """The kept entries as v1's strip CSR -> (rows (E, 16) float32, starts
    (T + 1,) int32, big_rows (max_big, 16) float32, big_n (1,) int32), the
    inputs of ``csr.raster_tiles1``: each kept (strip, prim) entry keyed
    ``strip * N_BUCKETS + bucket`` by ``csr.depth_buckets`` over the valid
    prims' depth hints, sorted stably; the big rows of the kept big
    list."""
    dev = prims.device
    num_tiles = bins.table.shape[0]
    kept = bins.table >= 0  # tile-major, ascending prim id in a tile
    tile = torch.arange(num_tiles, device=dev)[:, None].expand_as(
        bins.table)[kept]
    prim = bins.table[kept].long()
    bucket, (zmin, zspan) = csr.depth_buckets(csr.depth_hint(prims),
                                              prims.valid)
    keys, order = torch.sort(tile * csr.N_BUCKETS + bucket.long()[prim],
                             stable=True)
    starts = torch.searchsorted(
        keys, torch.arange(num_tiles + 1, device=dev) * csr.N_BUCKETS)
    rows = csr.pack_rows_generic(prims, prim[order].to(torch.int32),
                                 keys.to(torch.int32), zmin, zspan)
    big_n = torch.clamp(bins.big_count, max=bins.big_list.shape[0])
    return (rows, starts.to(torch.int32),
            csr.pack_big_rows(prims, bins.big_list),
            big_n.reshape(1).to(torch.int32))


def rasterize_tiled(prims: ScreenPrimitives, width: int, height: int,
                    tile_h: int = TILE_H, tile_w: int = TILE_W,
                    max_per_tile: int = MAX_PER_TILE, max_big: int = MAX_BIG):
    """The JAX package's capped ``tiled`` backend
    (``xla_tiled.rasterize_tiled``) -> (depth (H, W) float32 +inf-empty,
    index (H, W) int32 -1-empty, diag): :func:`bin_primitives` at these
    caps (``max_tiles_per_prim`` 16), then the ``csr1_raster`` walk over
    :func:`strip_rows` on CUDA tensors (its plain version on CPU
    tensors).  ``diag["dropped"]``: the entries the caps
    dropped (``TileBins.overflowed``, as :func:`tile_overflow`)."""
    csr6.check_id_range(prims)
    bins = bin_primitives(prims, width, height, tile_h, tile_w,
                          max_per_tile, max_big=max_big)
    depth, index = csr.raster_tiles1(*strip_rows(prims, bins), width, height,
                                     tile_h, tile_w)
    return depth, index, dict(dropped=bins.overflowed)
