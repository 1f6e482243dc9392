"""v1 strip-tile rasterizer and the binning it shares with v2: the
counterpart of ``pointcloud_render_tpu.raster.pallas_csr``.

Tiles are ``tile_h`` x ``tile_w`` strips (8 x 128 by default; any shape
works).  The stages around the kernel were XLA in the JAX package and are
torch ops here:

1. :func:`bin_csr` — ``_bin_csr``: a prim whose bbox covers at most
   ``max_tiles_per_prim`` tiles is expanded prim-major into one entry per
   tile, keyed ``tile * N_BUCKETS + bucket`` with the bucket of its depth
   hint (:func:`depth_buckets`), and the keys are sorted stably, so the
   order is (key, prim id) and a tile's entries are one range, front to
   back by bucket.  Wider prims, and whole kinds under the force flags,
   ride the big list by rank in prim order, truncated at ``max_big``;
2. :func:`pack_rows_generic` — the v1 row build (``pallas_csr.py:256-267``,
   ``pallas_csr2._pack_rows_generic``): one 16-float row [params 0..11,
   id, kind, bucket_low, 0] per sorted entry, built for the binned entries
   only (the TPU padded and gathered the sentinels too);
3. :func:`raster_tiles1` — the ``csr1_raster`` kernel of
   ``csrc/csr2_raster.cu`` on CUDA tensors (v2's split walk: the big list
   first, then the tile's rows with the saturation early exit, dense
   strips cut into work items), :func:`raster_strips_plain` (shared with
   v2) on CPU tensors.

:func:`bin_diagnostics` and :func:`true_entry_count` (in
``raster/csr2.py``) are the certificates; v1 is out of the JAX package's
backend dispatch and is reached through :func:`rasterize_csr`.

Contract: winner per pixel = lexicographic min of (depth, primitive id);
depth +inf and index -1 where empty.  Ids ride the rows as float32, so a
soup must hold fewer than 2^24 primitives.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_CAPSULE,
    KIND_TRIANGLE,
    ScreenPrimitives,
)
from pointcloud_render_tpu_torch.utils.consts import const

N_BUCKETS = 16
TILE_H, TILE_W = 8, 128
ROW_F = 16
ROW_F_DISC = 8
DEFAULT_MAX_BIG = 1024
MAX_TILES_PER_PRIM = 8  # rasterize_pallas_csr's default


def strip_grid(width: int, height: int, tile_h: int = TILE_H,
               tile_w: int = TILE_W):
    """(tiles_x, tiles_y) of the strip-tile grid (edge tiles partial)."""
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile shape {tile_h}x{tile_w} must be positive")
    return -(-width // tile_w), -(-height // tile_h)


def depth_buckets(hint, valid):
    """``_depth_buckets``: buckets linear over the valid prims' [zmin,
    zmax] of ``hint`` -> (bucket (P,) int32 in [0, N_BUCKETS), (zmin,
    span)), the arguments of :func:`bucket_low`."""
    dev = hint.device
    big = const(3.0e38, np.float32, dev)
    zmin = torch.where(valid, hint, big).amin()
    zmax = torch.where(valid, hint, -big).amax()
    span = torch.maximum(zmax - zmin, const(1e-6, np.float32, dev))
    scale = const(N_BUCKETS, np.float32, dev) / span
    # XLA's float->int convert truncates and saturates (NaN -> 0); the
    # clip to the buckets follows.
    q = torch.nan_to_num((hint - zmin) * scale, nan=0.0)
    q = torch.clamp(q, -1.0, float(N_BUCKETS)).to(torch.int32)
    return torch.clamp(q, 0, N_BUCKETS - 1), (zmin, span)


def depth_hint(prims: ScreenPrimitives) -> torch.Tensor:
    """(P,) the bucket map's depth hint: a disc's z, a capsule's nearer
    endpoint z (both at most every depth the prim takes); 0 for triangles,
    which thus sort first in their tile (bucket 0)."""
    hint = prims.params[:, 2] + torch.clamp(prims.params[:, 6], max=0.0)
    return torch.where(prims.kind == KIND_TRIANGLE, torch.zeros_like(hint),
                       hint)


def bucket_low(bucket, zmin, span):
    """A conservative lower bound of every depth in ``bucket``:
    ``zmin + bucket * (span / N_BUCKETS) - 1e-3 * span`` (the margin
    covers the rounding of the forward map)."""
    dev = span.device
    step = span / const(N_BUCKETS, np.float32, dev)
    margin = const(1e-3, np.float32, dev) * span
    return zmin + bucket.to(torch.float32) * step - margin


def _classify(prims: ScreenPrimitives, tiles_x: int, tiles_y: int,
              tile_h: int, tile_w: int, max_tiles_per_prim: int,
              force_tri_big: bool, force_capsule_big: bool):
    """(tx0, ty0, ntx, nty, span, is_big, is_small) of each prim."""
    tx0, tx1, ty0, ty1 = csr6.tile_span(prims, tiles_x, tiles_y, tile_w,
                                        tile_h)
    ntx, nty = tx1 - tx0 + 1, ty1 - ty0 + 1
    span = ntx * nty
    is_big = (span > max_tiles_per_prim) & prims.valid
    if force_tri_big:
        is_big = is_big | ((prims.kind == KIND_TRIANGLE) & prims.valid)
    if force_capsule_big:
        is_big = is_big | ((prims.kind == KIND_CAPSULE) & prims.valid)
    is_small = prims.valid & ~is_big
    return tx0, ty0, ntx, nty, span, is_big, is_small


def bin_csr(prims: ScreenPrimitives, width: int, height: int,
            tile_h: int = TILE_H, tile_w: int = TILE_W,
            max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
            max_big: int = DEFAULT_MAX_BIG, force_tri_big: bool = False,
            force_capsule_big: bool = False) -> dict:
    """The v1/v2 binning (``pallas_csr._bin_csr``) -> dict of device
    tensors (T = tiles, M = ``max_tiles_per_prim``):
      keys       (P*M,) int32 sorted keys tile * 16 + bucket (T * 16 for
                 the slots that bin nowhere, which sort last);
      prims      (P*M,) int32 prim ids in key order (stable: ties by id);
      starts     (T+1,) int32 — tile t's entries are [starts[t],
                 starts[t+1]); starts[T] = the binned entry count;
      big_ids    (max_big,) int32 big prims by rank in prim order, -1 in
                 empty slots; big_n (1,) int32 min(big_count, max_big);
      big_count  () int32 number of big prims;
      zmin, span () float32 the bucket map's (:func:`bucket_low`).
    ``force_tri_big`` / ``force_capsule_big`` push every valid triangle /
    capsule onto the big list.
    """
    dev = prims.device
    p = prims.count
    tiles_x, tiles_y = strip_grid(width, height, tile_h, tile_w)
    num_tiles = tiles_x * tiles_y
    tx0, ty0, ntx, nty, span, is_big, is_small = _classify(
        prims, tiles_x, tiles_y, tile_h, tile_w, max_tiles_per_prim,
        force_tri_big, force_capsule_big)
    slot = torch.arange(max_tiles_per_prim, dtype=torch.int32,
                        device=dev)[None, :]
    # Python's floor division and remainder, as jnp's; a zero width (only
    # where no slot is taken) divides by one instead.
    ntx_safe = torch.where(ntx == 0, torch.ones_like(ntx), ntx)[:, None]
    ex = torch.remainder(slot, ntx_safe)
    ey = torch.div(slot, ntx_safe, rounding_mode="floor")
    slot_ok = (slot < span[:, None]) & is_small[:, None]
    tile_id = (ty0[:, None] + ey) * tiles_x + (tx0[:, None] + ex)
    bucket, (zmin, zspan) = depth_buckets(depth_hint(prims),
                                          is_small | is_big)
    sentinel = num_tiles * N_BUCKETS
    key = torch.where(slot_ok & (tile_id < num_tiles),
                      tile_id * N_BUCKETS + bucket[:, None],
                      torch.full_like(tile_id, sentinel)).reshape(-1)
    keys, order = torch.sort(key, stable=True)
    sorted_prims = torch.div(order, max_tiles_per_prim,
                             rounding_mode="floor").to(torch.int32)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32,
                          device=dev) * N_BUCKETS
    starts = torch.searchsorted(keys, bounds).to(torch.int32)
    # The big list by rank in prim order; slot max_big takes the rest.
    rank = torch.cumsum(is_big.to(torch.int32), 0) - 1
    where = torch.where(is_big & (rank < max_big), rank,
                        torch.full_like(rank, max_big)).long()
    big_ids = torch.full((max_big + 1,), -1, dtype=torch.int32, device=dev)
    big_ids.scatter_(0, where, torch.arange(p, dtype=torch.int32,
                                            device=dev))
    big_count = is_big.to(torch.int32).sum().to(torch.int32)
    return dict(keys=keys.to(torch.int32), prims=sorted_prims, starts=starts,
                big_ids=big_ids[:max_big],
                big_n=torch.clamp(big_count, max=max_big).reshape(1)
                .to(torch.int32),
                big_count=big_count, zmin=zmin, span=zspan)


def bin_diagnostics(prims: ScreenPrimitives, width: int, height: int,
                    tile_h: int = TILE_H, tile_w: int = TILE_W,
                    max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
                    max_big: int = 256, no_triangles: bool = False,
                    discs_only: bool = False) -> torch.Tensor:
    """() int32 big-list overflow of a v1/v2 config
    (``pallas_csr.bin_diagnostics``): 0 = every prim is rasterized.  The
    flags mirror the render config (``discs_only`` big-lists every
    capsule and triangle, ``no_triangles`` every triangle)."""
    tiles_x, tiles_y = strip_grid(width, height, tile_h, tile_w)
    is_big = _classify(prims, tiles_x, tiles_y, tile_h, tile_w,
                       max_tiles_per_prim, no_triangles or discs_only,
                       discs_only)[5]
    return torch.clamp(is_big.to(torch.int32).sum() - max_big,
                       min=0).to(torch.int32)


def count_entries(prims: ScreenPrimitives, width: int, height: int,
                  tile_h: int, tile_w: int, max_tiles_per_prim: int,
                  force_tri_big: bool) -> torch.Tensor:
    """() int32 binned entries of :func:`bin_csr` (capsules binned): one
    per tile of each binned prim, counted without the sort."""
    tiles_x, tiles_y = strip_grid(width, height, tile_h, tile_w)
    _, _, _, _, span, _, is_small = _classify(
        prims, tiles_x, tiles_y, tile_h, tile_w, max_tiles_per_prim,
        force_tri_big, False)
    return torch.where(is_small, torch.clamp(span, min=0),
                       torch.zeros_like(span)).sum().to(torch.int32)


def pack_rows_generic(prims: ScreenPrimitives, sorted_prims, sorted_keys,
                      zmin, span) -> torch.Tensor:
    """(E, 16) float32 rows of the sorted entries (the v1 row build,
    ``pallas_csr2._pack_rows_generic``): [params 0..11, id, kind,
    bucket_low of the entry's bucket, 0]."""
    ids = torch.clamp(sorted_prims, min=0).long()
    low = bucket_low(torch.remainder(sorted_keys, N_BUCKETS), zmin, span)
    zero = torch.zeros_like(low)
    return torch.cat([prims.params[ids],
                      sorted_prims.to(torch.float32)[:, None],
                      prims.kind[ids].to(torch.float32)[:, None],
                      low[:, None], zero[:, None]], dim=1).contiguous()


def pack_big_rows(prims: ScreenPrimitives, big_ids) -> torch.Tensor:
    """(max_big, 16) float32 big rows: [params 0..11, id, kind, 0, 0] (kind
    -1 in the empty slots, which no walk reads)."""
    ids = torch.clamp(big_ids, min=0).long()
    live = (big_ids >= 0) & prims.valid[ids]
    kind = torch.where(live, prims.kind[ids], torch.full_like(big_ids, -1))
    zero = torch.zeros((big_ids.shape[0], 2), dtype=torch.float32,
                       device=big_ids.device)
    return torch.cat([prims.params[ids], big_ids.to(torch.float32)[:, None],
                      kind.to(torch.float32)[:, None], zero],
                     dim=1).contiguous()


# ---------------------------------------------------------------------------
# The walk: kernel wrapper and plain version (shared with v2)
# ---------------------------------------------------------------------------

def check_walk_inputs(rows, starts, big_rows, big_n, width, height, tile_h,
                      tile_w, walked=None, row_widths=(ROW_F,)):
    """Validate a strip walk's inputs -> (tiles_x, tiles_y)."""
    tiles_x, tiles_y = strip_grid(width, height, tile_h, tile_w)
    if (rows.dtype != torch.float32 or rows.ndim != 2
            or rows.shape[1] not in row_widths):
        widths = " or ".join(map(str, row_widths))
        raise ValueError(f"rows must be (E, {widths}) float32")
    if (big_rows.dtype != torch.float32 or big_rows.ndim != 2
            or big_rows.shape[1] != ROW_F):
        raise ValueError("big_rows must be (B, 16) float32")
    for name, t in (("starts", starts), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != tiles_x * tiles_y + 1:
        raise ValueError("starts does not match the tile grid")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    if walked is not None and (walked.dtype != torch.int32
                               or walked.shape != (tiles_x * tiles_y,)
                               or walked.device != rows.device
                               or not walked.is_contiguous()):
        raise ValueError("walked must be a contiguous (T,) int32 tensor on "
                         "the rows' device")
    csr6._check_one_device(rows, starts, big_rows, big_n)
    return tiles_x, tiles_y


def launch_strips(wrapper, symbol, rows, starts, big_rows, big_n, width,
                  height, tile_h, tile_w, no_triangles, walked, allow_exit,
                  split_rows=csr6.SPLIT_ROWS, bands=None):
    """Launch ``symbol`` of ``csrc/csr2_raster.cu`` (``csr1_raster``,
    ``csr2_raster`` or ``csr2_disc8``, one split walk: plan, walk, merge
    through ``csr6._launch_walk``) on CUDA tensors, the plain walk on CPU
    tensors, and count the call on ``wrapper``.  ``csr2_disc8`` also
    reports ``bands``, which CPU tensors take from :func:`segment_rows`."""
    disc = symbol == "csr2_disc8"
    row_widths = (ROW_F_DISC,) if disc else (ROW_F,)
    tiles_x, tiles_y = check_walk_inputs(rows, starts, big_rows, big_n,
                                         width, height, tile_h, tile_w,
                                         walked, row_widths)
    if split_rows < 1:
        raise ValueError("split_rows must be >= 1")
    if bands is not None and (bands.dtype != torch.int32
                              or bands.shape != (tiles_x * tiles_y,)
                              or bands.device != rows.device
                              or not bands.is_contiguous()):
        raise ValueError("bands must be a contiguous (T,) int32 tensor on "
                         "the rows' device")
    if rows.device.type == "cpu":
        if walked is not None:  # every row, once per pass of 1024 pixels
            walked.copy_((starts[1:] - starts[:-1])
                         * -(-tile_h * tile_w // UNIT_PIX))
        if bands is not None:
            bands.copy_(segment_rows(rows, starts, width, height, tile_h,
                                     tile_w))
        return _plain_strip_walk(rows, starts, big_rows, big_n, width,
                                 height, tile_h, tile_w, no_triangles)
    if rows.device.type != "cuda":
        raise ValueError(f"no {symbol} kernel for device {rows.device}")
    rows, starts, big_rows, big_n = (
        t.contiguous() for t in (rows, starts, big_rows, big_n))
    dev = rows.device
    # A unit is one pass of 1024 pixels of a strip.  The exit's depths
    # shared by a split unit's items (the kernel's plan resets those it
    # reads).
    units = tiles_x * tiles_y * -(-tile_h * tile_w // UNIT_PIX)
    front = torch.empty((units, UNIT_PIX), dtype=torch.int32,
                        device=dev) if allow_exit else None
    ptrs = (rows, starts, big_rows, big_n, front, walked)
    if disc:
        if bands is not None:
            bands.zero_()
        ptrs += (bands,)
    return csr6._launch_walk(
        symbol, wrapper, ptrs,
        ((rows, 4 * rows.shape[1]), (big_rows, 4 * ROW_F)),
        big_rows.shape[0], width, height, tiles_x, tiles_y,
        (tile_h, tile_w, int(no_triangles), int(allow_exit)),
        split_rows, dev, units, library="csr2_raster")


# Pixels of a unit of the strip walks (a pass of a strip), and a warp's
# share of them.
UNIT_PIX = 1024
WARPS = 8


def _unit_layout(tile_w: int, device) -> torch.Tensor:
    """(8, 128) int64: the unit pixels of each warp of csr2_disc8
    (``csrc/csr2_raster.cu`` unit_layout): at strip widths 32, 64, 128
    and 256 a block of 32 columns x 4 rows (warp w: rows 4 (w // S) + k,
    columns 32 (w % S) + lane, S = tile_w // 32), else tid + 256 k."""
    w = torch.arange(WARPS, device=device)[:, None, None]
    lane = torch.arange(32, device=device)[None, :, None]
    k = torch.arange(4, device=device)[None, None, :]
    if tile_w in (32, 64, 128, 256):
        s = tile_w // 32
        i = ((w // s) * 4 + k) * tile_w + (w % s) * 32 + lane
    else:
        i = w * 32 + lane + 256 * k
    return i.reshape(WARPS, 128)


def _footprints(width, height, tile_h, tile_w, seg_rows, device):
    """((T, F, 4) float32 boxes (xlo, xhi, ylo, yhi) of pixel centres,
    (T, F) bool: the box holds a pixel of the strip and the image) of each
    strip's footprints: with ``seg_rows`` None the warps of csr2_disc8's
    units (a unit per pass of 1024 pixels), their pixels inside the image;
    with ``seg_rows`` 1 the 32-column segments of each pixel row (clipped
    to the strip and the image)."""
    tiles_x, tiles_y = strip_grid(width, height, tile_h, tile_w)
    tx = torch.arange(tiles_x * tiles_y, device=device) % tiles_x
    ty = torch.arange(tiles_x * tiles_y, device=device) // tiles_x
    inf = float("inf")
    if seg_rows is None:
        npix = tile_h * tile_w
        passes = -(-npix // UNIT_PIX)
        i = _unit_layout(tile_w, device)
        p = (torch.arange(passes, device=device)[:, None, None] * UNIT_PIX
             + i[None]).reshape(-1, 128)  # (F, 128)
        col = tx[:, None, None] * tile_w + (p % tile_w)[None]
        row = ty[:, None, None] * tile_h + (p // tile_w)[None]
        valid = (p < npix)[None] & (col < width) & (row < height)
        qx = col.to(torch.float32) + 0.5
        qy = row.to(torch.float32) + 0.5
        box = torch.stack([torch.where(valid, qx, inf).amin(-1),
                           torch.where(valid, qx, -inf).amax(-1),
                           torch.where(valid, qy, inf).amin(-1),
                           torch.where(valid, qy, -inf).amax(-1)], dim=-1)
        return box, valid.any(-1)
    if seg_rows != 1:
        raise ValueError("seg_rows must be None or 1")
    segs = -(-tile_w // 32)
    r = torch.arange(tile_h, device=device).repeat_interleave(segs)
    j = torch.arange(segs, device=device).repeat(tile_h)
    c0 = tx[:, None] * tile_w + 32 * j[None]
    c1 = torch.minimum(torch.minimum(c0 + 31, tx[:, None] * tile_w
                                     + tile_w - 1),
                       torch.full_like(c0, width - 1))
    row = ty[:, None] * tile_h + r[None]
    box = torch.stack([c0.to(torch.float32) + 0.5,
                       c1.to(torch.float32) + 0.5,
                       row.to(torch.float32) + 0.5,
                       row.to(torch.float32) + 0.5], dim=-1)
    return box, (c0 <= c1) & (row < height)


def box_keeps(px, py, r2, box):
    """csr2_disc8's cull (``csrc/csr2_raster.cu`` eval_disc_rows): whether
    a disc row at (px, py) with squared radius r2 is evaluated for a
    footprint whose pixel centres lie in ``box`` = (xlo, xhi, ylo, yhi):
    not when fl(fl(dx * dx) + fl(dy * dy)) > r2 at the box's centre
    nearest to the disc's (per axis clamp(floor(p) + 0.5, box)), which no
    centre of the box can then pass (exact; NaN never skips)."""
    xlo, xhi, ylo, yhi = box.unbind(-1)
    dx = torch.minimum(torch.maximum(torch.floor(px) + 0.5, xlo), xhi) - px
    dy = torch.minimum(torch.maximum(torch.floor(py) + 0.5, ylo), yhi) - py
    return ~(dx * dx + dy * dy > r2)


def segment_rows(rows, starts, width: int, height: int,
                 tile_h: int = TILE_H, tile_w: int = TILE_W,
                 seg_rows=None) -> torch.Tensor:
    """(T,) int32: the (binned disc row, footprint) pairs of each strip
    that :func:`box_keeps` keeps, every row of the strip's range at each
    footprint that holds an image pixel.  With ``seg_rows`` None the
    footprints are csr2_disc8's warps in each pass of the strip: the pairs
    its cull evaluates with every row walked (its ``bands``).  With
    ``seg_rows`` 1 they are the 32-column segments of each pixel row: the
    (row, pixel row, segment) pairs that some pixel of the disc could
    cover, the work the function needs."""
    dev = starts.device
    n = int(starts[-1])
    box, live = _footprints(width, height, tile_h, tile_w, seg_rows, dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    px, py, r2 = rows[:n, 0], rows[:n, 1], rows[:n, 3]
    kept = torch.zeros(n, dtype=torch.int64, device=dev)
    for f in range(box.shape[1]):
        keep = box_keeps(px, py, r2, box[tile, f]) & live[tile, f]
        kept += keep.to(torch.int64)
    counts = torch.zeros(starts.shape[0] - 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, tile, kept)
    return counts.to(torch.int32)


def raster_tiles1(rows, starts, big_rows, big_n, width: int, height: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W,
                  no_triangles: bool = False, walked=None,
                  allow_exit: bool = True, split_rows: int = csr6.SPLIT_ROWS):
    """The v1 walk -> (depth (H, W) f32 +inf-empty, index (H, W) i32
    -1-empty): per tile, the live big rows ``big_rows[:big_n]`` through
    the triangle-aware body, then its sorted 16-float rows [starts[t],
    starts[t+1]) (the capsule body alone under ``no_triangles``) with the
    saturation early exit.  CUDA tensors launch the ``csr1_raster`` kernel
    of ``csrc/csr2_raster.cu``, v2's split walk; CPU tensors take
    :func:`raster_strips_plain`.  ``walked``, a (T,) int32 tensor, takes
    each tile's count of rows evaluated before its exit, summed over its
    passes of 1024 pixels (every row once per pass on the plain walk,
    which has no exit); ``allow_exit=False`` walks every row (the same
    images).  A pass of a tile with more than ``split_rows`` rows (big
    rows included) is walked by several CTAs whose minima are merged;
    with the exit on they share their depths as they run, so ``walked``
    may differ between runs, the images do not.  ``.launches`` counts
    calls."""
    return launch_strips(raster_tiles1, "csr1_raster", rows, starts,
                         big_rows, big_n, width, height, tile_h, tile_w,
                         no_triangles, walked, allow_exit, split_rows)


raster_tiles1.launches = 0


def _as_table16(rows):
    """Generic v1/v2 rows in the 16-float table layout of ``csr6``
    ([params 0..8, id, params 9..11, 0, bucket_low, triangle flag]), which
    its windows and evaluation read."""
    zero = torch.zeros_like(rows[:, :1])
    return torch.cat([rows[:, 0:9], rows[:, 12:13], rows[:, 9:12], zero,
                      rows[:, 14:15], (rows[:, 13:14] == KIND_TRIANGLE).to(
                          torch.float32)], dim=1)


def raster_strips_plain(rows, starts, big_rows, big_n, width: int,
                        height: int, tile_h: int = TILE_H,
                        tile_w: int = TILE_W, no_triangles: bool = False):
    """Plain PyTorch version of the v1 and v2 walks (:func:`raster_tiles1`,
    ``csr2.raster_tiles2`` and ``csr2.raster_tiles2_disc8``), on any
    device: each binned row (16-float generic, through the capsule body
    alone under ``no_triangles``, or 8-float disc) over its tile's pixels,
    each live big row over the image, both clipped to a window that
    provably holds every covered pixel, merged by the two-step
    lexicographic min.  No early exit: the exit never changes a
    winner."""
    check_walk_inputs(rows, starts, big_rows, big_n, width, height, tile_h,
                      tile_w, row_widths=(ROW_F, ROW_F_DISC))
    return _plain_strip_walk(rows, starts, big_rows, big_n, width, height,
                             tile_h, tile_w, no_triangles)


def _plain_strip_walk(rows, starts, big_rows, big_n, width, height, tile_h,
                      tile_w, no_triangles):
    dev = rows.device
    tiles_x, _ = strip_grid(width, height, tile_h, tile_w)
    n = int(starts[-1])
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    tx, ty = tile % tiles_x, tile // tiles_x
    rect = (tx * tile_w, torch.clamp((tx + 1) * tile_w, max=width),
            ty * tile_h, torch.clamp((ty + 1) * tile_h, max=height))
    binned = rows[:n]
    if rows.shape[1] == ROW_F_DISC:
        group = csr6._pair_group(binned, csr6._windows8(binned, rect),
                                 csr6._eval8, width, False)
    else:
        t16 = _as_table16(binned)
        group = csr6._pair_group(
            t16, csr6._windows16(t16, rect, not no_triangles),
            functools.partial(csr6._eval16, tri=not no_triangles), width,
            False)
    nb = int(big_n[0])
    big = _as_table16(big_rows[:nb])
    groups = [group,
              csr6._pair_group(big, csr6._windows16(
                  big, csr6._full_rect(nb, width, height, dev)),
                  csr6._eval16, width, False)]
    return csr6._merge_plain(groups, width, height, dev, False)


def rasterize_csr(prims: ScreenPrimitives, width: int, height: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W,
                  max_tiles_per_prim: int = MAX_TILES_PER_PRIM,
                  max_big: int = DEFAULT_MAX_BIG, no_triangles: bool = False,
                  plain: bool = False):
    """Bin, build the rows and walk the tiles -> (depth, index, diag)
    (``rasterize_pallas_csr``; its ``max_big`` is honoured).  Every binned
    entry is rasterized; the big list is the only capacity:
    ``diag["big_overflow"]`` counts the big prims past ``max_big`` and
    ``diag["true_entries"]`` the binned entries.  ``no_triangles`` forces
    triangles onto the big list and walks the binned rows through the
    capsule body alone.  ``plain=True`` runs the plain walk on any
    device; otherwise the device decides."""
    csr6.check_id_range(prims)
    b = bin_csr(prims, width, height, tile_h, tile_w, max_tiles_per_prim,
                max_big, force_tri_big=no_triangles)
    n = int(b["starts"][-1])
    rows = pack_rows_generic(prims, b["prims"][:n], b["keys"][:n],
                             b["zmin"], b["span"])
    walk = raster_strips_plain if plain else raster_tiles1
    depth, index = walk(rows, b["starts"], pack_big_rows(prims, b["big_ids"]),
                        b["big_n"], width, height, tile_h, tile_w,
                        no_triangles)
    diag = dict(true_entries=b["starts"][-1],
                big_overflow=torch.clamp(b["big_count"] - max_big,
                                         min=0).to(torch.int32))
    return depth, index, diag
