"""v6 anchor-sorted tile rasterizer: binning, tables, the CUDA kernel's
wrapper and its plain PyTorch version, and the shade epilogue.

The counterpart of ``pointcloud_render_tpu.raster.pallas_csr6`` with the
big list for wide prims and the ground, in its row modes: the generic
16-float rows (discs and capsules binned, and under ``bin_triangles``
small triangles too, through the triangle-aware dual evaluation: the
mesh-LOD droplets) at span 2, 4 or 8; ``cap_rows10``, the same walk over
10-float rows without the triangle and shade lanes (bit-identical
winners; triangles ride the big list); the kind-split 9-float rows
(rows8/rows9) at span 2, 4 or 8; and the ``discs_only`` 8-float disc
rows at span 2, 4 or 8 (capsules and triangles ride the big list), also
with the winner's lambert (u, v) carried through the merge for the
gather-free two-tone shade.  The stages around the kernels were XLA in the JAX
package and are torch ops here:

1. ``preshade``      — ``pallas_csr3._preshade``: per-prim rgb and flag;
2. ``bin_csr6``      — ``_bin_csr6``: one unstable sort of per-prim
   (anchor tile, spill class) keys (with ``with_z``, the exit's
   ``((anchor * span^2 + class) << ZQ) | z-bucket`` int32 keys and
   ``zmeta``); the sorted tail past the binned keys is the big list,
   truncated at ``max_big``; the range ``starts`` by ``searchsorted``;
   ``diag`` with ``big_overflow`` and ``true_entries``;
3. ``build_table16`` — ``pallas_csr4._build_table16``: (P+1, 16) rows;
   under ``cap_rows10`` ``build_table10`` ((P+1, 10) capsule rows), under
   ``discs_only`` ``build_rows8`` ((P, 8) disc rows in sorted order:
   ``build_table8``'s rows gathered by ``order``), each with
   ``build_table16_rows`` (16-float rows at the big ids only);
4. the tile walk: ``raster_tiles`` (16-float rows), ``raster_tiles_cap10``
   (10-float rows), ``raster_tiles_rows9`` (9-float rows),
   ``raster_tiles_disc8`` and ``raster_tiles_disc8_uv`` (8-float rows) —
   the kernels of ``csrc/csr6_raster.cu`` on CUDA tensors, the
   ``*_plain`` versions on CPU tensors;
5. ``shade_by_id``   — the ``pallas_csr4._shade_by_id`` epilogue (generic
   and ``uniform_look``); ``shade_uv`` — the gather-free
   ``pallas_csr6._shade_uv`` epilogue over the fused (u, v) images.

The 16-float walk takes the TPU kernel's z-bucket early exit
(``allow_exit``; on by default for generic soups at span 2, as in the
JAX package): each tile walks its nine single-class segments, each
ascending in the z-bucket of its rows' depth lower bound, and leaves a
segment once no later row of it can win a pixel.  The exit never changes
a winner; the plain versions walk every row.  The disc rows take it
only forced on (span 2, not the fused (u, v) walk); the kind-split rows
and ``cap_rows10`` walk without it.

Contract: winner per pixel = lexicographic min of (depth, primitive id);
depth +inf and index -1 where empty.  Ids ride the rows as float32, so a
soup must hold fewer than 2^24 primitives.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    KIND_TRIANGLE,
    ScreenPrimitives,
)
from pointcloud_render_tpu_torch.shading.shade import (
    background,
    check_supported,
    key_light,
    pixel_centers,
)
from pointcloud_render_tpu_torch.utils.consts import const
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

TILE = 32
SPAN = 2
# Binning spans: prims whose bbox covers at most span x span tiles are
# binned.  Every walk takes all three.
SPANS = (2, 4, 8)
ROW_F = 16
ROW_F10 = 10
ROW_F_DISC = 8
ROW_F9 = 9
DEFAULT_MAX_BIG = 1024
# The fused (u, v) walk keeps the JAX package's precondition: a big list
# of at most FUSED_MAX_BIG rows (its resident big-list chunk, less the pad
# row).
FUSED_MAX_BIG = 511
F_EMPTY = float(1 << 24)  # > every representable prim id
# z-bucket bits in the exit's int32 sort key (256 buckets).
ZQ = 8
# Rows a work item of the 16-, 10- and 9-float walks (and of the v2 strip
# walk, csr2.py) takes at least: a tile with more rows (its big list and
# binned ranges) is cut into several items, each walked by its own CTA,
# whose (depth, id) minima a second pass merges.  ITEMS_PER_TILE bounds
# the items of one call (the items grow past SPLIT_ROWS rows when a frame
# would need more).
SPLIT_ROWS = 2048
ITEMS_PER_TILE = 4
# Rows a work item of the disc walks (csr6_disc8, csr6_disc8_uv) takes at
# least: a disc row costs about a quarter of a capsule row.
SPLIT_ROWS_DISC = 1024
# Pixel rows of a warp's band in the disc walks (the pixels of one
# thread, consecutive rows of one column): the unit of their cull.
BAND_ROWS = 4
# Pair budget of one chunk of the plain rasterizer (bounds its memory).
PLAIN_PAIR_CHUNK = 1 << 23


def grid_shape(width: int, height: int):
    """(tiles_x, tiles_y) of the 32x32 tile grid (edge tiles partial)."""
    return -(-width // TILE), -(-height // TILE)


def class_spill(span: int):
    """(spill_x, spill_y) per class ordinal: how many tiles past its
    anchor a prim of that class reaches.  Span 2 uses the reordered
    ordinals (0 = none, 1 = x-spill, 2 = both, 3 = y-spill); wider spans
    the row-major sy * span + sx."""
    if span == 2:
        return (0, 1, 1, 0), (0, 0, 1, 1)
    return (tuple(c % span for c in range(span * span)),
            tuple(c // span for c in range(span * span)))


# ---------------------------------------------------------------------------
# Binning (pallas_csr6._bin_csr6)
# ---------------------------------------------------------------------------

def check_id_range(prims: ScreenPrimitives) -> None:
    """Ids ride the rows as float32: a soup must hold < 2^24 prims."""
    if prims.count >= (1 << 24):
        raise ValueError("float id encoding supports < 2^24 primitives")


def tile_of(v: torch.Tensor, size: int, n: int) -> torch.Tensor:
    """int32 ``clip(floor(v / size), 0, n - 1)`` as XLA evaluates it: the
    divisor is a float32 tensor (a CUDA division by a Python scalar
    multiplies by its reciprocal), and the float->int convert saturates
    and maps NaN to 0 (torch's cast of an out-of-range float does not)."""
    f = torch.nan_to_num(torch.floor(v / const(size, np.float32, v.device)),
                         nan=0.0)
    f = torch.clamp(f, -1.0, float(n))
    return torch.clamp(f.to(torch.int32), 0, n - 1)


def tile_span(prims: ScreenPrimitives, tiles_x: int, tiles_y: int,
              tile_w: int = TILE, tile_h: int = TILE):
    """(tx0, tx1, ty0, ty1) int32: the first and last tile column and row
    of each prim's bbox on a grid of ``tile_w`` x ``tile_h`` tiles,
    clipped to the grid (:func:`tile_of`)."""
    return (tile_of(prims.bbox[:, 0], tile_w, tiles_x),
            tile_of(prims.bbox[:, 1], tile_w, tiles_x),
            tile_of(prims.bbox[:, 2], tile_h, tiles_y),
            tile_of(prims.bbox[:, 3], tile_h, tiles_y))


def binnable_kinds(prims: ScreenPrimitives, discs_only: bool = False,
                   bin_triangles: bool = False) -> torch.Tensor:
    """Which prims may bin: discs; capsules unless ``discs_only``;
    triangles too under ``bin_triangles`` (the mesh-LOD droplet mode)."""
    binnable = prims.kind == KIND_DISC
    if not discs_only:
        binnable = binnable | (prims.kind == KIND_CAPSULE)
        if bin_triangles:
            binnable = binnable | (prims.kind == KIND_TRIANGLE)
    return binnable


def key_layout(num_tiles: int, span: int, with_z: bool,
               kind_split: bool = False):
    """(dtype, shift) of the v6 sort key (``pallas_csr6._key_layout``):
    the exit's keys pack the z-bucket into the low ``ZQ`` bits of an
    int32; exit-off keys are the bare (anchor, class) ordinals, int16
    where the grid fits.  Raises where the int32 key cannot hold the
    grid."""
    n_keys = (2 if kind_split else 1) * num_tiles * span * span
    shift = ZQ if with_z else 0
    if (n_keys + 2) << shift >= 1 << 31:
        raise ValueError("tile grid too large for the int32 v6 key")
    if not with_z and n_keys + 2 <= np.iinfo(np.int16).max:
        return torch.int16, 0
    return torch.int32, shift


def bin_csr6(prims: ScreenPrimitives, width: int, height: int,
             max_big: int = DEFAULT_MAX_BIG,
             discs_only: bool = False, span: int = SPAN,
             kind_split: bool = False, bin_triangles: bool = False,
             with_z: bool = False, zlb=None) -> dict:
    """Per-prim (anchor, class) keys, one unstable sort, CSR range starts.

    ``discs_only`` bins discs alone: capsules join the triangles and the
    wide discs on the big list (the 8-float row mode).  ``span`` (2, 4 or
    8) bins prims that cover at most span x span tiles.  ``kind_split``
    (the rows8/rows9 walk) puts every binned capsule in a second ordinal
    region past the discs', so a tile walks its disc ranges and its
    capsule ranges separately.  ``bin_triangles`` bins small triangles
    too (the mesh-LOD droplets; only the ground stays big).  ``with_z``
    builds the early exit's keys: ``((anchor * span^2 + class) << ZQ) |
    qz``, qz the z-bucket of the prim's depth lower bound (``zlb``, or
    :func:`z_lower_bound`), so every (anchor, class) segment ascends in
    bucket; without it the keys are the bare ordinals (:func:`key_layout`).

    Returns a dict of device tensors (k2 = span * span, F = 2 under
    ``kind_split``, else 1):
      keys       (P,) sorted keys;
      order      (P,) int32 prim ids in key order (binned prims first);
      starts     (F*k2*T+1,) int32 — starts[j] is the first sorted
                 position with key >= j << shift, j = region*k2*T +
                 k2*anchor + class; starts[F*k2*T] = number of binned
                 prims;
      big_ids    (max_big,) int32 big-list prim ids (P = empty slot);
      big_n      (1,) int32 live big-list length min(big_count, max_big);
      big_count  () int32 number of big prims (valid, not binnable);
      zmeta      (3,) float32 (zmin, s, thr_scale) of the exit over the
                 binned prims' zlb (zeros without ``with_z``);
      diag       {"big_overflow", "true_entries"} () int32 tensors.
    """
    check_id_range(prims)
    if span not in SPANS:
        raise ValueError(f"span must be one of {SPANS}, got {span}")
    if kind_split and (discs_only or bin_triangles or with_z):
        raise ValueError("kind_split serves the exit-off mixed disc + "
                         "capsule soup: not with discs_only, bin_triangles "
                         "or with_z")
    dev = prims.device
    p = prims.count
    tiles_x, tiles_y = grid_shape(width, height)
    num_tiles = tiles_x * tiles_y
    k2 = span * span
    factor = 2 if kind_split else 1
    n_keys = factor * num_tiles * k2
    kdtype, shift = key_layout(num_tiles, span, with_z, kind_split)
    tx0, tx1, ty0, ty1 = tile_span(prims, tiles_x, tiles_y)
    is_cap = prims.kind == KIND_CAPSULE
    binnable = binnable_kinds(prims, discs_only, bin_triangles)
    sx, sy = tx1 - tx0, ty1 - ty0
    fits = (sx < span) & (sy < span) & binnable
    is_small = prims.valid & fits
    is_big = prims.valid & ~fits
    if span == 2:
        # Ordinals chosen so every neighbour's class subset is contiguous:
        # left needs {1, 2}, up needs {2, 3}, diagonal {2}.
        cls = sx + 3 * sy - 2 * (sx * sy)
    else:
        cls = sy * span + sx
    anchor = ty0 * tiles_x + tx0
    base = anchor * k2 + cls
    if with_z:
        # pallas_csr6._bin_csr6's float32 expressions (as _bin_csr4's).
        if zlb is None:
            zlb = z_lower_bound(prims, with_triangles=bin_triangles)
        inf = const(np.inf, np.float32, dev)
        zero = const(0.0, np.float32, dev)
        zmin = torch.where(is_small, zlb, inf).amin()
        zmax = torch.where(is_small, zlb, -inf).amax()
        rngz = zmax - zmin
        s = torch.where(rngz > 0, const(1 << ZQ, np.float32, dev) / rngz,
                        zero)
        # NaN casts to 0, as XLA's convert does.
        qz = torch.nan_to_num(torch.clamp(torch.floor((zlb - zmin) * s), 0.0,
                                          float((1 << ZQ) - 1)), nan=0.0)
        base = (base << ZQ) | qz.to(torch.int32)
        thr_scale = torch.where(
            s > 0, const(1.0 - 1e-6, np.float32, dev) / s, zero)
        zmeta = torch.stack([torch.where(torch.isfinite(zmin), zmin, zero),
                             s, thr_scale])
    else:
        zmeta = torch.zeros(3, dtype=torch.float32, device=dev)
    if kind_split:
        base = base + is_cap.to(torch.int32) * (num_tiles * k2)
    key = torch.where(is_small, base,
                      torch.where(is_big, n_keys << shift,
                                  (n_keys + 1) << shift))
    sorted_keys, order = torch.sort(key.to(kdtype), stable=False)
    order = order.to(torch.int32)

    bounds = (torch.arange(n_keys + 2, dtype=torch.int32, device=dev)
              << shift).to(kdtype)
    edges = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    starts = edges[:n_keys + 1]
    n_small = edges[n_keys]
    big_count = edges[n_keys + 1] - n_small
    # The big list is the sorted tail past the binned prefix; empty slots
    # point at the all-zero pad row P.
    tail = torch.cat([order, torch.full((max_big,), p, dtype=torch.int32,
                                        device=dev)])
    slot = torch.arange(max_big, dtype=torch.int32, device=dev)
    big_n = torch.clamp(big_count, max=max_big)
    big_ids = torch.where(slot < big_n, tail[(n_small + slot).long()],
                          torch.full_like(slot, p))
    # true_entries: the tiles each binned prim covers, summed by class.
    cls_counts = (starts[1:] - starts[:-1]).reshape(factor * num_tiles, k2)
    spill_x, spill_y = class_spill(span)
    w_cls = const([(a + 1) * (b + 1) for a, b in zip(spill_x, spill_y)],
                  np.int32, dev)
    true_entries = (cls_counts.sum(dim=0) * w_cls).sum().to(torch.int32)
    diag = dict(
        true_entries=true_entries,
        big_overflow=torch.clamp(big_count - max_big, min=0).to(torch.int32))
    return dict(keys=sorted_keys, order=order, starts=starts,
                big_ids=big_ids, big_n=big_n.reshape(1).contiguous(),
                big_count=big_count, zmeta=zmeta, diag=diag)


def tile_rows(starts, width: int, height: int,
              span: int = SPAN) -> torch.Tensor:
    """(T,) int32: the binned rows each tile walks (its own anchor's
    classes and each neighbour's spill classes that reach it) under a
    binning at ``span`` (the first ordinal region of ``starts``)."""
    tiles_x, tiles_y = grid_shape(width, height)
    k2 = span * span
    counts = (starts[1:k2 * tiles_x * tiles_y + 1]
              - starts[:k2 * tiles_x * tiles_y]).to(torch.int64)
    spill_x, spill_y = class_spill(span)
    grid = torch.zeros((tiles_y, tiles_x, span, span), dtype=torch.int64,
                       device=starts.device)
    grid[:, :, list(spill_y), list(spill_x)] = counts.reshape(
        tiles_y, tiles_x, k2)
    # reach[.., dy, dx]: the rows of an anchor whose spill is >= (dx, dy).
    reach = grid.flip(2, 3).cumsum(2).cumsum(3).flip(2, 3)
    rows = torch.zeros((tiles_y, tiles_x), dtype=torch.int64,
                       device=starts.device)
    for dy in range(min(span, tiles_y)):
        for dx in range(min(span, tiles_x)):
            rows[dy:, dx:] += reach[:tiles_y - dy, :tiles_x - dx, dy, dx]
    return rows.reshape(-1).to(torch.int32)


def bin_diagnostics6(prims: ScreenPrimitives, width: int, height: int,
                     max_big: int = DEFAULT_MAX_BIG,
                     discs_only: bool = False, span: int = SPAN,
                     kind_split: bool = False,
                     bin_triangles: bool = False) -> torch.Tensor:
    """Big-list overflow count under the v6 binning (0 = exact).

    ``discs_only``, ``span`` and ``bin_triangles`` must mirror the render
    being certified: ``discs_only`` sends every capsule to the big list, a
    narrower span sends more prims there and ``bin_triangles`` keeps small
    triangles off it, so a mismatched probe can certify a truncating run
    as exact."""
    return bin_csr6(prims, width, height, max_big, discs_only, span,
                    kind_split, bin_triangles)["diag"]["big_overflow"]


# ---------------------------------------------------------------------------
# Tables (pallas_csr3._preshade, pallas_csr4._build_table16, the
# discs_only rows of pallas_csr6._raster_core6)
# ---------------------------------------------------------------------------

def preshade(prims: ScreenPrimitives, camera, shading):
    """Per-primitive pixel-invariant shading -> (rgb (P, 3), flag (P,)).

    flag > 0: lambert disc, flag = 1/max(r, 1e-6), rgb the raw color (lit
    per pixel); flag = -1: rgb is the final clipped color (triangles:
    lambert with the face normal; capsules: ``trail_boost``).  The same
    formulas as ``shade_framebuffer`` evaluated per prim.
    """
    if shading.mode == "flat":
        return prims.color, torch.full((prims.count,), -1.0,
                                       dtype=torch.float32,
                                       device=prims.device)
    l_cam = key_light(camera)
    ndotl_tri = (prims.normal[:, 0] * l_cam[0]
                 + prims.normal[:, 1] * l_cam[1]
                 + prims.normal[:, 2] * l_cam[2])
    lit = shading.ambient + shading.diffuse * torch.clamp(ndotl_tri, min=0.0)
    lit = torch.where(prims.kind == KIND_CAPSULE,
                      torch.full_like(lit, shading.trail_boost), lit)
    pre_rgb = torch.clamp(prims.color * lit[:, None], 0.0, 1.0)
    is_disc = prims.kind == KIND_DISC
    inv_r = 1.0 / torch.clamp(prims.params[:, 3], min=1e-6)
    rgb = torch.where(is_disc[:, None], prims.color, pre_rgb)
    flag = torch.where(is_disc, inv_r, torch.full_like(inv_r, -1.0))
    return rgb, flag


def z_lower_bound(prims: ScreenPrimitives,
                  with_triangles: bool = False) -> torch.Tensor:
    """(P,) sound per-prim lower bound of the evaluated depth
    (``pallas_csr4._z_lower_bound``): min(z0, z0 + dz) for discs and
    capsules (z0 + dz * t, t in [0, 1]); with ``with_triangles``, a
    triangle's 1 / max(iz) over its bbox corners (iz is linear in screen
    space, so its maximum over the triangle is at most that), 0 where the
    bound degenerates."""
    p = prims.params
    z0 = p[:, 2]
    zlb = torch.minimum(z0, z0 + p[:, 6])
    if not with_triangles:
        return zlb
    izmax = None
    for cx in (0, 1):
        for cy in (2, 3):
            qx = prims.bbox[:, cx]
            qy = prims.bbox[:, cy]
            e0 = p[:, 0] * qy - p[:, 1] * qx + p[:, 2]
            e1 = p[:, 3] * qy - p[:, 4] * qx + p[:, 5]
            e2 = p[:, 6] * qy - p[:, 7] * qx + p[:, 8]
            iz = e0 * p[:, 9] + e1 * p[:, 10] + e2 * p[:, 11]
            izmax = iz if izmax is None else torch.maximum(izmax, iz)
    pos = izmax > 0
    zlb_tri = torch.where(
        pos, 1.0 / torch.where(pos, izmax, torch.ones_like(izmax)),
        torch.zeros_like(izmax))
    return torch.where(prims.kind == KIND_TRIANGLE, zlb_tri, zlb)


def build_table16(prims: ScreenPrimitives, shade_rgb, shade_flag, idf=None,
                  pad: bool = True, bin_triangles: bool = False,
                  zlb=None) -> torch.Tensor:
    """(P+1, 16) float32 kernel rows; row P is the all-zero pad.

      [0:9]   params 0..8
      [9]     prim id as float32
      [10:13] triangles: the inverse-depth plane (params 9..11);
              else the shade rgb
      [13]    triangles: 0; else the shade flag
      [14]    zlb = :func:`z_lower_bound` (the v4 early exit's depth
              floor; triangles get theirs under ``bin_triangles``)
      [15]    1.0 for triangles (the dual eval's kind flag), else 0
    Invalid prims' rows are zero (inert under both evaluations).
    ``idf`` / ``pad=False`` serve :func:`build_table16_rows` (a gathered
    sub-soup whose id lane carries the original prim ids, unpadded);
    ``zlb`` is lane 14 when the caller has it already.
    """
    p = prims.count
    dev = prims.device
    if idf is None:
        idf = torch.arange(p, dtype=torch.float32, device=dev)
    if zlb is None:
        zlb = z_lower_bound(prims, with_triangles=bin_triangles)
    is_tri = (prims.kind == KIND_TRIANGLE)[:, None]
    zero = torch.zeros((p, 1), dtype=torch.float32, device=dev)
    mid = torch.where(is_tri, torch.cat([prims.params[:, 9:12], zero], dim=1),
                      torch.cat([shade_rgb, shade_flag[:, None]], dim=1))
    table = torch.cat([prims.params[:, 0:9], idf[:, None], mid, zlb[:, None],
                       is_tri.to(torch.float32)], dim=1)
    table = torch.where(prims.valid[:, None], table, torch.zeros_like(table))
    if not pad:
        return table.contiguous()
    return torch.cat([table, torch.zeros((1, ROW_F), dtype=torch.float32,
                                         device=dev)]).contiguous()


def build_table16_rows(prims: ScreenPrimitives, shade_rgb, shade_flag,
                       ids, bin_triangles: bool = False) -> torch.Tensor:
    """The rows ``build_table16(...)[ids]`` without the (P+1, 16) table
    (``pallas_csr4._build_table16_rows``): gather the per-prim inputs at
    ``ids`` first, then lay the few rows out.  Bit-equal per row, since
    every lane is an elementwise function of the gathered columns; ids
    outside [0, P) (the pad id P of empty big-list slots) give the zero
    row.  The ``discs_only`` walk needs 16-float rows for its big list
    only."""
    p = prims.count
    ids = ids.to(torch.int32)
    safe = torch.clamp(ids, 0, p - 1).long()
    m = ids.shape[0]
    zeros3 = torch.zeros((m, 3), dtype=torch.float32, device=prims.device)
    sub = ScreenPrimitives(
        kind=prims.kind[safe], params=prims.params[safe], color=zeros3,
        valid=prims.valid[safe] & (ids >= 0) & (ids < p),
        bbox=prims.bbox[safe], normal=zeros3)
    return build_table16(sub, shade_rgb[safe], shade_flag[safe],
                         idf=ids.to(torch.float32), pad=False,
                         bin_triangles=bin_triangles)


def build_table10(prims: ScreenPrimitives) -> torch.Tensor:
    """(P+1, 10) float32 rows [x0, y0, z0, r0, sdx, sdy, sdz, sdr, il2,
    idf] of the ``cap_rows10`` walk (``pallas_csr6.py:1407-1413``):
    ``params[:, 0:9]`` and the float id, the lanes of the 16-float row the
    capsule body reads.  Invalid prims' rows and the pad row P are zero:
    a zero row has rad = 0 and no pixel centre at (0, 0), so it covers
    nothing."""
    p = prims.count
    dev = prims.device
    table = torch.cat([prims.params[:, 0:9],
                       torch.arange(p, dtype=torch.float32,
                                    device=dev)[:, None]], dim=1)
    table = torch.where(prims.valid[:, None], table, torch.zeros_like(table))
    return torch.cat([table, torch.zeros((1, ROW_F10), dtype=torch.float32,
                                         device=dev)]).contiguous()


def build_table8(prims: ScreenPrimitives, shade_flag) -> torch.Tensor:
    """(P+1, 8) float32 disc rows [px, py, z, r*r, idf, flag, 0, 0] of the
    ``discs_only`` walk (``pallas_csr6.py:1282-1297``); invalid prims' rows
    and the pad row P are zero.  r*r is squared here once: the same
    float32 multiply on the same input as squaring per pair.  Lane 5
    carries ``preshade``'s disc flag (1/r) for the fused (u, v) walk.  A
    zero row is inert: r*r = 0 and no pixel centre lies on (0, 0)."""
    p = prims.count
    dev = prims.device
    r = prims.params[:, 3]
    table = torch.cat([
        prims.params[:, 0:3], (r * r)[:, None],
        torch.arange(p, dtype=torch.float32, device=dev)[:, None],
        shade_flag[:, None],
        torch.zeros((p, 2), dtype=torch.float32, device=dev)], dim=1)
    table = torch.where(prims.valid[:, None], table, torch.zeros_like(table))
    return torch.cat([table, torch.zeros((1, ROW_F_DISC), dtype=torch.float32,
                                         device=dev)]).contiguous()


def build_rows8(prims: ScreenPrimitives, shade_flag, order) -> torch.Tensor:
    """(P, 8) float32 disc rows in sorted order, ``build_table8(...)
    [order]`` bit for bit: row i is prim ``order[i]``'s, built from its
    gathered inputs in one pass (the walks stage a tile's ranges as
    contiguous runs, so the kernel gathers nothing).  Positions past the
    binned prefix hold their big or invalid prims' rows, which no walk
    reads."""
    ids = order.long()
    p = prims.params[:, 0:4][ids]
    r = p[:, 3]
    rows = torch.cat([
        p[:, 0:3], (r * r)[:, None], order.to(torch.float32)[:, None],
        shade_flag[ids][:, None],
        torch.zeros((ids.shape[0], 2), dtype=torch.float32,
                    device=prims.device)], dim=1)
    return torch.where(prims.valid[ids][:, None], rows,
                       torch.zeros_like(rows)).contiguous()


def build_table9(prims: ScreenPrimitives, order, n_small) -> torch.Tensor:
    """(P, 9) float32 kind-split rows in sorted order (the rows9 walk;
    ``pallas_csr6._rows9_columns`` gathered as ``_raster_core6`` does):

      disc     [px, py, z, r*r, idf, 0, 0, 0, 0]
      capsule  [x0, y0, ux, -rho0, uy, rhod, z0, sdz, idf]

    with ux = sdx * il2, uy = sdy * il2, rho0 = r0 * sqrt(il2) and rhod =
    dr * sqrt(il2): the point-to-segment test divided through by the
    axis length.  Row i is prim ``order[i]``'s; invalid prims and sorted
    positions past the binned prefix (``n_small``) are NaN rows, inert
    under both bodies (every compare fails).  The two encodings are also
    inert read as each other: a capsule's lane 3 (-rho0 < 0) fails the
    disc's r*r test, a disc's lane 5 (0) makes the capsule radius
    -r*r <= 0, which fails its strict rad > 0."""
    p = prims.count
    dev = prims.device
    pk = prims.params
    iscap = prims.kind == KIND_CAPSULE
    il2 = pk[:, 8]
    il = sqrt_rn(torch.where(iscap, il2, torch.zeros_like(il2)))
    r = pk[:, 3]
    idf = torch.arange(p, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(r)
    cols = (pk[:, 0], pk[:, 1],
            torch.where(iscap, pk[:, 4] * il2, pk[:, 2]),
            torch.where(iscap, -(r * il), r * r),
            torch.where(iscap, pk[:, 5] * il2, idf),
            torch.where(iscap, pk[:, 7] * il, zero),
            torch.where(iscap, pk[:, 2], zero),
            torch.where(iscap, pk[:, 6], zero),
            torch.where(iscap, idf, zero))
    nan = torch.full((p + 1, ROW_F9), float("nan"), dtype=torch.float32,
                     device=dev)
    table = torch.where(prims.valid[:, None], torch.stack(cols, dim=1),
                        nan[:p])
    table = torch.cat([table, nan[p:]])
    pos = torch.arange(p, dtype=torch.int32, device=dev)
    return table[torch.where(pos < n_small, order, p).long()].contiguous()


# ---------------------------------------------------------------------------
# The tile walks: CUDA kernel wrappers and plain versions
# ---------------------------------------------------------------------------

def _check_ranges(order, starts, big_n, width, height, span=SPAN):
    if span not in SPANS:
        raise ValueError(f"span must be one of {SPANS}, got {span}")
    tiles_x, tiles_y = grid_shape(width, height)
    for name, t in (("order", order), ("starts", starts), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != tiles_x * tiles_y * span * span + 1:
        raise ValueError("starts does not match the tile grid at this span")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    return tiles_x, tiles_y


def _check_one_device(*tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_inputs(table, order, starts, big_ids, big_n, width, height,
                  span=SPAN):
    if table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] != ROW_F:
        raise ValueError("table must be (P+1, 16) float32")
    if big_ids.dtype != torch.int32 or big_ids.ndim != 1:
        raise ValueError("big_ids must be a 1-D int32 tensor")
    grid = _check_ranges(order, starts, big_n, width, height, span)
    _check_one_device(table, order, starts, big_ids, big_n)
    return grid


def _check_inputs_narrow(table, row_f, big_rows, order, starts, big_n,
                         width, height, span=SPAN):
    """Checks of the walks over narrow binned rows (``table`` (P+1,
    ``row_f``)) with a dense 16-float big list."""
    if (table.dtype != torch.float32 or table.ndim != 2
            or table.shape[1] != row_f):
        raise ValueError(f"table{row_f} must be (P+1, {row_f}) float32")
    if (big_rows.dtype != torch.float32 or big_rows.ndim != 2
            or big_rows.shape[1] != ROW_F):
        raise ValueError("big_rows must be (B, 16) float32")
    grid = _check_ranges(order, starts, big_n, width, height, span)
    _check_one_device(table, big_rows, order, starts, big_n)
    return grid


def _launch(symbol, ptr_args, int_args, device, library="csr6_raster"):
    """Call ``symbol`` of the kernel library ``library`` (``csrc/<library>
    .cu``) on the current stream of ``device``; pointers first (None
    passes a null pointer), then ints, then the stream.  Raises on a
    refused launch: nothing falls back to a plain version."""
    from pointcloud_render_tpu_torch.utils import kernels  # noqa: PLC0415

    lib = kernels.load(library)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptr_args)
                   + [ctypes.c_int] * len(int_args) + [ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in ptr_args),
                 *int_args, stream)
    if err != 0:
        err_fn = getattr(lib, library.split("_")[0] + "_error_string")
        err_fn.restype = ctypes.c_char_p
        err_fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{symbol} launch failed: "
                           + err_fn(err).decode())


def _check_exit_walk(zmeta, walked, split_rows, device, num_tiles, span,
                     bands=None):
    """Checks of the split walks' exit, ``walked`` (and the disc walks'
    ``bands``) and split arguments."""
    if zmeta is not None:
        if span != 2:
            raise ValueError("the early exit walks single-class segments: "
                             "span must be 2")
        if (zmeta.dtype != torch.float32 or zmeta.shape != (3,)
                or zmeta.device != device):
            raise ValueError("zmeta must be (3,) float32 on the table's "
                             "device")
    for name, t in (("walked", walked), ("bands", bands)):
        if t is not None and (t.dtype != torch.int32
                              or t.shape != (num_tiles,)
                              or t.device != device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (T,) int32 "
                             "tensor on the table's device")
    if split_rows < 1:
        raise ValueError("split_rows must be >= 1")


def _launch_walk(symbol, wrapper, ptrs, aligned, big_cap, width, height,
                 tiles_x, tiles_y, flags, split_rows, device, units=None,
                 library="csr6_raster", uv=False):
    """Launch a split walk (plan, walk, merge: one C call; csrc/
    split_walk.cuh) of ``csrc/<library>.cu`` -> (depth, index), with
    ``uv`` (depth, index, u, v).  ``ptrs`` are the inputs before the
    outputs, ``aligned`` the (row tensor, row bytes) pairs that the kernel
    copies asynchronously, ``units`` the 1024-pixel units of the plan (the
    tiles by default); the wrapper's count goes up once per call."""
    for t, row_bytes in aligned:
        # The copy sizes: 16 B for 64 B and 32 B rows, 8 B for 40 B, 4 B
        # for 36 B.
        need = next(n for n in (16, 8, 4) if row_bytes % n == 0)
        if t.data_ptr() % need:
            raise ValueError(f"rows of {row_bytes} B must start {need}-byte "
                             "aligned: the kernel copies them "
                             "asynchronously")
    units = units or tiles_x * tiles_y
    max_items = ITEMS_PER_TILE * units
    outs = [torch.empty((height, width), dtype=torch.float32, device=device),
            torch.empty((height, width), dtype=torch.int32, device=device)]
    if uv:
        outs += [torch.empty((height, width), dtype=torch.float32,
                             device=device) for _ in range(2)]
    # The plan, with room for its ticket order (split_plan_kernel).
    plan = torch.empty(units + 3 * max_items + 3, dtype=torch.int32,
                       device=device)
    partial = torch.empty((max_items, 4 if uv else 2, TILE * TILE),
                          dtype=torch.float32, device=device)
    _launch(symbol, (*ptrs, *outs, plan, partial),
            (big_cap, width, height, tiles_x, tiles_y, *flags, split_rows,
             max_items), device, library)
    wrapper.launches += 1
    return tuple(outs)


def _raster16(wrapper, bin_triangles, table, order, starts, big_ids, big_n,
              width, height, span, zmeta, walked, split_rows):
    tiles_x, tiles_y = _check_inputs(table, order, starts, big_ids, big_n,
                                     width, height, span)
    _check_exit_walk(zmeta, walked, split_rows, table.device,
                     tiles_x * tiles_y, span)
    if table.device.type == "cpu":
        if walked is not None:
            walked.copy_(tile_rows(starts, width, height, span))
        return raster_tiles_plain(table, order, starts, big_ids, big_n,
                                  width, height, bin_triangles, span)
    if table.device.type != "cuda":
        raise ValueError(f"no csr6 kernel for device {table.device}")
    table, order, starts, big_ids, big_n = (
        t.contiguous() for t in (table, order, starts, big_ids, big_n))
    # The exit's depths shared by a split tile's items (the kernel's plan
    # resets those it reads).
    front = None if zmeta is None else torch.empty(
        (tiles_x * tiles_y, TILE * TILE), dtype=torch.int32,
        device=table.device)
    return _launch_walk(
        "csr6_raster", wrapper,
        (table, order, starts, big_ids, big_n, zmeta, front, walked),
        ((table, 4 * ROW_F),), big_ids.shape[0], width, height, tiles_x,
        tiles_y, (int(bin_triangles), span), split_rows, table.device)


def raster_tiles(table, order, starts, big_ids, big_n, width: int,
                 height: int, bin_triangles: bool = False, span: int = SPAN,
                 zmeta=None, walked=None, split_rows: int = SPLIT_ROWS):
    """(depth (H, W) f32 +inf-empty, index (H, W) i32 -1-empty) of a
    binning at ``span`` (2, 4 or 8).

    CUDA tensors launch the ``csr6_raster`` kernel of
    ``csrc/csr6_raster.cu``; CPU tensors take :func:`raster_tiles_plain`.
    ``zmeta`` (the exit binning's (3,) float32, span 2) turns the z-bucket
    early exit on: the kernel walks each tile's nine single-class
    segments and leaves one once no later row of it can win.  ``walked``,
    a (T,) int32 tensor, takes each tile's count of binned rows evaluated
    (all of them on the plain walk).  A tile of more than ``split_rows``
    rows is walked by several CTAs whose minima are merged (the kernel
    may take larger items; the result does not depend on it).  With the
    exit on, those CTAs share their depths as they run, so ``walked``
    may differ between runs; the images do not.
    ``bin_triangles`` hands the call to :func:`raster_tiles_tri`.
    ``.launches`` counts calls without ``bin_triangles``."""
    if bin_triangles:
        return raster_tiles_tri(table, order, starts, big_ids, big_n, width,
                                height, span, zmeta, walked, split_rows)
    return _raster16(raster_tiles, False, table, order, starts, big_ids,
                     big_n, width, height, span, zmeta, walked, split_rows)


raster_tiles.launches = 0


def raster_tiles_tri(table, order, starts, big_ids, big_n, width: int,
                     height: int, span: int = SPAN, zmeta=None, walked=None,
                     split_rows: int = SPLIT_ROWS):
    """:func:`raster_tiles` with ``bin_triangles``: binned rows through the
    triangle-aware dual evaluation, as the big list always is (the
    mesh-LOD droplets).  ``.launches`` counts calls."""
    return _raster16(raster_tiles_tri, True, table, order, starts, big_ids,
                     big_n, width, height, span, zmeta, walked, split_rows)


raster_tiles_tri.launches = 0


def raster_tiles_cap10(table10, big_rows, order, starts, big_n, width: int,
                       height: int, span: int = SPAN, walked=None,
                       split_rows: int = SPLIT_ROWS):
    """The ``cap_rows10`` walk -> (depth, index): binned rows are the
    10-float rows of :func:`build_table10` gathered by ``order`` (a
    binning at ``span``) through the capsule body of the 16-float walk
    (the same float32 expressions, so the same winners and depth bits),
    the big list the dense 16-float ``big_rows`` (its first ``big_n``
    live) through the dual evaluation.  No early exit: the rows carry no
    zlb lane.  ``walked`` and ``split_rows`` as :func:`raster_tiles`.
    CUDA tensors launch the ``csr6_cap10`` kernel of
    ``csrc/csr6_raster.cu``; CPU tensors take
    :func:`raster_tiles_cap10_plain`.  ``.launches`` counts calls."""
    tiles_x, tiles_y = _check_inputs_narrow(table10, ROW_F10, big_rows,
                                            order, starts, big_n, width,
                                            height, span)
    _check_exit_walk(None, walked, split_rows, table10.device,
                     tiles_x * tiles_y, span)
    if table10.device.type == "cpu":
        if walked is not None:
            walked.copy_(tile_rows(starts, width, height, span))
        return raster_tiles_cap10_plain(table10, big_rows, order, starts,
                                        big_n, width, height, span)
    if table10.device.type != "cuda":
        raise ValueError(f"no csr6 kernel for device {table10.device}")
    table10, big_rows, order, starts, big_n = (
        t.contiguous() for t in (table10, big_rows, order, starts, big_n))
    return _launch_walk(
        "csr6_cap10", raster_tiles_cap10,
        (table10, big_rows, order, starts, big_n, walked),
        ((table10, 4 * ROW_F10), (big_rows, 4 * ROW_F)), big_rows.shape[0],
        width, height, tiles_x, tiles_y, (span,),
        split_rows, table10.device)


raster_tiles_cap10.launches = 0


def _raster_disc8(wrapper, with_uv, rows8, big_rows, starts, big_n, width,
                  height, span, zmeta, walked, bands, split_rows):
    tiles_x, tiles_y = _check_inputs_rows8(rows8, big_rows, starts, big_n,
                                           width, height, span)
    _check_exit_walk(zmeta, walked, split_rows, rows8.device,
                     tiles_x * tiles_y, span, bands)
    if rows8.device.type == "cpu":
        if walked is not None:
            walked.copy_(tile_rows(starts, width, height, span))
        if bands is not None:
            bands.copy_(band_rows(rows8, starts, width, height, span))
        return _disc8_plain(with_uv, rows8, big_rows, starts, big_n, width,
                            height, span)
    if rows8.device.type != "cuda":
        raise ValueError(f"no csr6 kernel for device {rows8.device}")
    rows8, big_rows, starts, big_n = (
        t.contiguous() for t in (rows8, big_rows, starts, big_n))
    if bands is not None:
        bands.zero_()
    aligned = ((rows8, 4 * ROW_F_DISC), (big_rows, 4 * ROW_F))
    if with_uv:
        return _launch_walk(
            "csr6_disc8_uv", wrapper,
            (rows8, big_rows, starts, big_n, walked, bands), aligned,
            big_rows.shape[0], width, height, tiles_x, tiles_y, (span,),
            split_rows, rows8.device, uv=True)
    # The exit's depths shared by a split tile's items (the kernel's plan
    # resets those it reads).
    front = None if zmeta is None else torch.empty(
        (tiles_x * tiles_y, TILE * TILE), dtype=torch.int32,
        device=rows8.device)
    return _launch_walk(
        "csr6_disc8", wrapper,
        (rows8, big_rows, starts, big_n, zmeta, front, walked, bands),
        aligned, big_rows.shape[0], width, height, tiles_x, tiles_y, (span,),
        split_rows, rows8.device)


def raster_tiles_disc8(rows8, big_rows, starts, big_n, width: int,
                       height: int, span: int = SPAN, zmeta=None,
                       walked=None, bands=None,
                       split_rows: int = SPLIT_ROWS_DISC):
    """The ``discs_only`` walk -> (depth, index).

    Both versions take the binned disc rows in sorted order,
    :func:`build_rows8` (``build_table8(...)[order]``, the JAX package's
    gathered rows), with the range ``starts`` of a binning at ``span``,
    and the big list as the dense 16-float ``big_rows`` (its first
    ``big_n`` rows live).  CUDA tensors launch the ``csr6_disc8`` kernel
    of ``csrc/csr6_raster.cu`` (a split walk, its rows staged by bulk
    copies, each warp culling the rows that miss its band of pixel rows);
    CPU tensors take :func:`raster_tiles_disc8_plain`.  ``zmeta`` (an exit
    binning's, span 2) turns the z-bucket early exit on, as in
    :func:`raster_tiles`; ``walked`` takes each tile's count of binned
    rows evaluated, ``bands`` its count of (binned row, warp band) pairs
    evaluated (:func:`band_rows` on the plain walk, which walks every
    row); ``split_rows`` as :func:`raster_tiles`.  ``.launches`` counts
    calls."""
    return _raster_disc8(raster_tiles_disc8, False, rows8, big_rows, starts,
                         big_n, width, height, span, zmeta, walked, bands,
                         split_rows)


raster_tiles_disc8.launches = 0


def raster_tiles_disc8_uv(rows8, big_rows, starts, big_n, width: int,
                          height: int, span: int = SPAN, walked=None,
                          bands=None, split_rows: int = SPLIT_ROWS_DISC):
    """:func:`raster_tiles_disc8` (no exit) that also carries the winner's
    lambert plane coordinates -> (depth, index, u, v): u = (qx - px) *
    flag and v = -(qy - py) * flag at the winning pair for discs (binned,
    or wide on the big list), +inf for triangle and capsule winners and
    where empty.  CUDA tensors launch the ``csr6_disc8_uv`` kernel; CPU
    tensors take :func:`raster_tiles_disc8_uv_plain`.  ``.launches``
    counts calls."""
    return _raster_disc8(raster_tiles_disc8_uv, True, rows8, big_rows,
                         starts, big_n, width, height, span, None, walked,
                         bands, split_rows)


raster_tiles_disc8_uv.launches = 0


def _eval_capsule(x0, y0, z0, r0, sdx, sdy, sdz, sdr, il2, qx, qy):
    """The capsule body of pallas_csr4._make_row_body16 (and of
    _make_row_body10) in its exact expression order -> (dx, dy, covered,
    depth)."""
    dx = qx - x0
    dy = qy - y0
    t = torch.clamp((dx * sdx + dy * sdy) * il2, 0.0, 1.0)
    cx = dx - t * sdx
    cy = dy - t * sdy
    rad = r0 + sdr * t
    z = z0 + sdz * t
    return dx, dy, cx * cx + cy * cy <= rad * rad, z


def _eval10(rows, rid, qx, qy, with_uv):
    """The 10-float capsule row evaluation (pallas_csr6._make_row_body10)
    -> (covered, depth, idf, u, v)."""
    cols = [rows[rid, k] for k in range(ROW_F10)]
    _, _, cov, z = _eval_capsule(*cols[:9], qx, qy)
    return cov, z, cols[9], None, None


def _eval16(rows, rid, qx, qy, with_uv, tri=True):
    """The 16-float row evaluation (pallas_csr4._make_row_body16 with the
    triangle dual; ``tri=False`` the capsule body alone, as the binned
    stream of a walk without ``bin_triangles``), in its exact expression
    order -> (covered, depth, idf, u, v); (u, v) as
    pallas_csr6._make_big_body16_uv carries them (None unless
    ``with_uv``)."""
    x0, y0, z0, r0, sdx, sdy, sdz, sdr, il2, idf, t9, t10, t11, flag, _, kf \
        = (rows[rid, k] for k in range(ROW_F))
    dx, dy, cov, z = _eval_capsule(x0, y0, z0, r0, sdx, sdy, sdz, sdr, il2,
                                   qx, qy)
    e0 = x0 * qy - y0 * qx + z0
    e1 = r0 * qy - sdx * qx + sdy
    e2 = sdz * qy - sdr * qx + il2
    iz = e0 * t9 + e1 * t10 + e2 * t11
    cov_t = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (iz > 0)
    z_t = 1.0 / torch.where(iz > 0, iz, torch.ones_like(iz))
    is_tri = (kf > 0) & tri
    u = v = None
    if with_uv:
        is_disc = ~is_tri & (flag > 0)
        inf = torch.full_like(dx, float("inf"))
        u = torch.where(is_disc, dx * flag, inf)
        v = torch.where(is_disc, -dy * flag, inf)
    return (torch.where(is_tri, cov_t, cov), torch.where(is_tri, z_t, z),
            idf, u, v)


def _eval8(rows, rid, qx, qy, with_uv):
    """The 8-float disc row evaluation (pallas_csr6._make_row_body8 and
    _make_row_body8_uv) -> (covered, depth, idf, u, v)."""
    px, py, z, r2, idf, invr = (rows[rid, k] for k in range(6))
    dx = qx - px
    dy = qy - py
    cov = dx * dx + dy * dy <= r2
    if not with_uv:
        return cov, z, idf, None, None
    return cov, z, idf, dx * invr, -dy * invr


def _windows(x0, y0, x1, y1, rad, tri, rect):
    """Clip each row's candidate pixel rectangle ``rect`` = (c_lo, c_hi,
    r_lo, r_hi), half-open, to a window around its disc/capsule extent
    (float64 endpoints and radius).  The margin (2 px plus a relative
    term) is far beyond float32 rounding, so no pixel outside the window
    can be covered; rows flagged ``tri`` keep the whole rectangle."""
    c_lo, c_hi, r_lo, r_hi = rect
    big = 1e9
    xlo = torch.minimum(x0, x1) - rad
    xhi = torch.maximum(x0, x1) + rad
    ylo = torch.minimum(y0, y1) - rad
    yhi = torch.maximum(y0, y1) + rad
    mx = 2.0 + 1e-4 * torch.maximum(xlo.abs(), xhi.abs())
    my = 2.0 + 1e-4 * torch.maximum(ylo.abs(), yhi.abs())

    def to_px(v, lo):
        v = torch.nan_to_num(v, nan=lo * big, posinf=big, neginf=-big)
        return torch.clamp(v, -big, big)

    # Pixel c has its center at c + 0.5.
    wc0 = torch.ceil(to_px(xlo - mx - 0.5, 1.0)).to(torch.int64)
    wc1 = torch.floor(to_px(xhi + mx - 0.5, -1.0)).to(torch.int64) + 1
    wr0 = torch.ceil(to_px(ylo - my - 0.5, 1.0)).to(torch.int64)
    wr1 = torch.floor(to_px(yhi + my - 0.5, -1.0)).to(torch.int64) + 1
    c0 = torch.where(tri, c_lo, torch.maximum(c_lo, wc0))
    c1 = torch.where(tri, c_hi, torch.minimum(c_hi, wc1))
    r0_ = torch.where(tri, r_lo, torch.maximum(r_lo, wr0))
    r1_ = torch.where(tri, r_hi, torch.minimum(r_hi, wr1))
    return c0, c1, r0_, r1_


# Unit roundoff of float32: a float32 edge function a*qy - b*qx + c is
# within 3u(|a qy| + |b qx| + |c|) of its exact value (taken as 8u).
F32_U = 2.0 ** -24


def _tri_window(rows, rect):
    """Windows of triangle rows.  Edge k's function e_k = a_k * qy - b_k *
    qx + c_k (lanes 3k..3k+2) evaluated in float32 is within delta = 8u
    (|qx| + |qy| + |v|) of its exact value in distance units (|c_k| /
    |(a_k, b_k)| is at most a vertex's distance |v| from the origin), so a
    covered pixel centre lies in the triangle grown by delta on each
    edge, whose vertex at interior angle theta moves out by delta /
    sin(theta / 2): the window is the bbox of the vertices (recovered in
    float64 from the edge lines) grown by the largest such move, plus
    :func:`_windows`' margin.  Rows whose lines do not bound a triangle
    (parallel edges, a vertex outside its opposite edge, non-finite
    lanes) keep the whole rectangle."""
    r64 = rows.to(torch.float64)
    a, b, c = (r64[:, k::3][:, :3] for k in range(3))
    vx, vy = [], []
    for i, j in ((1, 2), (0, 2), (0, 1)):  # vertex k: opposite edge k
        det = a[:, i] * b[:, j] - b[:, i] * a[:, j]
        safe = torch.where(det == 0, torch.ones_like(det), det)
        vx.append((a[:, i] * c[:, j] - c[:, i] * a[:, j]) / safe)
        vy.append((b[:, i] * c[:, j] - c[:, i] * b[:, j]) / safe)
    vx, vy = torch.stack(vx, 1), torch.stack(vy, 1)
    inside = a * vy - b * vx + c  # each vertex against its opposite edge
    ok = (torch.isfinite(vx).all(1) & torch.isfinite(vy).all(1)
          & (inside > 0).all(1))
    reach = torch.maximum(vx.abs().amax(1), vy.abs().amax(1))
    q = (rect[1] + rect[3]).to(torch.float64)
    delta = 8.0 * F32_U * (q + reach)
    grow = torch.zeros_like(delta)
    for k in range(3):
        ux, uy = vx[:, k - 1] - vx[:, k], vy[:, k - 1] - vy[:, k]
        wx, wy = vx[:, k - 2] - vx[:, k], vy[:, k - 2] - vy[:, k]
        cos = (ux * wx + uy * wy) / (torch.hypot(ux, uy)
                                     * torch.hypot(wx, wy))
        sin_half = torch.sqrt(torch.clamp((1.0 - cos) / 2.0, min=0.0))
        grow = torch.maximum(grow, delta / sin_half)
    ok = ok & torch.isfinite(grow)
    return _windows(vx.amin(1), vy.amin(1), vx.amax(1), vy.amax(1),
                    torch.where(ok, grow, torch.zeros_like(grow)), ~ok, rect)


def _windows_capsule(rows, rect):
    """Capsule windows of rows whose lanes 0-7 are [x0, y0, z0, r0, sdx,
    sdy, sdz, sdr] (the 16- and 10-float rows)."""
    r64 = rows.to(torch.float64)
    x0, y0, r0 = r64[:, 0], r64[:, 1], r64[:, 3]
    rad = torch.maximum(r0.abs(), (r0 + r64[:, 7]).abs())
    return _windows(x0, y0, x0 + r64[:, 4], y0 + r64[:, 5], rad,
                    torch.zeros_like(x0, dtype=torch.bool), rect)


def _windows16(rows, rect, tri=True):
    """Windows of 16-float rows; rows flagged as triangles (lane 15) take
    :func:`_tri_window` when ``tri`` (the dual evaluation), else the
    capsule window as every other row."""
    win = _windows_capsule(rows, rect)
    is_tri = (rows[:, 15] > 0) & tri
    if not bool(is_tri.any()):
        return win
    twin = _tri_window(rows, rect)
    return tuple(torch.where(is_tri, t, w) for t, w in zip(twin, win))


def _windows8(rows, rect):
    r64 = rows.to(torch.float64)
    x0, y0 = r64[:, 0], r64[:, 1]
    rad = torch.sqrt(torch.clamp(r64[:, 3], min=0.0))
    return _windows(x0, y0, x0, y0, rad, torch.zeros_like(x0, dtype=torch.bool),
                    rect)


def _binned_layout(starts, width, height, span=SPAN):
    """(kind region, pixel rectangle) of every binned sorted position
    (those below ``starts[-1]``): each covers the tiles its (anchor,
    class) names.  The region is 1 for the capsule half of a kind-split
    binning, else 0."""
    tiles_x, tiles_y = grid_shape(width, height)
    k2 = span * span
    dev = starts.device
    n_small = int(starts[-1])
    pos = torch.arange(n_small, dtype=torch.int64, device=dev)
    j = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    region, j = j // (k2 * tiles_x * tiles_y), j % (k2 * tiles_x * tiles_y)
    anchor, cls = j // k2, j % k2
    ax, ay = anchor % tiles_x, anchor // tiles_x
    spills = class_spill(span)
    spill_x, spill_y = (torch.tensor(c, dtype=torch.int64, device=dev)[cls]
                        for c in spills)
    rect = (ax * TILE, torch.clamp((ax + 1 + spill_x) * TILE, max=width),
            ay * TILE, torch.clamp((ay + 1 + spill_y) * TILE, max=height))
    return region, rect


def _binned_rects(order, starts, width, height, span=SPAN):
    """(sorted prim ids, pixel rectangle) of the binned rows of a binning
    at ``span``."""
    _, rect = _binned_layout(starts, width, height, span)
    return order[:int(starts[-1])].to(torch.int64), rect


def _full_rect(n, width, height, device):
    zeros = torch.zeros(n, dtype=torch.int64, device=device)
    return zeros, zeros + width, zeros, zeros + height


def _pair_group(rows, window, evaluate, width, with_uv):
    """A re-iterable source of the (row, pixel) pairs of one row group:
    ``group()`` yields (pixel, covered, depth, idf, u, v) for consecutive
    chunks of rows whose pair counts sum to at most ``PLAIN_PAIR_CHUNK``
    (a row larger than that is a chunk alone)."""
    dev = rows.device
    c0, c1, r0, r1 = window
    wc = torch.clamp(c1 - c0, min=0)
    counts = wc * torch.clamp(r1 - r0, min=0)
    cum = torch.cumsum(counts, 0).cpu().numpy()
    bounds, lo = [], 0
    while lo < len(cum):
        base = cum[lo - 1] if lo else 0
        hi = int(np.searchsorted(cum, base + PLAIN_PAIR_CHUNK, side="right"))
        hi = max(hi, lo + 1)
        bounds.append((lo, hi))
        lo = hi

    def group():
        for lo, hi in bounds:
            total = int(cum[hi - 1] - (cum[lo - 1] if lo else 0))
            if total == 0:
                continue
            cnt = counts[lo:hi]
            rid = torch.repeat_interleave(
                torch.arange(lo, hi, device=dev), cnt, output_size=total)
            first = torch.cumsum(cnt, 0) - cnt
            local = torch.arange(total, device=dev) - first[rid - lo]
            col = c0[rid] + local % wc[rid]
            row = r0[rid] + local // wc[rid]
            qx = col.to(torch.float32) + 0.5
            qy = row.to(torch.float32) + 0.5
            yield (row * width + col, *evaluate(rows, rid, qx, qy, with_uv))

    return group


def _merge_plain(groups, width, height, dev, with_uv):
    """Lexicographic (depth, id) minimum over every pair of ``groups`` in
    two order-independent steps (the minimum depth by ``amin``, then the
    lowest id among the pairs that reach it); with ``with_uv`` a third
    step takes (u, v) at that one winning pair."""
    n = height * width
    depth = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    for group in groups:
        for pix, cov, z, _, _, _ in group():
            keep = cov & ~torch.isnan(z)
            depth.scatter_reduce_(0, pix[keep], z[keep], reduce="amin")
    best = torch.full((n,), F_EMPTY, dtype=torch.float32, device=dev)
    for group in groups:
        for pix, cov, z, idf, _, _ in group():
            keep = cov & (z == depth[pix])
            best.scatter_reduce_(0, pix[keep], idf[keep], reduce="amin")
    depth = depth.reshape(height, width)
    index = torch.where(torch.isinf(depth), -1,
                        best.reshape(height, width).to(torch.int32))
    index = index.to(torch.int32)
    if not with_uv:
        return depth, index
    uv = torch.full((2, n), float("inf"), dtype=torch.float32, device=dev)
    flat = depth.reshape(-1)
    for group in groups:
        for pix, cov, z, idf, u, v in group():
            keep = cov & (z == flat[pix]) & (idf == best[pix])
            uv[0, pix[keep]] = u[keep]
            uv[1, pix[keep]] = v[keep]
    return (depth, index, uv[0].reshape(height, width),
            uv[1].reshape(height, width))


def plain_walk16(table, binned_ids, rect, big_ids, big_n, width, height,
                 bin_triangles):
    """The plain 16-float walk shared by the v6 and v4 plain versions:
    each binned row ``table[binned_ids]`` over its pixel rectangle
    ``rect``, each live big row over the image, both clipped to the row's
    window, merged by the two-step lexicographic min.  Binned rows take
    the dual body under ``bin_triangles``, else the capsule body alone
    (as the kernels); big rows always the dual."""
    dev = table.device
    binned = table[binned_ids]
    nb = int(big_n[0])
    big = table[big_ids[:nb].to(torch.int64)]
    groups = [
        _pair_group(binned, _windows16(binned, rect, bin_triangles),
                    functools.partial(_eval16, tri=bin_triangles), width,
                    False),
        _pair_group(big, _windows16(big, _full_rect(nb, width, height, dev)),
                    _eval16, width, False)]
    return _merge_plain(groups, width, height, dev, False)


def raster_tiles_plain(table, order, starts, big_ids, big_n, width: int,
                       height: int, bin_triangles: bool = False,
                       span: int = SPAN):
    """Plain PyTorch version of the 16-float tile walk, on any device.

    Evaluates the same rows as the kernel: each binned row (sorted
    position below ``starts[-1]``) over the pixels of the tiles its
    (anchor, class) covers, each live big-list row over the whole image —
    both clipped to a window around the row's extent that provably holds
    every covered pixel.  Binned rows take the capsule body, or the
    triangle-aware dual under ``bin_triangles``; big rows always the
    dual.  The pairs are enumerated in chunks of at most
    ``PLAIN_PAIR_CHUNK`` and merged with a two-step lexicographic min, so
    the result is exact and order-independent.
    """
    _check_inputs(table, order, starts, big_ids, big_n, width, height, span)
    ids, rect = _binned_rects(order, starts, width, height, span)
    return plain_walk16(table, ids, rect, big_ids, big_n, width, height,
                        bin_triangles)


def raster_tiles_cap10_plain(table10, big_rows, order, starts, big_n,
                             width: int, height: int, span: int = SPAN):
    """Plain PyTorch version of :func:`raster_tiles_cap10`, on any device:
    the capsule body over each binned row's window within its (anchor,
    class) tiles, the 16-float dual over the live big rows, merged as in
    :func:`raster_tiles_plain`."""
    _check_inputs_narrow(table10, ROW_F10, big_rows, order, starts, big_n,
                         width, height, span)
    dev = table10.device
    ids, rect = _binned_rects(order, starts, width, height, span)
    binned = table10[ids]
    nb = int(big_n[0])
    big = big_rows[:nb]
    groups = [
        _pair_group(binned, _windows_capsule(binned, rect), _eval10, width,
                    False),
        _pair_group(big, _windows16(big, _full_rect(nb, width, height, dev)),
                    _eval16, width, False)]
    return _merge_plain(groups, width, height, dev, False)


def _disc8_plain(with_uv, rows8, big_rows, starts, big_n, width, height,
                 span):
    _check_inputs_rows8(rows8, big_rows, starts, big_n, width, height, span)
    dev = rows8.device
    _, rect = _binned_layout(starts, width, height, span)
    binned = rows8[:rect[0].shape[0]]
    nb = int(big_n[0])
    big = big_rows[:nb]
    groups = [
        _pair_group(binned, _windows8(binned, rect), _eval8, width, with_uv),
        _pair_group(big, _windows16(big, _full_rect(nb, width, height, dev)),
                    _eval16, width, with_uv)]
    return _merge_plain(groups, width, height, dev, with_uv)


def raster_tiles_disc8_plain(rows8, big_rows, starts, big_n, width: int,
                             height: int, span: int = SPAN):
    """Plain PyTorch version of :func:`raster_tiles_disc8`, on any device
    (the same sorted rows): the disc body over each binned row's window,
    the 16-float body over the live big rows, merged as in
    :func:`raster_tiles_plain`."""
    return _disc8_plain(False, rows8, big_rows, starts, big_n, width,
                        height, span)


def raster_tiles_disc8_uv_plain(rows8, big_rows, starts, big_n, width: int,
                                height: int, span: int = SPAN):
    """Plain PyTorch version of :func:`raster_tiles_disc8_uv`: (u, v) are
    taken at the one pair that wins (depth, id), +inf elsewhere."""
    return _disc8_plain(True, rows8, big_rows, starts, big_n, width, height,
                        span)


def band_keeps(py, r2, y_lo, band: int = BAND_ROWS):
    """The disc walks' cull (``csrc/csr6_raster.cu`` band_live): whether a
    disc row at ``py`` with squared radius ``r2`` is evaluated over the
    band of ``band`` pixel centres from ``y_lo``: not when fl(dy * dy) >
    r2 at the band's centre nearest to py, which no pixel of the band can
    then pass (exact; NaN never skips).  With ``band`` 1 it is the exact
    test of one pixel row."""
    y_hi = y_lo + float(band - 1)
    near = torch.minimum(torch.maximum(torch.floor(py) + 0.5, y_lo), y_hi)
    dy = near - py
    return ~(dy * dy > r2)


def band_rows(rows8, starts, width: int, height: int,
              span: int = SPAN, band: int = BAND_ROWS) -> torch.Tensor:
    """(T,) int32: the (binned row, warp band) pairs each tile's disc walk
    evaluates with every row walked: per tile, each binned row of its
    ranges (:func:`tile_rows`) at each band of ``band`` pixel rows inside
    the image that :func:`band_keeps` keeps.  With ``band`` 1: the (row,
    pixel row) pairs that some pixel of the row could cover, the work the
    function needs whatever the band."""
    tiles_x, tiles_y = grid_shape(width, height)
    dev = starts.device
    _, (c0, c1, r0, r1) = _binned_layout(starts, width, height, span)
    rows = rows8[:c0.shape[0]]
    py, r2 = rows[:, 1], rows[:, 3]
    tx0, ty0 = c0 // TILE, r0 // TILE
    nx = (c1 - c0 + TILE - 1) // TILE  # tile columns the row is walked in
    ny = (r1 - r0 + TILE - 1) // TILE
    counts = torch.zeros(tiles_x * tiles_y, dtype=torch.int64, device=dev)
    for dy in range(span):
        ty = ty0 + dy
        live = dy < ny
        kept = torch.zeros_like(ty)
        for b in range(TILE // band):
            y0 = ty * TILE + b * band
            keep = band_keeps(py, r2, y0.to(torch.float32) + 0.5, band)
            kept += (keep & (y0 < height)).to(torch.int64)
        for dx in range(span):
            sel = live & (dx < nx)
            counts.index_add_(0, (ty * tiles_x + tx0 + dx)[sel], kept[sel])
    return counts.to(torch.int32)


def _check_sorted_rows(name, rows, row_f, big_rows, starts, big_n, width,
                       height, span, regions=1):
    """Checks of the walks over binned rows in sorted order (``name``: the
    disc walks' rows8, or rows9 with the kind split's two ordinal
    ``regions``), with a dense 16-float big list and the range starts of a
    binning at ``span``."""
    if span not in SPANS:
        raise ValueError(f"span must be one of {SPANS}, got {span}")
    if (rows.dtype != torch.float32 or rows.ndim != 2
            or rows.shape[1] != row_f):
        raise ValueError(f"{name} must be (P, {row_f}) float32")
    if (big_rows.dtype != torch.float32 or big_rows.ndim != 2
            or big_rows.shape[1] != ROW_F):
        raise ValueError("big_rows must be (B, 16) float32")
    for label, t in (("starts", starts), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{label} must be a 1-D int32 tensor")
    tiles_x, tiles_y = grid_shape(width, height)
    if starts.shape[0] != regions * tiles_x * tiles_y * span * span + 1:
        raise ValueError(
            "starts does not match "
            + ("a kind-split binning of " if regions == 2 else "")
            + "the tile grid at this span")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    _check_one_device(rows, big_rows, starts, big_n)
    return tiles_x, tiles_y


def _check_inputs_rows8(rows8, big_rows, starts, big_n, width, height,
                        span):
    return _check_sorted_rows("rows8", rows8, ROW_F_DISC, big_rows, starts,
                              big_n, width, height, span)


def _check_inputs_rows9(rows9, big_rows, starts, big_n, width, height,
                        span):
    return _check_sorted_rows("rows9", rows9, ROW_F9, big_rows, starts,
                              big_n, width, height, span, regions=2)


def raster_tiles_rows9(rows9, big_rows, starts, big_n, width: int,
                       height: int, span: int = SPAN,
                       split_rows: int = SPLIT_ROWS):
    """The kind-split walk (rows9 and rows8) -> (depth, index): per tile,
    its disc ranges through the exact disc body, its capsule ranges
    through the renormalized segment-frame body, then the dense 16-float
    ``big_rows`` (the first ``big_n`` live) through the exact 16-float
    body.  ``rows9`` are :func:`build_table9`'s rows in sorted order,
    ``starts`` a ``kind_split`` binning's at ``span``.  CUDA tensors
    launch the ``csr6_rows9`` kernel of ``csrc/csr6_raster.cu``; CPU
    tensors take :func:`raster_tiles_rows9_plain`.  A tile of more than
    ``split_rows`` rows is walked by several CTAs whose minima are merged,
    as in :func:`raster_tiles`.  ``.launches`` counts calls."""
    tiles_x, tiles_y = _check_inputs_rows9(rows9, big_rows, starts, big_n,
                                           width, height, span)
    _check_exit_walk(None, None, split_rows, rows9.device,
                     tiles_x * tiles_y, span)
    if rows9.device.type == "cpu":
        return raster_tiles_rows9_plain(rows9, big_rows, starts, big_n,
                                        width, height, span)
    if rows9.device.type != "cuda":
        raise ValueError(f"no csr6 kernel for device {rows9.device}")
    rows9, big_rows, starts, big_n = (
        t.contiguous() for t in (rows9, big_rows, starts, big_n))
    return _launch_walk(
        "csr6_rows9", raster_tiles_rows9, (rows9, big_rows, starts, big_n),
        ((rows9, 4 * ROW_F9), (big_rows, 4 * ROW_F)), big_rows.shape[0],
        width, height, tiles_x, tiles_y, (span,), split_rows, rows9.device)


raster_tiles_rows9.launches = 0


def _eval9d(rows, rid, qx, qy, with_uv):
    """The rows9 disc body (pallas_csr6._make_row_body9d) -> (covered,
    depth, idf, u, v)."""
    px, py, z, r2, idf = (rows[rid, k] for k in range(5))
    dx = qx - px
    dy = qy - py
    return dx * dx + dy * dy <= r2, z, idf, None, None


def _eval9c(rows, rid, qx, qy, with_uv):
    """The rows9 capsule body (pallas_csr6._make_row_body9c, the
    renormalized segment-frame evaluation) -> (covered, depth, idf, u,
    v)."""
    x0, y0, ux, nr0, uy, rhod, z0, sdz, idf = (rows[rid, k]
                                               for k in range(ROW_F9))
    dx = qx - x0
    dy = qy - y0
    a = dx * ux + dy * uy
    g = dy * ux - dx * uy
    t = torch.clamp(a, 0.0, 1.0)
    am = a - t
    d2 = am * am + g * g
    rad = rhod * t - nr0
    z = z0 + sdz * t
    return (d2 <= rad * rad) & (rad > 0), z, idf, None, None


def _windows9c(rows, rect):
    """Windows of rows9 capsule rows: the segment and radii recovered in
    float64 from the renormalized lanes (sdx = ux / (ux^2 + uy^2), r =
    rho * length); rows without a positive finite axis keep the whole
    rectangle."""
    r64 = rows.to(torch.float64)
    x0, y0, ux, nr0, uy, rhod = (r64[:, k] for k in range(6))
    s2 = ux * ux + uy * uy
    ok = (s2 > 0) & torch.isfinite(s2)
    l2 = 1.0 / torch.where(ok, s2, torch.ones_like(s2))
    length = torch.sqrt(l2)
    r0 = -nr0 * length
    rad = torch.maximum(r0.abs(), (r0 + rhod * length).abs())
    return _windows(x0, y0, x0 + ux * l2, y0 + uy * l2, rad, ~ok, rect)


def raster_tiles_rows9_plain(rows9, big_rows, starts, big_n, width: int,
                             height: int, span: int = SPAN):
    """Plain PyTorch version of :func:`raster_tiles_rows9`, on any device:
    each binned row through its kind's body over the window of its
    (anchor, class) tiles, the live big rows through the 16-float body
    over the image, merged as in :func:`raster_tiles_plain`."""
    _check_inputs_rows9(rows9, big_rows, starts, big_n, width, height, span)
    dev = rows9.device
    region, rect = _binned_layout(starts, width, height, span)
    binned = rows9[:region.shape[0]]
    nb = int(big_n[0])
    big = big_rows[:nb]
    groups = [_pair_group(big, _windows16(big, _full_rect(nb, width, height,
                                                          dev)),
                          _eval16, width, False)]
    for kind, evaluate, windows in ((0, _eval9d, _windows8),
                                    (1, _eval9c, _windows9c)):
        sel = region == kind
        rows = binned[sel]
        groups.append(_pair_group(
            rows, windows(rows, tuple(r[sel] for r in rect)), evaluate,
            width, False))
    return _merge_plain(groups, width, height, dev, False)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def check_cap10(cap_rows10: bool, discs_only: bool, bin_triangles: bool,
                allow_exit, cap10_carry: bool = False) -> None:
    """Raise (ValueError) for the ``cap_rows10`` combinations the JAX
    package rejects (``pallas_csr6._raster_core6``)."""
    if cap_rows10 and discs_only:
        raise ValueError("cap_rows10 is the generic-soup narrow-row mode: "
                         "discs_only already rides 8-float rows")
    if cap_rows10 and bin_triangles:
        raise ValueError("cap_rows10 rows have no triangle lanes: triangles "
                         "must ride the big list (bin_triangles=False)")
    if cap10_carry and not cap_rows10:
        raise ValueError("cap10_carry is a cap_rows10 build variant: "
                         "requires cap_rows10=True")
    if allow_exit and cap_rows10:
        raise ValueError("cap_rows10 rows carry no zlb lane: allow_exit "
                         "must be off")


def resolve_exit(allow_exit, discs_only: bool = False, span: int = SPAN,
                 cap_rows10: bool = False, fused_uv: bool = False,
                 kind_split: bool = False) -> bool:
    """Whether the walk takes the z-bucket early exit
    (``pallas_csr6._raster_core6``'s policy): ``None`` turns it on for
    generic soups at span 2 outside ``cap_rows10``; forced on, it raises
    where the JAX package raises.  The kind-split walk has none
    (:func:`_kind_split` raises for it forced on)."""
    if kind_split:
        return False
    if allow_exit is None:
        return (not discs_only) and span == 2 and not cap_rows10
    if allow_exit and cap_rows10:
        raise ValueError("cap_rows10 rows carry no zlb lane: allow_exit "
                         "must be off")
    if allow_exit and fused_uv:
        raise ValueError("fused_uv carries (u, v) through the stride-2 exit "
                         "merge: allow_exit must be off")
    if allow_exit and span != 2:
        raise ValueError(
            "allow_exit requires span=2: the exit bound needs single-class "
            "segments, and span=4 would take 100 of them per tile "
            "((span*(span+1)/2)**2)")
    return bool(allow_exit)


def _raster_core6(prims: ScreenPrimitives, width: int, height: int,
                  max_big: int, shade_rgb, shade_flag, plain: bool = False,
                  discs_only: bool = False, fused_uv: bool = False,
                  span: int = SPAN, kind_split: bool = False,
                  bin_triangles: bool = False, cap_rows10: bool = False,
                  allow_exit=None):
    """Bin, build the rows and walk the tiles -> (depth, index, uv, diag);
    ``uv`` is None unless ``fused_uv`` (then the winner's lambert (u, v)
    images, +inf where the winner is no disc).  Under ``discs_only``,
    ``kind_split`` and ``cap_rows10`` no (P+1, 16) table exists: the
    binned rows are 8, 9 or 10 floats and the big rows are built at the
    big ids.  ``bin_triangles`` bins small triangles into the 16-float
    walk (mesh-LOD droplets).  ``allow_exit`` by :func:`resolve_exit`:
    the 16-float walk and, forced on, the non-fused disc walk at span 2
    take the exit."""
    if fused_uv and not discs_only:
        raise ValueError("fused_uv requires discs_only rows")
    if fused_uv and max_big > FUSED_MAX_BIG:
        raise ValueError(
            f"fused_uv requires a resident big list (max_big <= "
            f"{FUSED_MAX_BIG})")
    check_cap10(cap_rows10, discs_only, bin_triangles, None)
    exit_on = resolve_exit(allow_exit, discs_only, span, cap_rows10,
                           fused_uv, kind_split)
    tiles_x, tiles_y = grid_shape(width, height)
    key_layout(tiles_x * tiles_y, span, exit_on, kind_split)
    with_z = exit_on
    zlb = (z_lower_bound(prims, with_triangles=bin_triangles) if with_z
           else None)
    binned = bin_csr6(prims, width, height, max_big, discs_only, span,
                      kind_split, bin_triangles, with_z=with_z, zlb=zlb)
    ranges = (binned["order"], binned["starts"])
    uv = None
    if cap_rows10:
        big_rows = build_table16_rows(prims, shade_rgb, shade_flag,
                                      binned["big_ids"])
        walk = raster_tiles_cap10_plain if plain else raster_tiles_cap10
        depth, index = walk(build_table10(prims), big_rows, *ranges,
                            binned["big_n"], width, height, span)
    elif kind_split:
        rows9 = build_table9(prims, binned["order"], binned["starts"][-1])
        big_rows = build_table16_rows(prims, shade_rgb, shade_flag,
                                      binned["big_ids"])
        walk = raster_tiles_rows9_plain if plain else raster_tiles_rows9
        depth, index = walk(rows9, big_rows, binned["starts"],
                            binned["big_n"], width, height, span)
    elif discs_only:
        rows8 = build_rows8(prims, shade_flag, binned["order"])
        big_rows = build_table16_rows(prims, shade_rgb, shade_flag,
                                      binned["big_ids"])
        args = (rows8, big_rows, binned["starts"], binned["big_n"], width,
                height, span)
        if fused_uv:
            walk = raster_tiles_disc8_uv_plain if plain \
                else raster_tiles_disc8_uv
            depth, index, *uv = walk(*args)
        elif plain:
            depth, index = raster_tiles_disc8_plain(*args)
        else:
            depth, index = raster_tiles_disc8(
                *args, zmeta=binned["zmeta"] if with_z else None)
    else:
        table = build_table16(prims, shade_rgb, shade_flag,
                              bin_triangles=bin_triangles, zlb=zlb)
        args = (table, *ranges, binned["big_ids"], binned["big_n"], width,
                height, bin_triangles, span)
        if plain:
            depth, index = raster_tiles_plain(*args)
        else:
            depth, index = raster_tiles(
                *args, zmeta=binned["zmeta"] if with_z else None)
    return depth, index, uv, binned["diag"]


def _kind_split(rows8: bool, rows9: bool, discs_only: bool,
                allow_exit, bin_triangles: bool = False,
                cap_rows10: bool = False) -> bool:
    """Whether the rows8/rows9 kind-split walk runs; raises for the
    combinations the JAX package rejects (``_raster_core6``)."""
    if not (rows8 or rows9):
        return False
    if (rows8 and rows9) or discs_only or bin_triangles or cap_rows10:
        raise ValueError(
            "rows8/rows9 are kind-split narrow-row modes for mixed disc + "
            "capsule soups: mutually exclusive with each other and with "
            "cap_rows10, discs_only and bin_triangles")
    if allow_exit:
        raise ValueError("rows8/rows9 rows carry no zlb lane: allow_exit "
                         "must be off")
    return True


def rasterize_csr6(prims: ScreenPrimitives, width: int, height: int,
                   max_big: int = DEFAULT_MAX_BIG, shade_rgb=None,
                   shade_flag=None, plain: bool = False,
                   discs_only: bool = False, span: int = SPAN,
                   rows8: bool = False, rows9: bool = False,
                   bin_triangles: bool = False, cap_rows10: bool = False,
                   allow_exit=None):
    """Bin, build the rows and walk the tiles -> (depth, index, diag).

    ``plain=True`` runs the plain tile walk on any device (the reference
    the CUDA kernels are held against); otherwise the device decides.
    ``span`` (2, 4 or 8) bins prims covering at most span x span tiles.
    ``discs_only`` takes the 8-float disc rows (same winners);
    ``cap_rows10`` the 10-float capsule rows (same winners); ``rows8``
    or ``rows9`` the kind-split 9-float rows (binned capsules through the
    renormalized evaluation); ``bin_triangles`` bins small triangles
    through the dual evaluation (same winners).  ``allow_exit``: the
    z-bucket early exit of the 16-float walk (:func:`resolve_exit`; same
    winners).
    """
    if shade_rgb is None:
        shade_rgb = torch.zeros((prims.count, 3), dtype=torch.float32,
                                device=prims.device)
        shade_flag = torch.zeros((prims.count,), dtype=torch.float32,
                                 device=prims.device)
    depth, index, _, diag = _raster_core6(
        prims, width, height, max_big, shade_rgb, shade_flag, plain=plain,
        discs_only=discs_only, span=span,
        kind_split=_kind_split(rows8, rows9, discs_only, allow_exit,
                               bin_triangles, cap_rows10),
        bin_triangles=bin_triangles, cap_rows10=cap_rows10,
        allow_exit=allow_exit)
    return depth, index, diag


def derive_three_tone(prims: ScreenPrimitives):
    """Representative prim ids per kind and the exactness certificate of
    the ``three_tone`` shade (``pallas_csr6.derive_three_tone``).

    Returns ``(reps, ok)``: ``reps`` (3,) int32 (disc, capsule, triangle)
    representative ids (the first valid prim of each kind; 0 when a kind
    is absent) and ``ok`` a bool tensor, True iff every valid prim of a
    kind shares its representative's color and every valid triangle its
    normal: the precondition under which the three-tone shade equals the
    per-prim ``preshade`` bit for bit.  Callers fall back to the preshade
    path when ``ok`` is False."""
    reps = []
    ok = torch.ones((), dtype=torch.bool, device=prims.device)
    for k in (KIND_DISC, KIND_CAPSULE, KIND_TRIANGLE):
        mask = (prims.kind == k) & prims.valid
        rep = torch.argmax(mask.to(torch.int32))
        reps.append(rep)
        ok = ok & _all_where(mask, prims.color == prims.color[rep])
    tri = (prims.kind == KIND_TRIANGLE) & prims.valid
    ok = ok & _all_where(tri, prims.normal == prims.normal[reps[2]])
    return torch.stack(reps).to(torch.int32), ok


def derive_four_tone(prims: ScreenPrimitives):
    """Like :func:`derive_three_tone`, for soups whose capsules carry two
    colors in two contiguous id runs: the droplet presets (tail capsules
    in the point color, then trails in the trail color;
    ``pallas_csr6.derive_four_tone``).

    Returns ``(vals, ok)``: ``vals`` (5,) int32 = (disc_rep, capA_rep,
    capB_rep, cap_split, tri_rep), where capsules with id < cap_split
    shade from capA_rep and the rest from capB_rep, and ``ok`` True iff
    discs and triangles are per-kind constant (triangles also in their
    normal) and each capsule run is color-constant.  A one-color capsule
    soup gives capB == capA with the split past the last prim."""
    n = prims.count
    dev = prims.device
    ok = torch.ones((), dtype=torch.bool, device=dev)
    reps = {}
    for k in (KIND_DISC, KIND_TRIANGLE):
        mask = (prims.kind == k) & prims.valid
        reps[k] = torch.argmax(mask.to(torch.int32))
        ok = ok & _all_where(mask, prims.color == prims.color[reps[k]])
    tri = (prims.kind == KIND_TRIANGLE) & prims.valid
    ok = ok & _all_where(tri,
                         prims.normal == prims.normal[reps[KIND_TRIANGLE]])
    cap = (prims.kind == KIND_CAPSULE) & prims.valid
    cap_a = torch.argmax(cap.to(torch.int32))  # first valid capsule
    differs = cap & (prims.color != prims.color[cap_a][None, :]).any(dim=1)
    has_b = differs.any()
    first_b = torch.argmax(differs.to(torch.int32))
    split = torch.where(has_b, first_b, torch.full_like(first_b, n))
    cap_b = torch.where(has_b, first_b, cap_a)
    ids = torch.arange(n, device=dev)
    ok = ok & _all_where(cap & (ids >= split),
                         prims.color == prims.color[cap_b])
    return (torch.stack([reps[KIND_DISC], cap_a, cap_b, split,
                         reps[KIND_TRIANGLE]]).to(torch.int32), ok)


def _all_where(mask, same):
    """Every row of ``same`` (P, C) is all True where ``mask`` (P,)."""
    return (same | ~mask[:, None]).all()


def _lambert(u, v, l_cam, shading):
    """Sphere-normal lambert factor from the disc plane coordinates."""
    w2 = torch.clamp(1.0 - u * u - v * v, min=0.0)
    nz = -sqrt_rn(w2)
    ndotl = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
    return shading.ambient + shading.diffuse * torch.clamp(ndotl, min=0.0)


def _tones(uniform_look, device):
    return (const(tone, np.float32, device) for tone in uniform_look)


def shade_by_id(prims: ScreenPrimitives, camera, shading, depth, index,
                shade_rgb, shade_flag, uniform_look=None,
                three_tone=None) -> torch.Tensor:
    """Per-pixel winner-id shade epilogue -> (H, W, 3) rgb; bit-equal to
    ``shade_framebuffer`` (lambert and flat) through one compact 8-float
    per-pixel gather [x0, y0, c0, c1, c2, flag, 0, 0].

    ``uniform_look`` = ((disc rgb), (preshaded rgb)) for two-tone scenes
    (lambert only) narrows the gather to 4 floats [x0, y0, flag, 0] and
    injects the two colors as constants: the same image exactly when the
    scene's colors really are these two.

    ``three_tone`` (lambert only) = (disc, capsule, triangle)
    representative prim ids for per-kind-constant soups, or the four-tone
    (disc, capsule A, capsule B, capsule split, triangle), whose capsules
    below the split id take A's color and the rest B's (the droplet
    presets; :func:`derive_four_tone`).  The tones come from the
    representatives by ``preshade``'s formulas, and the gather narrows to
    4 floats [x0, y0, flag, is_capsule]; ``shade_rgb`` and ``shade_flag``
    are not read (``pallas_csr4._shade_by_id``)."""
    h, w = depth.shape
    dev = depth.device
    hit = torch.isfinite(depth)
    safe = torch.where(hit, index, prims.count).long()
    flat = shading.mode == "flat"
    two_tone = uniform_look is not None and not flat
    three = three_tone is not None and not flat
    zeros = torch.zeros((prims.count, 1), dtype=torch.float32, device=dev)
    if three:
        is_disc = prims.kind == KIND_DISC
        inv_r = 1.0 / torch.clamp(prims.params[:, 3], min=1e-6)
        flag_p = torch.where(is_disc, inv_r, torch.full_like(inv_r, -1.0))
        cols = [prims.params[:, 0:2], flag_p[:, None],
                (prims.kind == KIND_CAPSULE).to(torch.float32)[:, None]]
    elif two_tone:
        cols = [prims.params[:, 0:2], shade_flag[:, None], zeros]
    else:
        cols = [prims.params[:, 0:2], shade_rgb, shade_flag[:, None], zeros,
                zeros]
    table = torch.cat(cols, dim=1)
    table = torch.cat([table, torch.zeros((1, table.shape[1]),
                                          dtype=torch.float32, device=dev)])
    a = table[safe]  # (H, W, 4 | 8)
    if flat:
        rgb = a[..., 2:5]
    else:
        inv_r = a[..., 2 if (two_tone or three) else 5]
        qx, qy = pixel_centers(w, h, dev)
        u = (qx - a[..., 0]) * inv_r
        v = -(qy - a[..., 1]) * inv_r
        l_cam = key_light(camera)
        lit = _lambert(u, v, l_cam, shading)
        if three:
            uc, cap_rgb, ug = _three_tones(prims, shading, l_cam, index,
                                           three_tone)
            rgb = torch.where((inv_r > 0)[..., None], uc * lit[..., None],
                              torch.where((a[..., 3] > 0)[..., None],
                                          cap_rgb, ug))
        elif two_tone:
            uc, ub = _tones(uniform_look, dev)
            rgb = torch.where((inv_r > 0)[..., None], uc * lit[..., None], ub)
        else:
            rgb = torch.where((inv_r > 0)[..., None],
                              a[..., 2:5] * lit[..., None], a[..., 2:5])
    rgb = torch.where(hit[..., None], rgb, background(shading, dev))
    return torch.clamp(rgb, 0.0, 1.0)


def _three_tones(prims, shading, l_cam, index, three_tone):
    """(disc color, per-pixel capsule color, triangle color) of the
    three/four-tone shade, by ``preshade``'s formulas on the
    representative prims (the same float32 inputs and operations, so the
    same results whenever the reps' kinds are constant)."""
    reps = [int(r) for r in three_tone]
    if len(reps) == 5:
        d_rep, c_rep, c_rep2, cap_split, t_rep = reps
    elif len(reps) == 3:
        d_rep, c_rep, t_rep = reps
        c_rep2 = cap_split = None
    else:
        raise ValueError("three_tone takes 3 or 5 prim ids")
    boost = const(shading.trail_boost, np.float32, prims.device)
    ut = torch.clamp(prims.color[c_rep] * boost, 0.0, 1.0)
    if cap_split is not None:
        ut2 = torch.clamp(prims.color[c_rep2] * boost, 0.0, 1.0)
        ut = torch.where((index < cap_split)[..., None], ut, ut2)
    nrm = prims.normal[t_rep]
    ndotl = nrm[0] * l_cam[0] + nrm[1] * l_cam[1] + nrm[2] * l_cam[2]
    lit_g = shading.ambient + shading.diffuse * torch.clamp(ndotl, min=0.0)
    ug = torch.clamp(prims.color[t_rep] * lit_g, 0.0, 1.0)
    return prims.color[d_rep], ut, ug


def shade_uv(camera, shading, depth, u, v, uniform_look) -> torch.Tensor:
    """Gather-free two-tone epilogue over the fused (u, v) images
    (``pallas_csr6._shade_uv``) -> (H, W, 3) rgb.  u and v are the float32
    expressions ``shade_by_id`` evaluates after its gather, taken at the
    winning pair instead, so the image is bit-equal to
    ``shade_by_id(uniform_look=...)``.  Winners that are no disc carry
    u = +inf and take the second tone; their non-finite lambert values
    are selected away."""
    dev = depth.device
    hit = torch.isfinite(depth)
    lit = _lambert(u, v, key_light(camera), shading)
    uc, ub = _tones(uniform_look, dev)
    rgb = torch.where(torch.isfinite(u)[..., None], uc * lit[..., None], ub)
    rgb = torch.where(hit[..., None], rgb, background(shading, dev))
    return torch.clamp(rgb, 0.0, 1.0)


def render_shaded_csr6(prims: ScreenPrimitives, camera, shading,
                       max_big: int = DEFAULT_MAX_BIG, plain: bool = False,
                       discs_only: bool = False, uniform_look=None,
                       allow_exit=None, span: int = SPAN,
                       rows8: bool = False, rows9: bool = False,
                       three_tone=None, bin_triangles: bool = False,
                       cap_rows10: bool = False):
    """Rasterize + shade in one pass -> (rgb, depth, index, diag).

    Two-tone disc scenes (``uniform_look`` with ``discs_only``, lambert,
    ``allow_exit`` not forced on, ``max_big`` <= 511: the JAX package's
    condition) take the fused path: the walk carries the winner's (u, v)
    and :func:`shade_uv` shades without a gather.  Every other case
    shades through :func:`shade_by_id`; under ``three_tone`` (lambert)
    ``preshade`` is skipped, its outputs being read by nothing else.
    ``rows8`` and ``rows9`` take the kind-split walk (one kernel for
    both: they evaluate the same float32 expressions), ``cap_rows10`` the
    10-float capsule walk, ``bin_triangles`` the binned-triangle 16-float
    walk, each at ``span``.  ``allow_exit`` (:func:`resolve_exit`; None
    by the JAX package's policy) turns the z-bucket early exit of the
    16-float walk on or off; the winners do not change."""
    check_supported(shading)
    check_id_range(prims)
    if three_tone is not None and uniform_look is not None:
        raise ValueError("three_tone and uniform_look are exclusive")
    kind_split = _kind_split(rows8, rows9, discs_only, allow_exit,
                             bin_triangles, cap_rows10)
    check_cap10(cap_rows10, discs_only, bin_triangles, allow_exit)
    if three_tone is not None and shading.mode != "flat":
        shade_rgb = torch.zeros((prims.count, 3), dtype=torch.float32,
                                device=prims.device)
        shade_flag = torch.zeros((prims.count,), dtype=torch.float32,
                                 device=prims.device)
    else:
        shade_rgb, shade_flag = preshade(prims, camera, shading)
    fused = (uniform_look is not None and discs_only
             and shading.mode != "flat" and allow_exit is not True
             and max_big <= FUSED_MAX_BIG)
    depth, index, uv, diag = _raster_core6(
        prims, camera.width, camera.height, max_big, shade_rgb, shade_flag,
        plain=plain, discs_only=discs_only, fused_uv=fused, span=span,
        kind_split=kind_split, bin_triangles=bin_triangles,
        cap_rows10=cap_rows10, allow_exit=False if fused else allow_exit)
    if fused:
        rgb = shade_uv(camera, shading, depth, uv[0], uv[1], uniform_look)
    else:
        rgb = shade_by_id(prims, camera, shading, depth, index, shade_rgb,
                          shade_flag, uniform_look=uniform_look,
                          three_tone=three_tone)
    return rgb, depth, index, diag
