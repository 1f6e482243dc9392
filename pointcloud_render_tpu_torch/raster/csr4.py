"""v4 generic binned tile rasterizer: the 2x2 entry binning with z-bucket
keys, the CUDA kernel's wrapper and its plain PyTorch version.

The counterpart of ``pointcloud_render_tpu.raster.pallas_csr4`` (the
``pallas4`` backend).  Where v6 sorts one key per prim and walks four
neighbour ranges per tile, v4 expands every binned prim into the up-to-four
(tile, z-bucket) entries its 2x2-tile bbox covers and sorts those, so a
tile's rows are one contiguous range of prim ids that ascends in the bucket
of their depth lower bound.  The kernel stops a tile's walk once no later
entry can reach any of its pixels (the z-bucket early exit); the exit never
changes a winner, so the plain version walks every entry.

1. ``bin_csr4``  — ``_bin_csr4``: the fixed 2x2 expansion into
   ``(tile << zq) | bucket`` keys, one unstable sort, the per-tile
   ``starts`` by ``searchsorted``, the big list by cumsum rank in prim
   order, and ``zmeta`` = (zmin, s, thr_scale) over the binned prims' zlb;
2. ``csr6.build_table16`` — the shared 16-float rows (lane 14 = zlb);
3. ``raster_tiles4`` — the ``csr4_raster`` kernel of
   ``csrc/csr6_raster.cu`` (a split walk, as the v6 walk's) on CUDA
   tensors, :func:`raster_tiles4_plain` on CPU tensors;
4. ``csr6.shade_by_id`` — the ``pallas_csr4._shade_by_id`` epilogue.

``entry_capacity`` is semantic: entries past it are dropped, and the
``true_entries`` certificate says whether any were.  ``bin_triangles``
bins small triangles too (the mesh-LOD droplets) and evaluates the
entries through the triangle-aware dual; v4 and v6 then render the same
frames bit for bit.  Ids ride the rows as float32: fewer than 2^24 prims.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.csr6 import z_lower_bound
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives
from pointcloud_render_tpu_torch.shading.shade import check_supported
from pointcloud_render_tpu_torch.utils.consts import const

TILE = csr6.TILE
DEFAULT_MAX_BIG = 1024
# The 2x2 expansion, in the JAX package's static order.
NEIGHBOURS = ((0, 0), (1, 0), (0, 1), (1, 1))

def zq_bits(num_tiles: int) -> int:
    """Depth-bucket bits packed below the tile id in the sort key
    (``pallas_csr3._zq_bits``: (num_tiles + 1) << bits stays within
    int16); 4 at 1080p."""
    b = 0
    while b < 4 and ((num_tiles + 1) << (b + 1)) <= 32767:
        b += 1
    return b


def bin_csr4(prims: ScreenPrimitives, width: int, height: int,
             max_big: int = DEFAULT_MAX_BIG, bin_triangles: bool = False,
             zlb=None) -> dict:
    """The v4 binning (``pallas_csr4._bin_csr4``).

    Discs and capsules (and triangles under ``bin_triangles``) whose bbox
    spans at most 2x2 tiles bin into one entry per covered tile, keyed
    ``(tile << zq) | bucket`` with the bucket of their zlb; wider prims and
    other kinds ride the big list.  Returns a dict of device tensors (T =
    tiles, zq = :func:`zq_bits`):
      keys       (4P,) int32 sorted keys (tile << zq | bucket; T << zq for
                 slots that bin nowhere);
      entries    (4P,) int32 prim ids in key order (binned entries first);
      starts     (T+1,) int32 — tile t's entries are [starts[t],
                 starts[t+1]); starts[T] = the binned entry count;
      big_ids    (max_big,) int32 big prims by rank in prim order (P =
                 empty slot); big_n (1,) int32 min(big_count, max_big);
      big_count  () int32 number of big prims (valid, not binnable);
      zmeta      (3,) float32 (zmin, s, thr_scale) of the early exit;
      zq_bits    int;
      diag       {"true_entries", "big_overflow"} () int32 tensors.
    The sort is unstable: entry order inside a (tile, bucket) run is
    arbitrary, and winners do not depend on it (per-pair id tie-break).
    ``zlb`` is :func:`z_lower_bound` when the caller has it already.
    """
    csr6.check_id_range(prims)
    dev = prims.device
    p = prims.count
    tiles_x, tiles_y = csr6.grid_shape(width, height)
    num_tiles = tiles_x * tiles_y
    zq = zq_bits(num_tiles)
    tx0, tx1, ty0, ty1 = csr6.tile_span(prims, tiles_x, tiles_y)
    ntx, nty = tx1 - tx0 + 1, ty1 - ty0 + 1
    binnable = csr6.binnable_kinds(prims, bin_triangles=bin_triangles)
    fits = (ntx <= 2) & (nty <= 2) & binnable
    is_small = prims.valid & fits
    is_big = prims.valid & ~fits
    home = ty0 * tiles_x + tx0
    sent = num_tiles << zq
    if zq > 0:
        nb = const(1 << zq, np.float32, dev)
        if zlb is None:
            zlb = z_lower_bound(prims, with_triangles=bin_triangles)
        inf = const(np.inf, np.float32, dev)
        zmin = torch.where(is_small, zlb, inf).amin()
        zmax = torch.where(is_small, zlb, -inf).amax()
        rngz = zmax - zmin
        zero = const(0.0, np.float32, dev)
        s = torch.where(rngz > 0, nb / rngz, zero)
        # NaN (rows that never bin) casts to 0, as XLA's convert does.
        qz = torch.nan_to_num(torch.clamp(torch.floor((zlb - zmin) * s), 0.0,
                                          float((1 << zq) - 1)), nan=0.0)
        qz = qz.to(torch.int32)
        home = (home << zq) | qz
        thr_scale = torch.where(
            s > 0, const(1.0 - 1e-6, np.float32, dev) / s, zero)
        zmeta = torch.stack([torch.where(torch.isfinite(zmin), zmin, zero),
                             s, thr_scale])
    else:
        zmeta = torch.zeros(3, dtype=torch.float32, device=dev)
    keys = []
    for dx, dy in NEIGHBOURS:
        ok = is_small
        if dx:
            ok = ok & (ntx == 2)
        if dy:
            ok = ok & (nty == 2)
        keys.append(torch.where(ok, home + ((dy * tiles_x + dx) << zq),
                                sent))
    flat = torch.stack(keys, dim=1).reshape(-1).to(torch.int32)
    sorted_keys, flat_order = torch.sort(flat, stable=False)
    entries = torch.div(flat_order, 4, rounding_mode="floor").to(torch.int32)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) << zq
    starts = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    # The big list by rank in prim order; slot max_big takes the rest.
    rank = torch.cumsum(is_big.to(torch.int32), 0) - 1
    slot = torch.where(is_big & (rank < max_big), rank,
                       torch.full_like(rank, max_big)).long()
    big_ids = torch.full((max_big + 1,), p, dtype=torch.int32, device=dev)
    big_ids.scatter_(0, slot, torch.arange(p, dtype=torch.int32, device=dev))
    big_count = is_big.to(torch.int32).sum().to(torch.int32)
    big_n = torch.clamp(big_count, max=max_big)
    diag = dict(
        true_entries=starts[num_tiles],
        big_overflow=torch.clamp(big_count - max_big, min=0).to(torch.int32))
    return dict(keys=sorted_keys, entries=entries, starts=starts,
                big_ids=big_ids[:max_big],
                big_n=big_n.reshape(1).to(torch.int32).contiguous(),
                big_count=big_count, zmeta=zmeta, zq_bits=zq, diag=diag)


def true_entry_count4(prims: ScreenPrimitives, width: int, height: int,
                      bin_triangles: bool = False) -> torch.Tensor:
    """() int32 binned entries under the v4 binning: a finite
    ``entry_capacity`` below it drops entries."""
    return bin_csr4(prims, width, height,
                    bin_triangles=bin_triangles)["diag"]["true_entries"]


def bin_diagnostics4(prims: ScreenPrimitives, width: int, height: int,
                     max_big: int = DEFAULT_MAX_BIG,
                     bin_triangles: bool = False) -> torch.Tensor:
    """Big-list overflow count under the v4 binning (0 = exact)."""
    return bin_csr4(prims, width, height, max_big,
                    bin_triangles)["diag"]["big_overflow"]


def _check_inputs4(table, entries, starts, big_ids, big_n, zmeta, width,
                   height):
    tiles_x, tiles_y = csr6.grid_shape(width, height)
    if (table.dtype != torch.float32 or table.ndim != 2
            or table.shape[1] != csr6.ROW_F):
        raise ValueError("table must be (P+1, 16) float32")
    for name, t in (("entries", entries), ("starts", starts),
                    ("big_ids", big_ids), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != tiles_x * tiles_y + 1:
        raise ValueError("starts does not match the tile grid")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    if zmeta.dtype != torch.float32 or zmeta.shape != (3,):
        raise ValueError("zmeta must be (3,) float32")
    csr6._check_one_device(table, entries, starts, big_ids, big_n, zmeta)
    return tiles_x, tiles_y


def raster_tiles4(table, entries, starts, big_ids, big_n, zmeta, width: int,
                  height: int, zq: int, bin_triangles: bool = False,
                  walked=None, split_rows: int = csr6.SPLIT_ROWS4):
    """The v4 walk -> (depth (H, W) f32 +inf-empty, index (H, W) i32
    -1-empty): per tile, the live big rows ``table[big_ids[:big_n]]``
    through the dual evaluation, then the entries ``table[entries[i]]``,
    i in [starts[t], starts[t+1]) (through the dual under
    ``bin_triangles``, else the capsule body), with the z-bucket early
    exit of ``zmeta`` when ``zq`` > 0.  CUDA tensors launch the
    ``csr4_raster`` kernel of ``csrc/csr6_raster.cu`` (a split walk: a
    tile of more than ``split_rows`` rows, at least 1, is walked by
    several CTAs whose minima are merged; the kernel may take larger
    items, and the result does not depend on it); CPU tensors take
    :func:`raster_tiles4_plain`.  ``walked``, a (T,) int32 tensor, takes
    each tile's count of entries evaluated before its exit (the whole
    range on the plain walk, which has none; with the exit on, a split
    tile's items share their depths as they run, so it may differ between
    runs, the images do not).  ``.launches`` counts calls."""
    tiles_x, tiles_y = _check_inputs4(table, entries, starts, big_ids, big_n,
                                      zmeta, width, height)
    csr6._check_exit_walk(None, walked, split_rows, table.device,
                          tiles_x * tiles_y, csr6.SPAN)
    if table.device.type == "cpu":
        if walked is not None:
            walked.copy_(starts[1:] - starts[:-1])
        return raster_tiles4_plain(table, entries, starts, big_ids, big_n,
                                   zmeta, width, height, zq, bin_triangles)
    if table.device.type != "cuda":
        raise ValueError(f"no csr4 kernel for device {table.device}")
    table, entries, starts, big_ids, big_n, zmeta = (
        t.contiguous() for t in (table, entries, starts, big_ids, big_n,
                                 zmeta))
    dev = table.device
    # The exit's depths shared by a split tile's items (the kernel's plan
    # resets those it reads).
    front = torch.empty((tiles_x * tiles_y, TILE * TILE), dtype=torch.int32,
                        device=dev) if zq > 0 else None
    return csr6._launch_walk(
        "csr4_raster", raster_tiles4,
        (table, entries, starts, big_ids, big_n, zmeta, front, walked),
        ((table, 4 * csr6.ROW_F),), big_ids.shape[0], width, height, tiles_x,
        tiles_y, (zq, int(bin_triangles)), split_rows, dev)


raster_tiles4.launches = 0


def raster_tiles4_plain(table, entries, starts, big_ids, big_n, zmeta,
                        width: int, height: int, zq: int,
                        bin_triangles: bool = False,
                        split_rows: int = csr6.SPLIT_ROWS4):
    """Plain PyTorch version of :func:`raster_tiles4`, on any device: every
    entry over its tile's pixels (no early exit: the exit never changes a
    winner) and the live big rows over the image, each clipped to the
    row's window, merged by the two-step lexicographic min.
    ``split_rows`` (at least 1) cuts nothing here: the result is the
    kernel's at every split."""
    _check_inputs4(table, entries, starts, big_ids, big_n, zmeta, width,
                   height)
    if split_rows < 1:
        raise ValueError("split_rows must be >= 1")
    tiles_x, _ = csr6.grid_shape(width, height)
    n = int(starts[-1])
    pos = torch.arange(n, dtype=torch.int64, device=table.device)
    tile = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    tx, ty = tile % tiles_x, tile // tiles_x
    rect = (tx * TILE, torch.clamp((tx + 1) * TILE, max=width),
            ty * TILE, torch.clamp((ty + 1) * TILE, max=height))
    return csr6.plain_walk16(table, entries[:n].to(torch.int64), rect,
                             big_ids, big_n, width, height, bin_triangles)


def _raster_core4(prims: ScreenPrimitives, width: int, height: int,
                  max_big: int, entry_capacity: Optional[int], shade_rgb,
                  shade_flag, bin_triangles: bool, plain: bool):
    """Bin, build the rows and walk the tiles -> (depth, index, diag).
    A finite ``entry_capacity`` keeps the first that many sorted entries
    (the TPU kernel's static row gather); ``diag["true_entries"]`` above it
    certifies that entries were dropped."""
    zlb = z_lower_bound(prims, with_triangles=bin_triangles)
    b = bin_csr4(prims, width, height, max_big, bin_triangles, zlb=zlb)
    entries, starts = b["entries"], b["starts"]
    if entry_capacity is not None:
        e = min(entries.shape[0], int(entry_capacity))
        entries = entries[:e]
        starts = torch.clamp(starts, max=e)
    table = csr6.build_table16(prims, shade_rgb, shade_flag,
                               bin_triangles=bin_triangles, zlb=zlb)
    walk = raster_tiles4_plain if plain else raster_tiles4
    depth, index = walk(table, entries, starts, b["big_ids"], b["big_n"],
                        b["zmeta"], width, height, b["zq_bits"],
                        bin_triangles)
    return depth, index, b["diag"]


def rasterize_csr4(prims: ScreenPrimitives, width: int, height: int,
                   entry_capacity: Optional[int] = None,
                   max_big: int = DEFAULT_MAX_BIG,
                   bin_triangles: bool = False, plain: bool = False):
    """Bin, build the rows and walk the tiles -> (depth, index, diag)
    (``rasterize_pallas_csr4``).  ``plain=True`` runs the plain walk on any
    device; otherwise the device decides."""
    zeros = torch.zeros((prims.count, 3), dtype=torch.float32,
                        device=prims.device)
    return _raster_core4(prims, width, height, max_big, entry_capacity,
                         zeros, zeros[:, 0], bin_triangles, plain)


def render_shaded_csr4(prims: ScreenPrimitives, camera, shading,
                       entry_capacity: Optional[int] = None,
                       max_big: int = DEFAULT_MAX_BIG,
                       bin_triangles: bool = False, plain: bool = False):
    """Rasterize + shade -> (rgb, depth, index, diag)
    (``render_shaded_csr4``): ``csr6.preshade``, the v4 walk and the
    generic ``csr6.shade_by_id`` epilogue."""
    check_supported(shading)
    csr6.check_id_range(prims)  # before the preshade's work
    shade_rgb, shade_flag = csr6.preshade(prims, camera, shading)
    depth, index, diag = _raster_core4(
        prims, camera.width, camera.height, max_big, entry_capacity,
        shade_rgb, shade_flag, bin_triangles, plain)
    rgb = csr6.shade_by_id(prims, camera, shading, depth, index, shade_rgb,
                           shade_flag)
    return rgb, depth, index, diag
