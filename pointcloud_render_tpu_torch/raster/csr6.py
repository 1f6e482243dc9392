"""v6 anchor-sorted tile rasterizer: binning, tables, the CUDA kernel's
wrapper and its plain PyTorch version, and the shade epilogue.

The counterpart of ``pointcloud_render_tpu.raster.pallas_csr6`` at span 2
with the big list for wide prims and the ground, in its two row modes:
the generic 16-float rows (discs and capsules binned) and the
``discs_only`` 8-float disc rows (capsules and triangles ride the big
list), the latter also with the winner's lambert (u, v) carried through
the merge for the gather-free two-tone shade.  The stages around the
kernels were XLA in the JAX package and are torch ops here:

1. ``preshade``      — ``pallas_csr3._preshade``: per-prim rgb and flag;
2. ``bin_csr6``      — ``_bin_csr6(with_z=False)``: one unstable sort of
   per-prim (anchor tile, spill class) keys; the sorted tail past the
   binned keys is the big list, truncated at ``max_big``;
   the range ``starts`` by ``searchsorted``; ``diag`` with
   ``big_overflow`` and ``true_entries``;
3. ``build_table16`` — ``pallas_csr4._build_table16``: (P+1, 16) rows;
   under ``discs_only`` ``build_table8`` ((P+1, 8) disc rows) and
   ``build_table16_rows`` (16-float rows at the big ids only);
4. the tile walk: ``raster_tiles`` (16-float rows), ``raster_tiles_disc8``
   and ``raster_tiles_disc8_uv`` (8-float rows) — the kernels of
   ``csrc/csr6_raster.cu`` on CUDA tensors, the ``*_plain`` versions on
   CPU tensors;
5. ``shade_by_id``   — the ``pallas_csr4._shade_by_id`` epilogue (generic
   and ``uniform_look``); ``shade_uv`` — the gather-free
   ``pallas_csr6._shade_uv`` epilogue over the fused (u, v) images.

The z-bucket early exit of the TPU kernel never changes a winner and is
not part of this kernel yet (ROADMAP queue B item 1); keys carry no
z-bucket.

Contract: winner per pixel = lexicographic min of (depth, primitive id);
depth +inf and index -1 where empty.  Ids ride the rows as float32, so a
soup must hold fewer than 2^24 primitives.
"""

from __future__ import annotations

import ctypes

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
K2 = SPAN * SPAN
ROW_F = 16
ROW_F_DISC = 8
DEFAULT_MAX_BIG = 1024
# The fused (u, v) walk keeps the JAX package's precondition: a big list
# of at most FUSED_MAX_BIG rows (its resident big-list chunk, less the pad
# row).
FUSED_MAX_BIG = 511
F_EMPTY = float(1 << 24)  # > every representable prim id
# Class ordinals (0 = none, 1 = x-spill, 2 = both, 3 = y-spill) -> how
# many tiles a prim of that class covers (true_entries weights).
_CLASS_TILES = (1, 2, 4, 2)
# Pair budget of one chunk of the plain rasterizer (bounds its memory).
PLAIN_PAIR_CHUNK = 1 << 23


def grid_shape(width: int, height: int):
    """(tiles_x, tiles_y) of the 32x32 tile grid (edge tiles partial)."""
    return -(-width // TILE), -(-height // TILE)


# ---------------------------------------------------------------------------
# Binning (pallas_csr6._bin_csr6 with span 2, no z-buckets)
# ---------------------------------------------------------------------------

def bin_csr6(prims: ScreenPrimitives, width: int, height: int,
             max_big: int = DEFAULT_MAX_BIG,
             discs_only: bool = False) -> dict:
    """Per-prim (anchor, class) keys, one unstable sort, CSR range starts.

    ``discs_only`` bins discs alone: capsules join the triangles and the
    wide discs on the big list (the 8-float row mode).

    Returns a dict of device tensors:
      order      (P,) int32 prim ids in key order (binned prims first);
      starts     (4T+1,) int32 — starts[4a+c] is the first sorted position
                 with key >= 4a+c; starts[4T] = number of binned prims;
      big_ids    (max_big,) int32 big-list prim ids (P = empty slot);
      big_n      (1,) int32 live big-list length min(big_count, max_big);
      big_count  () int32 number of big prims (valid, not binnable);
      diag       {"big_overflow", "true_entries"} () int32 tensors.
    """
    if prims.count >= (1 << 24):
        raise ValueError("float id encoding supports < 2^24 primitives")
    dev = prims.device
    p = prims.count
    tiles_x, tiles_y = grid_shape(width, height)
    num_tiles = tiles_x * tiles_y
    tw = const(TILE, np.float32, dev)
    xmin, xmax = prims.bbox[:, 0], prims.bbox[:, 1]
    ymin, ymax = prims.bbox[:, 2], prims.bbox[:, 3]

    def tile_of(v, n):
        # Saturate before the int cast (XLA's float->int convert saturates
        # and maps NaN to 0; torch's cast of an out-of-range float does not).
        f = torch.nan_to_num(torch.floor(v / tw), nan=0.0)
        f = torch.clamp(f, -1.0, float(n))
        return torch.clamp(f.to(torch.int32), 0, n - 1)

    tx0, tx1 = tile_of(xmin, tiles_x), tile_of(xmax, tiles_x)
    ty0, ty1 = tile_of(ymin, tiles_y), tile_of(ymax, tiles_y)
    binnable = prims.kind == KIND_DISC
    if not discs_only:
        binnable = binnable | (prims.kind == KIND_CAPSULE)
    sx, sy = tx1 - tx0, ty1 - ty0
    fits = (sx < SPAN) & (sy < SPAN) & binnable
    is_small = prims.valid & fits
    is_big = prims.valid & ~fits
    # Ordinals chosen so every neighbour's class subset is contiguous:
    # left needs {1, 2}, up needs {2, 3}, diagonal {2}.
    cls = sx + 3 * sy - 2 * (sx * sy)
    anchor = ty0 * tiles_x + tx0
    sent_big = num_tiles * K2
    sent_invalid = sent_big + 1
    key = torch.where(is_small, anchor * K2 + cls,
                      torch.where(is_big, sent_big, sent_invalid))
    key = key.to(torch.int32)
    sorted_keys, order = torch.sort(key, stable=False)
    order = order.to(torch.int32)

    bounds = torch.arange(num_tiles * K2 + 2, dtype=torch.int32, device=dev)
    edges = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    starts = edges[:num_tiles * K2 + 1]
    n_small = edges[num_tiles * K2]
    big_count = edges[num_tiles * K2 + 1] - n_small
    # The big list is the sorted tail past the binned prefix; empty slots
    # point at the all-zero pad row P.
    tail = torch.cat([order, torch.full((max_big,), p, dtype=torch.int32,
                                        device=dev)])
    slot = torch.arange(max_big, dtype=torch.int32, device=dev)
    big_n = torch.clamp(big_count, max=max_big)
    big_ids = torch.where(slot < big_n, tail[(n_small + slot).long()],
                          torch.full_like(slot, p))
    cls_counts = (starts[1:] - starts[:-1]).reshape(num_tiles, K2)
    w_cls = const(_CLASS_TILES, np.int32, dev)
    true_entries = (cls_counts.sum(dim=0) * w_cls).sum().to(torch.int32)
    diag = dict(
        true_entries=true_entries,
        big_overflow=torch.clamp(big_count - max_big, min=0).to(torch.int32))
    return dict(order=order, starts=starts, big_ids=big_ids,
                big_n=big_n.reshape(1).contiguous(), big_count=big_count,
                diag=diag)


def bin_diagnostics6(prims: ScreenPrimitives, width: int, height: int,
                     max_big: int = DEFAULT_MAX_BIG,
                     discs_only: bool = False) -> torch.Tensor:
    """Big-list overflow count under the v6 binning (0 = exact).

    ``discs_only`` must mirror the render being certified: it sends every
    capsule to the big list, so a probe without it under-counts and can
    certify a truncating run as exact."""
    return bin_csr6(prims, width, height, max_big,
                    discs_only)["diag"]["big_overflow"]


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


def build_table16(prims: ScreenPrimitives, shade_rgb, shade_flag, idf=None,
                  pad: bool = True) -> torch.Tensor:
    """(P+1, 16) float32 kernel rows; row P is the all-zero pad.

      [0:9]   params 0..8
      [9]     prim id as float32
      [10:13] triangles: the inverse-depth plane (params 9..11);
              else the shade rgb
      [13]    triangles: 0; else the shade flag
      [14]    zlb = min(z0, z0 + dz) (the early exit's depth floor)
      [15]    1.0 for triangles (the dual eval's kind flag), else 0
    Invalid prims' rows are zero (inert under both evaluations).
    ``idf`` / ``pad=False`` serve :func:`build_table16_rows` (a gathered
    sub-soup whose id lane carries the original prim ids, unpadded).
    """
    p = prims.count
    dev = prims.device
    if idf is None:
        idf = torch.arange(p, dtype=torch.float32, device=dev)
    z0 = prims.params[:, 2]
    zlb = torch.minimum(z0, z0 + prims.params[:, 6])
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
                       ids) -> torch.Tensor:
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
                         idf=ids.to(torch.float32), pad=False)


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


# ---------------------------------------------------------------------------
# The tile walks: CUDA kernel wrappers and plain versions
# ---------------------------------------------------------------------------

def _check_ranges(order, starts, big_n, width, height):
    tiles_x, tiles_y = grid_shape(width, height)
    for name, t in (("order", order), ("starts", starts), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != tiles_x * tiles_y * K2 + 1:
        raise ValueError("starts does not match the tile grid")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    return tiles_x, tiles_y


def _check_one_device(*tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_inputs(table, order, starts, big_ids, big_n, width, height):
    if table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] != ROW_F:
        raise ValueError("table must be (P+1, 16) float32")
    if big_ids.dtype != torch.int32 or big_ids.ndim != 1:
        raise ValueError("big_ids must be a 1-D int32 tensor")
    grid = _check_ranges(order, starts, big_n, width, height)
    _check_one_device(table, order, starts, big_ids, big_n)
    return grid


def _check_inputs_disc8(table8, big_rows, order, starts, big_n, width,
                        height):
    if (table8.dtype != torch.float32 or table8.ndim != 2
            or table8.shape[1] != ROW_F_DISC):
        raise ValueError("table8 must be (P+1, 8) float32")
    if (big_rows.dtype != torch.float32 or big_rows.ndim != 2
            or big_rows.shape[1] != ROW_F):
        raise ValueError("big_rows must be (B, 16) float32")
    grid = _check_ranges(order, starts, big_n, width, height)
    _check_one_device(table8, big_rows, order, starts, big_n)
    return grid


def _launch(symbol, ptr_args, int_args, device):
    """Call ``symbol`` of the csr6 kernel library on the current stream of
    ``device``; pointers first, then ints, then the stream.  Raises on a
    refused launch: nothing falls back to a plain version."""
    from pointcloud_render_tpu_torch.utils import kernels  # noqa: PLC0415

    lib = kernels.load("csr6_raster")
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptr_args)
                   + [ctypes.c_int] * len(int_args) + [ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in ptr_args), *int_args, stream)
    if err != 0:
        lib.csr6_error_string.restype = ctypes.c_char_p
        lib.csr6_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{symbol} launch failed: "
                           + lib.csr6_error_string(err).decode())


def raster_tiles(table, order, starts, big_ids, big_n, width: int,
                 height: int):
    """(depth (H, W) f32 +inf-empty, index (H, W) i32 -1-empty).

    CUDA tensors launch the ``csr6_raster`` kernel of
    ``csrc/csr6_raster.cu``; CPU tensors take :func:`raster_tiles_plain`.
    ``raster_tiles.launches`` counts kernel launches.
    """
    tiles_x, tiles_y = _check_inputs(table, order, starts, big_ids, big_n,
                                     width, height)
    if table.device.type == "cpu":
        return raster_tiles_plain(table, order, starts, big_ids, big_n,
                                  width, height)
    if table.device.type != "cuda":
        raise ValueError(f"no csr6 kernel for device {table.device}")
    table, order, starts, big_ids, big_n = (
        t.contiguous() for t in (table, order, starts, big_ids, big_n))
    dev = table.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    index = torch.empty((height, width), dtype=torch.int32, device=dev)
    _launch("csr6_raster", (table, order, starts, big_ids, big_n, depth,
                            index), (width, height, tiles_x, tiles_y), dev)
    raster_tiles.launches += 1
    return depth, index


raster_tiles.launches = 0


def _raster_disc8(wrapper, with_uv, table8, big_rows, order, starts, big_n,
                  width, height):
    tiles_x, tiles_y = _check_inputs_disc8(table8, big_rows, order, starts,
                                           big_n, width, height)
    if table8.device.type == "cpu":
        return _disc8_plain(with_uv, table8, big_rows, order, starts, big_n,
                            width, height)
    if table8.device.type != "cuda":
        raise ValueError(f"no csr6 kernel for device {table8.device}")
    table8, big_rows, order, starts, big_n = (
        t.contiguous() for t in (table8, big_rows, order, starts, big_n))
    dev = table8.device
    n_out = 3 if with_uv else 1
    outs = [torch.empty((height, width), dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    index = torch.empty((height, width), dtype=torch.int32, device=dev)
    _launch("csr6_disc8_uv" if with_uv else "csr6_disc8",
            (table8, big_rows, order, starts, big_n, outs[0], index,
             *outs[1:]),
            (big_rows.shape[0], width, height, tiles_x, tiles_y), dev)
    wrapper.launches += 1
    return (outs[0], index, *outs[1:])


def raster_tiles_disc8(table8, big_rows, order, starts, big_n, width: int,
                       height: int):
    """The ``discs_only`` walk -> (depth, index): binned rows are the
    8-float disc rows of :func:`build_table8` gathered by ``order``, the
    big list the dense 16-float ``big_rows`` (its first ``big_n`` rows
    live).  CUDA tensors launch the ``csr6_disc8`` kernel of
    ``csrc/csr6_raster.cu``; CPU tensors take
    :func:`raster_tiles_disc8_plain`.  ``.launches`` counts launches."""
    return _raster_disc8(raster_tiles_disc8, False, table8, big_rows, order,
                         starts, big_n, width, height)


raster_tiles_disc8.launches = 0


def raster_tiles_disc8_uv(table8, big_rows, order, starts, big_n, width: int,
                          height: int):
    """:func:`raster_tiles_disc8` that also carries the winner's lambert
    plane coordinates -> (depth, index, u, v): u = (qx - px) * flag and
    v = -(qy - py) * flag at the winning pair for discs (binned, or wide
    on the big list), +inf for triangle and capsule winners and where
    empty.  CUDA tensors launch the ``csr6_disc8_uv`` kernel; CPU tensors
    take :func:`raster_tiles_disc8_uv_plain`."""
    return _raster_disc8(raster_tiles_disc8_uv, True, table8, big_rows,
                         order, starts, big_n, width, height)


raster_tiles_disc8_uv.launches = 0


def _eval16(rows, rid, qx, qy, with_uv):
    """The 16-float row evaluation (pallas_csr4._make_row_body16 with the
    triangle dual), in its exact expression order -> (covered, depth,
    idf, u, v); (u, v) as pallas_csr6._make_big_body16_uv carries them
    (None unless ``with_uv``)."""
    x0, y0, z0, r0, sdx, sdy, sdz, sdr, il2, idf, t9, t10, t11, flag, _, kf \
        = (rows[rid, k] for k in range(ROW_F))
    dx = qx - x0
    dy = qy - y0
    t = torch.clamp((dx * sdx + dy * sdy) * il2, 0.0, 1.0)
    cx = dx - t * sdx
    cy = dy - t * sdy
    rad = r0 + sdr * t
    z = z0 + sdz * t
    cov = cx * cx + cy * cy <= rad * rad
    e0 = x0 * qy - y0 * qx + z0
    e1 = r0 * qy - sdx * qx + sdy
    e2 = sdz * qy - sdr * qx + il2
    iz = e0 * t9 + e1 * t10 + e2 * t11
    cov_t = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (iz > 0)
    z_t = 1.0 / torch.where(iz > 0, iz, torch.ones_like(iz))
    is_tri = kf > 0
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


def _windows16(rows, rect):
    r64 = rows.to(torch.float64)
    x0, y0, r0 = r64[:, 0], r64[:, 1], r64[:, 3]
    rad = torch.maximum(r0.abs(), (r0 + r64[:, 7]).abs())
    return _windows(x0, y0, x0 + r64[:, 4], y0 + r64[:, 5], rad,
                    rows[:, 15] > 0, rect)


def _windows8(rows, rect):
    r64 = rows.to(torch.float64)
    x0, y0 = r64[:, 0], r64[:, 1]
    rad = torch.sqrt(torch.clamp(r64[:, 3], min=0.0))
    return _windows(x0, y0, x0, y0, rad, torch.zeros_like(x0, dtype=torch.bool),
                    rect)


def _binned_rects(order, starts, width, height):
    """(sorted prim ids, pixel rectangle) of the binned rows: each sorted
    position below ``starts[4T]`` covers the tiles its (anchor, class)
    names."""
    tiles_x, _ = grid_shape(width, height)
    dev = starts.device
    n_small = int(starts[-1])
    pos = torch.arange(n_small, dtype=torch.int64, device=dev)
    j = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    anchor, cls = j // K2, j % K2
    ax, ay = anchor % tiles_x, anchor // tiles_x
    spill_x = ((cls == 1) | (cls == 2)).to(torch.int64)
    spill_y = ((cls == 2) | (cls == 3)).to(torch.int64)
    rect = (ax * TILE, torch.clamp((ax + 1 + spill_x) * TILE, max=width),
            ay * TILE, torch.clamp((ay + 1 + spill_y) * TILE, max=height))
    return order[:n_small].to(torch.int64), rect


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


def raster_tiles_plain(table, order, starts, big_ids, big_n, width: int,
                       height: int):
    """Plain PyTorch version of the 16-float tile walk, on any device.

    Evaluates the same rows as the kernel: each binned row (sorted
    position below ``starts[4T]``) over the pixels of the tiles its
    (anchor, class) covers, each live big-list row over the whole image —
    both clipped to a window around the row's extent that provably holds
    every covered pixel.  The pairs are enumerated in chunks of at most
    ``PLAIN_PAIR_CHUNK`` and merged with a two-step lexicographic min, so
    the result is exact and order-independent.
    """
    _check_inputs(table, order, starts, big_ids, big_n, width, height)
    dev = table.device
    ids, rect = _binned_rects(order, starts, width, height)
    binned = table[ids]
    nb = int(big_n[0])
    big = table[big_ids[:nb].to(torch.int64)]
    groups = [
        _pair_group(binned, _windows16(binned, rect), _eval16, width, False),
        _pair_group(big, _windows16(big, _full_rect(nb, width, height, dev)),
                    _eval16, width, False)]
    return _merge_plain(groups, width, height, dev, False)


def _disc8_plain(with_uv, table8, big_rows, order, starts, big_n, width,
                 height):
    _check_inputs_disc8(table8, big_rows, order, starts, big_n, width, height)
    dev = table8.device
    ids, rect = _binned_rects(order, starts, width, height)
    binned = table8[ids]
    nb = int(big_n[0])
    big = big_rows[:nb]
    groups = [
        _pair_group(binned, _windows8(binned, rect), _eval8, width, with_uv),
        _pair_group(big, _windows16(big, _full_rect(nb, width, height, dev)),
                    _eval16, width, with_uv)]
    return _merge_plain(groups, width, height, dev, with_uv)


def raster_tiles_disc8_plain(table8, big_rows, order, starts, big_n,
                             width: int, height: int):
    """Plain PyTorch version of :func:`raster_tiles_disc8`, on any device:
    the disc body over each binned row's window, the 16-float body over
    the live big rows, merged as in :func:`raster_tiles_plain`."""
    return _disc8_plain(False, table8, big_rows, order, starts, big_n, width,
                        height)


def raster_tiles_disc8_uv_plain(table8, big_rows, order, starts, big_n,
                                width: int, height: int):
    """Plain PyTorch version of :func:`raster_tiles_disc8_uv`: (u, v) are
    taken at the one pair that wins (depth, id), +inf elsewhere."""
    return _disc8_plain(True, table8, big_rows, order, starts, big_n, width,
                        height)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _raster_core6(prims: ScreenPrimitives, width: int, height: int,
                  max_big: int, shade_rgb, shade_flag, plain: bool = False,
                  discs_only: bool = False, fused_uv: bool = False):
    """Bin, build the rows and walk the tiles -> (depth, index, uv, diag);
    ``uv`` is None unless ``fused_uv`` (then the winner's lambert (u, v)
    images, +inf where the winner is no disc).  Under ``discs_only`` no
    (P+1, 16) table exists: the binned rows are 8 floats and the big rows
    are built at the big ids."""
    if fused_uv and not discs_only:
        raise ValueError("fused_uv requires discs_only rows")
    if fused_uv and max_big > FUSED_MAX_BIG:
        raise ValueError(
            f"fused_uv requires a resident big list (max_big <= "
            f"{FUSED_MAX_BIG})")
    binned = bin_csr6(prims, width, height, max_big, discs_only)
    ranges = (binned["order"], binned["starts"])
    uv = None
    if discs_only:
        table8 = build_table8(prims, shade_flag)
        big_rows = build_table16_rows(prims, shade_rgb, shade_flag,
                                      binned["big_ids"])
        if fused_uv:
            walk = raster_tiles_disc8_uv_plain if plain \
                else raster_tiles_disc8_uv
            depth, index, *uv = walk(table8, big_rows, *ranges,
                                     binned["big_n"], width, height)
        else:
            walk = raster_tiles_disc8_plain if plain else raster_tiles_disc8
            depth, index = walk(table8, big_rows, *ranges, binned["big_n"],
                                width, height)
    else:
        table = build_table16(prims, shade_rgb, shade_flag)
        walk = raster_tiles_plain if plain else raster_tiles
        depth, index = walk(table, *ranges, binned["big_ids"],
                            binned["big_n"], width, height)
    return depth, index, uv, binned["diag"]


def rasterize_csr6(prims: ScreenPrimitives, width: int, height: int,
                   max_big: int = DEFAULT_MAX_BIG, shade_rgb=None,
                   shade_flag=None, plain: bool = False,
                   discs_only: bool = False):
    """Bin, build the rows and walk the tiles -> (depth, index, diag).

    ``plain=True`` runs the plain tile walk on any device (the reference
    the CUDA kernels are held against); otherwise the device decides.
    ``discs_only`` takes the 8-float disc rows (same winners).
    """
    if shade_rgb is None:
        shade_rgb = torch.zeros((prims.count, 3), dtype=torch.float32,
                                device=prims.device)
        shade_flag = torch.zeros((prims.count,), dtype=torch.float32,
                                 device=prims.device)
    depth, index, _, diag = _raster_core6(
        prims, width, height, max_big, shade_rgb, shade_flag, plain=plain,
        discs_only=discs_only)
    return depth, index, diag


def _lambert(u, v, l_cam, shading):
    """Sphere-normal lambert factor from the disc plane coordinates."""
    w2 = torch.clamp(1.0 - u * u - v * v, min=0.0)
    nz = -sqrt_rn(w2)
    ndotl = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
    return shading.ambient + shading.diffuse * torch.clamp(ndotl, min=0.0)


def _tones(uniform_look, device):
    return (const(tone, np.float32, device) for tone in uniform_look)


def shade_by_id(prims: ScreenPrimitives, camera, shading, depth, index,
                shade_rgb, shade_flag, uniform_look=None) -> torch.Tensor:
    """Per-pixel winner-id shade epilogue -> (H, W, 3) rgb; bit-equal to
    ``shade_framebuffer`` (lambert and flat) through one compact 8-float
    per-pixel gather [x0, y0, c0, c1, c2, flag, 0, 0].

    ``uniform_look`` = ((disc rgb), (preshaded rgb)) for two-tone scenes
    (lambert only) narrows the gather to 4 floats [x0, y0, flag, 0] and
    injects the two colors as constants: the same image exactly when the
    scene's colors really are these two."""
    h, w = depth.shape
    dev = depth.device
    hit = torch.isfinite(depth)
    safe = torch.where(hit, index, prims.count).long()
    two_tone = uniform_look is not None and shading.mode != "flat"
    if two_tone:
        cols = [prims.params[:, 0:2], shade_flag[:, None],
                torch.zeros((prims.count, 1), dtype=torch.float32,
                            device=dev)]
    else:
        cols = [prims.params[:, 0:2], shade_rgb, shade_flag[:, None],
                torch.zeros((prims.count, 2), dtype=torch.float32,
                            device=dev)]
    table = torch.cat(cols, dim=1)
    table = torch.cat([table, torch.zeros((1, table.shape[1]),
                                          dtype=torch.float32, device=dev)])
    a = table[safe]  # (H, W, 4 | 8)
    if shading.mode == "flat":
        rgb = a[..., 2:5]
    else:
        inv_r = a[..., 2 if two_tone else 5]
        qx, qy = pixel_centers(w, h, dev)
        u = (qx - a[..., 0]) * inv_r
        v = -(qy - a[..., 1]) * inv_r
        lit = _lambert(u, v, key_light(camera), shading)
        if two_tone:
            uc, ub = _tones(uniform_look, dev)
            rgb = torch.where((inv_r > 0)[..., None], uc * lit[..., None], ub)
        else:
            rgb = torch.where((inv_r > 0)[..., None],
                              a[..., 2:5] * lit[..., None], a[..., 2:5])
    rgb = torch.where(hit[..., None], rgb, background(shading, dev))
    return torch.clamp(rgb, 0.0, 1.0)


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
                       allow_exit=None):
    """Rasterize + shade in one pass -> (rgb, depth, index, diag).

    Two-tone disc scenes (``uniform_look`` with ``discs_only``, lambert,
    ``allow_exit`` not forced on, ``max_big`` <= 511: the JAX package's
    condition) take the fused path: the walk carries the winner's (u, v)
    and :func:`shade_uv` shades without a gather.  Every other case
    shades through :func:`shade_by_id`.  ``allow_exit`` has no other
    effect here (the kernels have no depth early exit yet)."""
    check_supported(shading)
    shade_rgb, shade_flag = preshade(prims, camera, shading)
    fused = (uniform_look is not None and discs_only
             and shading.mode != "flat" and allow_exit is not True
             and max_big <= FUSED_MAX_BIG)
    depth, index, uv, diag = _raster_core6(
        prims, camera.width, camera.height, max_big, shade_rgb, shade_flag,
        plain=plain, discs_only=discs_only, fused_uv=fused)
    if fused:
        rgb = shade_uv(camera, shading, depth, uv[0], uv[1], uniform_look)
    else:
        rgb = shade_by_id(prims, camera, shading, depth, index, shade_rgb,
                          shade_flag, uniform_look=uniform_look)
    return rgb, depth, index, diag
