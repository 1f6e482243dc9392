"""v5 chunk-binned disc rasterizer for Morton-ordered clouds: the chunk
binning, the chunk table, the CUDA kernel's wrappers and their plain
PyTorch version, and the fused sphere-Lambert epilogue.

The counterpart of ``pointcloud_render_tpu.raster.pallas_csr5``.  The JAX
package keeps v5 out of ``render()``'s dispatch; so does the port: its
entry points are :func:`rasterize_csr5` and :func:`render_shaded_csr5`,
over a cloud that ``scene/spatial.spatial_sort`` has put in Morton order
(the binning is exact for any order; order only decides how much rides
the chunks).

1. ``bin_chunks5``   — ``_bin_chunks5``: runs of ``k`` consecutive prims
   are chunks; each chunk's disc bbox and depth minimum are segment
   reduces; a chunk spanning at most ``max_span`` x ``max_span`` tiles
   emits one ``(tile << ZQ_BITS) | bucket`` key per covered tile out of a
   static ``max_span``^2 slot pattern (the rest sort as sentinels); discs
   of wider chunks spill to singleton rows (one per prim, binned on the
   prim's own 2x2 tile span, at most ``max_spill``); capsules, triangles
   and the discs that fit nowhere ride the big list (by rank in prim
   order, at most ``max_big``).  ``zmeta`` = (zmin, s, thr_scale) spans
   the fitting chunks' depth minima and the spilled prims' depths;
2. ``chunk_table5``  — ``_build_table5`` and ``_build_singletons5``: the
   (C + max_spill + 1, 8k) superrows [px, py, z, r, idf, c0, c1, c2] per
   slot: the ordinary chunks, the singleton rows, one pad row;
3. ``big_params5``   — the (17, max_big) big rows (12 params, id, rgb,
   rflag) and their kinds; ``meta5`` the (16,) meta vector of zmeta and
   :func:`look5`; :func:`tables5` builds the three for one frame;
4. ``raster_tiles5`` / ``raster_tiles5_shaded`` — the ``csr5_raster`` /
   ``csr5_shaded`` kernels of ``csrc/csr5_raster.cu`` on CUDA tensors,
   :func:`raster_tiles5_plain` on CPU tensors.

Knobs: ``k``, ``max_span``, ``max_spill``, ``max_big``, ``entry_capacity``
(the sorted entries past it are dropped), ``tile_h``/``tile_w`` (a tile of
1024 pixels, ``tile_w`` in {16, 32, 64, 128}) and ``uniform_color`` decide
what is binned, dropped or shaded and are honoured; ``check_every`` is the
kernel's exit cadence in superrows (the exit never changes a winner).
``unroll`` and ``chunk_rows`` are TPU performance knobs and have no
effect: the kernel's row winner does not depend on ``unroll`` (its chains
merge by (depth, slot)), and it stages its own chunks.  ``chunk_rows``
must still be a multiple of ``check_every``, as the JAX package asserts.

Contract: winner per pixel = lexicographic min of (depth, primitive id);
inside a superrow the slots ascend in id and merge with a strict ``<``,
across superrows the row winner (z, base id + slot) merges with the full
(depth, id) compare, so the result does not depend on the entry order
(the port's sort is stable, the JAX package's is not: each key holds the
same set of chunk ids).  Ids ride the rows as float32: fewer than 2^24
prims.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_DISC,
    KIND_TRIANGLE,
    ScreenPrimitives,
)
from pointcloud_render_tpu_torch.shading.shade import (
    check_supported,
    key_light,
    pixel_centers,
)
from pointcloud_render_tpu_torch.utils.consts import const
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

F_EMPTY = float(1 << 24)  # > every representable prim id
DEFAULT_K = 16  # prims per chunk (superrow = k * 8 floats)
ROW_F = 8  # px, py, z, r, idf, c0, c1, c2
ZQ_BITS = 10  # chunk-zmin depth buckets in the int32 sort key
DEFAULT_CHUNK_ROWS = 32  # TPU superrows per DMA: no effect here
DEFAULT_CHECK_EVERY = 2  # superrows between two checks of the exit
DEFAULT_MAX_BIG = 1024
DEFAULT_MAX_SPAN = 4  # tiles per axis a binned chunk may cover
DEFAULT_MAX_SPILL = 32768  # singleton rows for discs of wider chunks
PAD8 = np.array([0.0, 0.0, np.inf, 0.0, F_EMPTY, 0.0, 0.0, 0.0],
                np.float32)
BIG_F = 17  # 12 params, id, rgb, rflag
META_F = 16  # zmin, s, thr_scale, light (3), ambient, diffuse, bg (3), uc (3)
# The kernel stages superrows of k * 8 floats in 17 KB of shared memory.
MAX_KERNEL_K = 512
TILE_WIDTHS = (16, 32, 64, 128)


def check_tile_shape(tile_h: int, tile_w: int) -> None:
    """A tile holds 1024 pixels, ``tile_w`` in {16, 32, 64, 128} (the JAX
    package's (8, 128) pixel block)."""
    if tile_h * tile_w != 1024 or tile_w not in TILE_WIDTHS:
        raise ValueError(
            "pallas_csr5 pixel blocks must hold exactly one (8, 128) "
            "f32 VREG: tile_h * tile_w == 1024 with tile_w in "
            "{16, 32, 64, 128}")


def grid5(width: int, height: int, tile_h: int, tile_w: int):
    """(tiles_x, tiles_y) of the tile grid (edge tiles partial)."""
    return -(-width // tile_w), -(-height // tile_h)


def _chunk_reduce(x, c, k, fill, op):
    """``op`` over each run of ``k`` consecutive values, padded with
    ``fill`` to ``c`` runs."""
    pad = torch.full((c * k - x.shape[0],), fill, dtype=x.dtype,
                     device=x.device)
    return op(torch.cat([x, pad]).reshape(c, k), dim=1)


def _bucket(v, zmin, s):
    """int32 ``clip(floor((v - zmin) * s), 0, 2^ZQ_BITS - 1)`` with XLA's
    NaN -> 0 convert."""
    q = torch.clamp(torch.floor((v - zmin) * s), 0.0,
                    float((1 << ZQ_BITS) - 1))
    return torch.nan_to_num(q, nan=0.0).to(torch.int32)


def bin_chunks5(prims: ScreenPrimitives, width: int, height: int,
                tile_h: int = 32, tile_w: int = 32,
                max_big: int = DEFAULT_MAX_BIG,
                max_span: int = DEFAULT_MAX_SPAN,
                max_spill: int = DEFAULT_MAX_SPILL,
                k: int = DEFAULT_K) -> dict:
    """The v5 chunk binning (``pallas_csr5._bin_chunks5``).

    Returns a dict of device tensors (C = ceil(P / k) chunks, T tiles):
      keys      (C*max_span^2 + 4*max_spill,) int32 sorted keys
                ``(tile << ZQ_BITS) | bucket``, sentinels ``T << ZQ_BITS``;
      chunks    the chunk ids in key order (>= C: singleton row C + i);
      starts    (T+1,) int32 — tile t's entries are [starts[t],
                starts[t+1]); starts[T] = the binned entry count;
      big_list  (max_big,) int32 big prims by rank in prim order (-1 =
                empty slot); big_count () int32; big_n (1,) int32;
      zmeta     (3,) float32 (zmin, s, thr_scale) of the exit;
      binnable  (P,) bool: the prim rides its chunk's rows;
      sok, srank (P,) the singleton mask and slot (cumsum rank);
      diag      {"true_entries", "big_overflow"} () int32 tensors.
    The sort is stable (the JAX package's is not): each key holds the same
    set of chunk ids, and the walk does not depend on their order."""
    csr6.check_id_range(prims)
    dev = prims.device
    p = prims.count
    c = -(-p // k)
    tiles_x, tiles_y = grid5(width, height, tile_h, tile_w)
    num_tiles = tiles_x * tiles_y
    inf = const(np.inf, np.float32, dev)
    zero = const(0.0, np.float32, dev)
    is_disc = prims.valid & (prims.kind == KIND_DISC)

    def disc_or(v, fill):
        return torch.where(is_disc, v, fill)

    z = disc_or(prims.params[:, 2], inf)
    cxmin = _chunk_reduce(disc_or(prims.bbox[:, 0], inf), c, k, np.inf,
                          torch.amin)
    cxmax = _chunk_reduce(disc_or(prims.bbox[:, 1], -inf), c, k, -np.inf,
                          torch.amax)
    cymin = _chunk_reduce(disc_or(prims.bbox[:, 2], inf), c, k, np.inf,
                          torch.amin)
    cymax = _chunk_reduce(disc_or(prims.bbox[:, 3], -inf), c, k, -np.inf,
                          torch.amax)
    czmin = _chunk_reduce(z, c, k, np.inf, torch.amin)
    has = torch.isfinite(cxmin)
    tx0 = csr6.tile_of(cxmin, tile_w, tiles_x)
    tx1 = csr6.tile_of(cxmax, tile_w, tiles_x)
    ty0 = csr6.tile_of(cymin, tile_h, tiles_y)
    ty1 = csr6.tile_of(cymax, tile_h, tiles_y)
    none = torch.zeros_like(tx0)
    ntx = torch.where(has, tx1 - tx0 + 1, none)
    nty = torch.where(has, ty1 - ty0 + 1, none)
    fits = has & (ntx <= max_span) & (nty <= max_span)

    # Discs of fitting chunks ride the chunk rows; discs of wider chunks
    # spill to singleton rows (their own 2x2 span); every other valid
    # prim rides the big list.
    binnable = is_disc & torch.repeat_interleave(fits, k)[:p]
    spill = is_disc & torch.repeat_interleave(has & ~fits, k)[:p]
    ptx0, ptx1, pty0, pty1 = csr6.tile_span(prims, tiles_x, tiles_y, tile_w,
                                            tile_h)
    pntx, pnty = ptx1 - ptx0 + 1, pty1 - pty0 + 1
    srank = torch.cumsum(spill.to(torch.int32), 0, dtype=torch.int32) - 1
    sok = spill & (pntx <= 2) & (pnty <= 2) & (srank < max_spill)
    is_big = prims.valid & ~(binnable | sok)

    # The bucket range spans the fitting chunks' zmins and the spilled
    # prims' depths (a spill entry below the fit range would clip to a
    # bucket whose floor exceeds its depth, and the exit could pass it).
    nb = const(float(1 << ZQ_BITS), np.float32, dev)
    zmin = torch.minimum(torch.where(fits, czmin, inf).amin(),
                         torch.where(spill, z, inf).amin())
    zmax = torch.maximum(torch.where(fits, czmin, -inf).amax(),
                         torch.where(spill, z, -inf).amax())
    rngz = zmax - zmin
    s = torch.where(rngz > 0, nb / rngz, zero)
    qz = torch.where(has, _bucket(czmin, zmin, s), none)
    thr_scale = torch.where(s > 0, const(1.0 - 1e-6, np.float32, dev) / s,
                            zero)
    zmeta = torch.stack([torch.where(torch.isfinite(zmin), zmin, zero), s,
                         thr_scale])

    home = ((ty0 * tiles_x + tx0) << ZQ_BITS) | qz
    sent = torch.full_like(home, num_tiles << ZQ_BITS)
    keys = []
    for dy in range(max_span):  # the static slot pattern
        for dx in range(max_span):
            ok = fits & (dx < ntx) & (dy < nty)
            keys.append(torch.where(
                ok, home + ((dy * tiles_x + dx) << ZQ_BITS), sent))
    n_slots = max_span * max_span
    flat_key = torch.stack(keys, dim=1).reshape(-1)
    flat_chunks = torch.arange(c, dtype=torch.int32, device=dev)[:, None] \
        .expand(c, n_slots).reshape(-1)

    # Singleton keys: the 2x2 tiles of the prim's own bbox, bucketed on
    # the same scale.  Slot i of the spill array belongs to singleton row
    # c + i // 4, occupied or not (unoccupied slots keep sentinel keys).
    phome = ((pty0 * tiles_x + ptx0) << ZQ_BITS) | _bucket(z, zmin, s)
    psent = torch.full_like(phome, num_tiles << ZQ_BITS)
    key4 = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        okp = sok
        if dx:
            okp = okp & (pntx == 2)
        if dy:
            okp = okp & (pnty == 2)
        key4.append(torch.where(
            okp, phome + ((dy * tiles_x + dx) << ZQ_BITS), psent))
    skeys = torch.full((max_spill + 1, 4), num_tiles << ZQ_BITS,
                       dtype=torch.int32, device=dev)
    sidx = torch.where(sok, srank, torch.full_like(srank, max_spill))
    skeys.index_put_((sidx.long(),), torch.stack(key4, dim=1))
    spayload = c + torch.div(
        torch.arange(max_spill * 4, dtype=torch.int32, device=dev), 4,
        rounding_mode="floor")
    flat_key = torch.cat([flat_key, skeys[:-1].reshape(-1)])
    flat_chunks = torch.cat([flat_chunks, spayload.to(torch.int32)])
    sorted_keys, perm = torch.sort(flat_key, stable=True)
    sorted_chunks = flat_chunks[perm]
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32,
                          device=dev) << ZQ_BITS
    starts = torch.searchsorted(sorted_keys, bounds).to(torch.int32)

    # The big list by rank in prim order; slot max_big takes the rest.
    big_rank = torch.cumsum(is_big.to(torch.int32), 0, dtype=torch.int32) - 1
    big_idx = torch.where(is_big & (big_rank < max_big), big_rank,
                          torch.full_like(big_rank, max_big))
    big_list = torch.full((max_big + 1,), -1, dtype=torch.int32, device=dev)
    big_list.index_put_((big_idx.long(),),
                        torch.arange(p, dtype=torch.int32, device=dev))
    big_count = is_big.to(torch.int32).sum().to(torch.int32)
    diag = dict(true_entries=starts[num_tiles],
                big_overflow=torch.clamp(big_count - max_big,
                                         min=0).to(torch.int32))
    return dict(keys=sorted_keys, chunks=sorted_chunks.contiguous(),
                starts=starts, big_list=big_list[:max_big].contiguous(),
                big_count=big_count,
                big_n=torch.clamp(big_count, max=max_big).reshape(1),
                zmeta=zmeta, binnable=binnable, sok=sok, srank=srank,
                diag=diag)


def true_entry_count5(prims: ScreenPrimitives, width: int, height: int,
                      tile_h: int = 32, tile_w: int = 32,
                      max_span: int = DEFAULT_MAX_SPAN,
                      max_spill: int = DEFAULT_MAX_SPILL,
                      k: int = DEFAULT_K) -> torch.Tensor:
    """() int32 non-sentinel chunk entries under the chunk binning: a
    finite ``entry_capacity`` below it drops entries."""
    return bin_chunks5(prims, width, height, tile_h, tile_w,
                       max_span=max_span, max_spill=max_spill,
                       k=k)["diag"]["true_entries"]


def bin_diagnostics5(prims: ScreenPrimitives, width: int, height: int,
                     tile_h: int = 32, tile_w: int = 32,
                     max_big: int = DEFAULT_MAX_BIG,
                     max_span: int = DEFAULT_MAX_SPAN,
                     max_spill: int = DEFAULT_MAX_SPILL,
                     k: int = DEFAULT_K) -> torch.Tensor:
    """Big-list overflow count under the chunk binning (0 = exact)."""
    return bin_chunks5(prims, width, height, tile_h, tile_w, max_big,
                       max_span, max_spill, k)["diag"]["big_overflow"]


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _rows8(prims: ScreenPrimitives, mask, shade_rgb) -> torch.Tensor:
    """(P, 8) [px, py, z, r, idf, rgb]: z = +inf and r = 0 outside
    ``mask`` (inert slots whose id lane stays)."""
    dev = prims.device
    idf = torch.arange(prims.count, dtype=torch.float32, device=dev)
    return torch.cat([
        prims.params[:, 0:2],
        torch.where(mask, prims.params[:, 2],
                    const(np.inf, np.float32, dev))[:, None],
        torch.where(mask, prims.params[:, 3],
                    const(0.0, np.float32, dev))[:, None],
        idf[:, None], shade_rgb], dim=1)


def build_table5(prims: ScreenPrimitives, binnable, shade_rgb,
                 k: int = DEFAULT_K) -> torch.Tensor:
    """(C*k, 8) float32 rows [px, py, z, r, idf, c0, c1, c2]
    (``_build_table5``): non-binnable slots are inert (r = 0) with z =
    +inf, so a superrow's depth minimum is its chunk's zmin; the tail
    past P holds PAD8."""
    p = prims.count
    c = -(-p // k)
    pad = torch.as_tensor(PAD8, device=prims.device).expand(c * k - p, ROW_F)
    return torch.cat([_rows8(prims, binnable, shade_rgb), pad])


def build_singletons5(prims: ScreenPrimitives, sok, srank, max_spill: int,
                      shade_rgb, k: int = DEFAULT_K) -> torch.Tensor:
    """(max_spill, 8k) singleton superrows (``_build_singletons5``): the
    spilled prim in slot 0, ``k - 1`` PAD8 slots (z = +inf keeps the row
    depth minimum equal to the prim's depth, its sort bucket)."""
    dev = prims.device
    pad = torch.as_tensor(PAD8, device=dev)
    s8 = pad.expand(max_spill + 1, ROW_F).clone()
    sidx = torch.where(sok, srank, torch.full_like(srank, max_spill))
    s8.index_put_((sidx.long(),), _rows8(prims, sok, shade_rgb))
    tail = pad.repeat(k - 1).expand(max_spill, (k - 1) * ROW_F)
    return torch.cat([s8[:max_spill], tail], dim=1)


def chunk_table5(prims: ScreenPrimitives, binned: dict, max_spill: int,
                 shade_rgb, k: int = DEFAULT_K) -> torch.Tensor:
    """(C + max_spill + 1, 8k) superrows: the ordinary chunks, the
    singleton rows, one PAD8 row (``_raster_core5``'s ``chunk_tab``)."""
    table = build_table5(prims, binned["binnable"], shade_rgb, k)
    sing = build_singletons5(prims, binned["sok"], binned["srank"],
                             max_spill, shade_rgb, k)
    pad_row = torch.as_tensor(np.tile(PAD8, k), device=prims.device)[None]
    return torch.cat([table.reshape(-1, k * ROW_F), sing,
                      pad_row]).contiguous()


def big_params5(prims: ScreenPrimitives, big_list, big_rgb, big_rflag):
    """(17, max_big) float32 big rows [12 params, id, r, g, b, rflag] and
    (max_big,) int32 kinds (-1 in the empty slots)."""
    safe = torch.clamp(big_list, min=0).long()
    kinds = torch.where(big_list >= 0, prims.kind[safe],
                        torch.full_like(big_list, -1))
    params = torch.cat([prims.params[safe], safe.to(torch.float32)[:, None],
                        big_rgb[safe], big_rflag[safe][:, None]], dim=1)
    return params.t().contiguous(), kinds.to(torch.int32).contiguous()


def meta5(zmeta, light, ambient: float, diffuse: float, bg, uc):
    """(16,) float32 [zmin, s, thr_scale, light (3), ambient, diffuse,
    background (3), uniform color (3), 0, 0] (``_raster_core5``'s
    ``meta``); ``light`` a (3,) tensor."""
    dev = zmeta.device
    tail = const([ambient, diffuse, *bg, *uc, 0.0, 0.0], np.float32, dev)
    return torch.cat([zmeta, light.to(torch.float32), tail]).contiguous()


def look5(prims: ScreenPrimitives, camera=None, shading=None,
          uniform_color=None):
    """The fused epilogue's look -> (light (3,), ambient, diffuse,
    background, uniform color), the arguments of :func:`meta5` after
    zmeta: flat shading is ambient 1 and diffuse 0 under no light; no
    ``camera`` gives the zeros the depth/index walk ignores."""
    dev = prims.device
    light = torch.zeros(3, dtype=torch.float32, device=dev)
    uc = (0.0,) * 3 if uniform_color is None else tuple(uniform_color)
    if camera is None:
        return light, 0.0, 0.0, (0.0,) * 3, uc
    bg = tuple(np.asarray(shading.background, np.float32))
    if shading.mode == "flat":
        return light, 1.0, 0.0, bg, uc
    return key_light(camera), shading.ambient, shading.diffuse, bg, uc


def tables5(prims: ScreenPrimitives, binned: dict, shade_rgb, look,
            max_spill: int = DEFAULT_MAX_SPILL, k: int = DEFAULT_K):
    """Everything the walk reads besides the binning -> (chunk table, big
    params, big kinds, meta): ``shade_rgb`` the per-prim color, ``look``
    from :func:`look5`; big discs carry rflag = r (lit per pixel), the
    other big prims -1 (their preshaded color)."""
    big_rflag = torch.where(prims.kind == KIND_DISC, prims.params[:, 3],
                            const(-1.0, np.float32, prims.device))
    tab = chunk_table5(prims, binned, max_spill, shade_rgb, k)
    big_params, big_kinds = big_params5(prims, binned["big_list"], shade_rgb,
                                        big_rflag)
    return tab, big_params, big_kinds, meta5(binned["zmeta"], *look)


# ---------------------------------------------------------------------------
# The walk: kernel wrappers and plain version
# ---------------------------------------------------------------------------

def _check_inputs5(tab, chunks, starts, big_params, big_kinds, big_n, meta,
                   width, height, tile_h, tile_w, k, check_every, walked):
    check_tile_shape(tile_h, tile_w)
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    tiles_x, tiles_y = grid5(width, height, tile_h, tile_w)
    if (tab.dtype != torch.float32 or tab.ndim != 2
            or tab.shape[1] != k * ROW_F):
        raise ValueError(f"the chunk table must be (C', {k * ROW_F}) "
                         "float32")
    for name, t in (("chunks", chunks), ("starts", starts),
                    ("big_kinds", big_kinds), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != tiles_x * tiles_y + 1:
        raise ValueError("starts does not match the tile grid")
    if (big_params.dtype != torch.float32
            or big_params.shape != (BIG_F, big_kinds.shape[0])):
        raise ValueError("big_params must be (17, B) float32 beside (B,) "
                         "big_kinds")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    if meta.dtype != torch.float32 or meta.shape != (META_F,):
        raise ValueError("meta must be (16,) float32")
    if walked is not None and (walked.dtype != torch.int32
                               or walked.shape != (tiles_x * tiles_y,)
                               or walked.device != tab.device
                               or not walked.is_contiguous()):
        raise ValueError("walked must be a contiguous (T,) int32 tensor on "
                         "the table's device")
    csr6._check_one_device(tab, chunks, starts, big_params, big_kinds, big_n,
                           meta)
    return tiles_x, tiles_y


def _raster5(wrapper, fused, uniform, tab, chunks, starts, big_params,
             big_kinds, big_n, meta, width, height, tile_h, tile_w, k,
             check_every, allow_exit, walked):
    tiles_x, tiles_y = _check_inputs5(tab, chunks, starts, big_params,
                                      big_kinds, big_n, meta, width, height,
                                      tile_h, tile_w, k, check_every, walked)
    if tab.device.type == "cpu":
        if walked is not None:
            walked.copy_(starts[1:] - starts[:-1])
        return raster_tiles5_plain(tab, chunks, starts, big_params,
                                   big_kinds, big_n, meta, width, height,
                                   tile_h, tile_w, k, fused, uniform)
    if tab.device.type != "cuda":
        raise ValueError(f"no csr5 kernel for device {tab.device}")
    if not 1 <= k <= MAX_KERNEL_K:
        raise ValueError(f"the csr5 kernels take 1 <= k <= {MAX_KERNEL_K}")
    tab, chunks, starts, big_params, big_kinds, big_n, meta = (
        t.contiguous() for t in (tab, chunks, starts, big_params, big_kinds,
                                 big_n, meta))
    dev = tab.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    index = torch.empty((height, width), dtype=torch.int32, device=dev)
    ints = (big_kinds.shape[0], width, height, tiles_x, tiles_y, tile_h,
            tile_w, k, check_every, int(allow_exit))
    ptrs = (tab, chunks, starts, big_params, big_kinds, big_n, meta, depth,
            index)
    if fused:
        rgb = torch.empty((height, width, 3), dtype=torch.float32,
                          device=dev)
        csr6._launch("csr5_shaded", ptrs + (rgb, walked),
                     ints + (int(uniform),), dev, library="csr5_raster")
        wrapper.launches += 1
        return depth, index, rgb
    csr6._launch("csr5_raster", ptrs + (walked,), ints, dev,
                 library="csr5_raster")
    wrapper.launches += 1
    return depth, index


def raster_tiles5(tab, chunks, starts, big_params, big_kinds, big_n, meta,
                  width: int, height: int, tile_h: int = 32,
                  tile_w: int = 32, k: int = DEFAULT_K,
                  check_every: int = DEFAULT_CHECK_EVERY,
                  allow_exit: bool = True, walked=None):
    """The v5 walk -> (depth (H, W) f32 +inf-empty, index (H, W) i32
    -1-empty): per tile, the live big rows (``big_params[:, :big_n]``,
    triangle or capsule by ``big_kinds``) with the full (depth, id)
    compare, then the superrows ``tab[chunks[i]]``, i in [starts[t],
    starts[t+1]): the ``k`` slots with a strict ``<`` on depth, the row
    winner (z, base id + slot) merged with the full compare.  With
    ``allow_exit`` the kernel stops a tile's run once the depth floor of
    the last superrow's bucket passes the tile's deepest winner, checked
    every ``check_every`` superrows (the exit never changes a winner).
    CUDA tensors launch the ``csr5_raster`` kernel of
    ``csrc/csr5_raster.cu``; CPU tensors take :func:`raster_tiles5_plain`.
    ``walked``, a (T,) int32 tensor, takes each tile's count of superrows
    evaluated before its exit (the whole run on the plain walk).
    ``.launches`` counts launches."""
    return _raster5(raster_tiles5, False, False, tab, chunks, starts,
                    big_params, big_kinds, big_n, meta, width, height,
                    tile_h, tile_w, k, check_every, allow_exit, walked)


raster_tiles5.launches = 0


def raster_tiles5_shaded(tab, chunks, starts, big_params, big_kinds, big_n,
                         meta, width: int, height: int, tile_h: int = 32,
                         tile_w: int = 32, k: int = DEFAULT_K,
                         check_every: int = DEFAULT_CHECK_EVERY,
                         uniform: bool = False, allow_exit: bool = True,
                         walked=None):
    """:func:`raster_tiles5` with the shade fused -> (depth, index, rgb
    (H, W, 3)): the merge carries the winner's px, py, rflag and rgb (the
    uniform color of ``meta`` for binned winners under ``uniform``), and
    the tile's epilogue evaluates :func:`shade5`.  CUDA tensors launch the
    ``csr5_shaded`` kernel; CPU tensors take the plain walk.
    ``.launches`` counts launches."""
    return _raster5(raster_tiles5_shaded, True, uniform, tab, chunks, starts,
                    big_params, big_kinds, big_n, meta, width, height,
                    tile_h, tile_w, k, check_every, allow_exit, walked)


raster_tiles5_shaded.launches = 0


def _eval_slots(rows, rid, qx, qy, with_attr):
    """One binned slot [px, py, z, r, idf, c0, c1, c2] at its pairs ->
    (covered, depth, idf, attrs (px, py, rflag, rgb), None)."""
    px, py, z, r, idf = (rows[rid, j] for j in range(5))
    dx = qx - px
    dy = qy - py
    attrs = rows[rid][:, [0, 1, 3, 5, 6, 7]] if with_attr else None
    return dx * dx + dy * dy <= r * r, z, idf, attrs, None


def _eval_big(rows, rid, qx, qy, with_attr):
    """One big row in the 16-float table layout plus [rflag, rgb] at its
    pairs: the capsule body, or the triangle's where lane 15 is set."""
    cov, z, idf, _, _ = csr6._eval16(rows, rid, qx, qy, False)
    attrs = rows[rid][:, [0, 1, 16, 17, 18, 19]] if with_attr else None
    return cov, z, idf, attrs, None


def _binned_slots(tab, chunks, starts, width, height, tile_h, tile_w, k):
    """(slot rows (N, 8), pixel rectangle) of every binned entry's slots
    that can win (z < +inf), each over its tile."""
    dev = tab.device
    tiles_x, _ = grid5(width, height, tile_h, tile_w)
    n = int(starts[-1])
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    tx, ty = tile % tiles_x, tile // tiles_x
    rows = tab[chunks[:n].long()].reshape(n * k, ROW_F)
    live = rows[:, 2] < float("inf")
    rect = tuple(r.repeat_interleave(k)[live] for r in (
        tx * tile_w, torch.clamp((tx + 1) * tile_w, max=width),
        ty * tile_h, torch.clamp((ty + 1) * tile_h, max=height)))
    return rows[live], rect


def shade5(depth, attrs, meta):
    """The fused sphere-Lambert epilogue (``_make_kernel5``'s, the formula
    of ``shade_framebuffer``) over (H, W) winner attributes (px, py,
    rflag, r, g, b) -> (H, W, 3) rgb: rflag > 0 lit per pixel, else the
    preshaded color, the background where empty, clipped to [0, 1]."""
    h, w = depth.shape
    qx, qy = pixel_centers(w, h, depth.device)
    px, py, rf = attrs[0], attrs[1], attrs[2]
    inv_r = 1.0 / torch.clamp(rf, min=1e-6)
    u = (qx - px) * inv_r
    v = -(qy - py) * inv_r
    nz = -sqrt_rn(torch.clamp(1.0 - u * u - v * v, min=0.0))
    ndotl = u * meta[3] + v * meta[4] + nz * meta[5]
    lit = meta[6] + meta[7] * torch.clamp(ndotl, min=0.0)
    cc = attrs[3:6].permute(1, 2, 0)
    val = torch.where((rf > 0)[..., None], cc * lit[..., None], cc)
    val = torch.where((depth < float("inf"))[..., None], val, meta[8:11])
    return torch.clamp(val, 0.0, 1.0)


def raster_tiles5_plain(tab, chunks, starts, big_params, big_kinds, big_n,
                        meta, width: int, height: int, tile_h: int = 32,
                        tile_w: int = 32, k: int = DEFAULT_K,
                        fused: bool = False, uniform: bool = False):
    """Plain PyTorch version of :func:`raster_tiles5` (``fused``:
    :func:`raster_tiles5_shaded`), on any device: every binned slot that
    can win over its tile's pixels, every live big row over the image,
    each clipped to a window that provably holds every covered pixel,
    merged by the two-step lexicographic min (no early exit: it never
    changes a winner); under ``fused`` the winner's attributes are taken
    at its one winning pair and shaded by :func:`shade5`."""
    _check_inputs5(tab, chunks, starts, big_params, big_kinds, big_n, meta,
                   width, height, tile_h, tile_w, k, 1, None)
    dev = tab.device
    slots, rect = _binned_slots(tab, chunks, starts, width, height, tile_h,
                                tile_w, k)
    if uniform:
        slots = torch.cat([slots[:, :5], meta[11:14].expand(
            slots.shape[0], 3)], dim=1)
    r64 = slots.to(torch.float64)
    window = csr6._windows(r64[:, 0], r64[:, 1], r64[:, 0], r64[:, 1],
                           r64[:, 3].abs(), torch.zeros_like(
                               r64[:, 0], dtype=torch.bool), rect)
    nb = int(big_n[0])
    bp = big_params[:, :nb].t()
    zero = torch.zeros((nb, 2), dtype=torch.float32, device=dev)
    is_tri = (big_kinds[:nb] == KIND_TRIANGLE).to(torch.float32)[:, None]
    big = torch.cat([bp[:, 0:9], bp[:, 12:13], bp[:, 9:12], zero, is_tri,
                     bp[:, 16:17], bp[:, 13:16]], dim=1)
    groups = [
        csr6._pair_group(slots, window, _eval_slots, width, fused),
        csr6._pair_group(big, csr6._windows16(
            big, csr6._full_rect(nb, width, height, dev)), _eval_big, width,
            fused)]
    depth, index = csr6._merge_plain(groups, width, height, dev, False)
    if not fused:
        return depth, index
    flat_d = depth.reshape(-1)
    flat_i = index.reshape(-1).to(torch.float32)
    attrs = torch.zeros((6, height * width), dtype=torch.float32, device=dev)
    attrs[2] = -1.0
    for group in groups:
        for pix, cov, z, idf, a, _ in group():
            keep = cov & (z == flat_d[pix]) & (idf == flat_i[pix])
            attrs[:, pix[keep]] = a[keep].t()
    attrs = attrs.reshape(6, height, width)
    return depth, index, shade5(depth, attrs, meta)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _raster_core5(prims: ScreenPrimitives, width: int, height: int,
                  tile_h: int, tile_w: int, entry_capacity: Optional[int],
                  chunk_rows: int, check_every: int, fused: bool, shade_rgb,
                  look, uniform: bool, max_big: int, max_span: int,
                  max_spill: int, k: int, plain: bool):
    """Bin, build the tables and walk the tiles -> (outputs, diag)."""
    if check_every < 1 or chunk_rows % check_every != 0:
        raise ValueError("chunk_rows must be a multiple of check_every >= 1")
    b = bin_chunks5(prims, width, height, tile_h, tile_w, max_big, max_span,
                    max_spill, k)
    chunks, starts = b["chunks"], b["starts"]
    if entry_capacity is not None:
        e = min(chunks.shape[0], int(entry_capacity))
        chunks, starts = chunks[:e], torch.clamp(starts, max=e)
    tab, big_params, big_kinds, meta = tables5(prims, b, shade_rgb, look,
                                               max_spill, k)
    args = (tab, chunks, starts, big_params, big_kinds, b["big_n"], meta,
            width, height, tile_h, tile_w, k)
    if plain:
        outs = raster_tiles5_plain(*args, fused=fused, uniform=uniform)
    elif fused:
        outs = raster_tiles5_shaded(*args, check_every=check_every,
                                    uniform=uniform)
    else:
        outs = raster_tiles5(*args, check_every=check_every)
    return outs, b["diag"]


def rasterize_csr5(prims: ScreenPrimitives, width: int, height: int,
                   tile_h: int = 32, tile_w: int = 32, unroll: int = 2,
                   entry_capacity: Optional[int] = None,
                   chunk_rows: int = DEFAULT_CHUNK_ROWS,
                   check_every: int = DEFAULT_CHECK_EVERY,
                   max_big: int = DEFAULT_MAX_BIG,
                   max_span: int = DEFAULT_MAX_SPAN,
                   max_spill: int = DEFAULT_MAX_SPILL, k: int = DEFAULT_K,
                   plain: bool = False, return_diag: bool = False):
    """(depth (H, W) f32 +inf-empty, index (H, W) i32 -1-empty[, diag])
    (``rasterize_pallas_csr5``).  Valid discs of chunks spanning at most
    ``max_span``^2 tiles are binned, discs of wider chunks spill to
    singleton rows, everything else rides the big list (capped at
    ``max_big``: ``diag["big_overflow"]``).  With a finite
    ``entry_capacity``, ``diag["true_entries"]`` must not exceed it.
    ``plain=True`` runs the plain walk on any device; otherwise the
    device decides.  ``unroll`` has no effect."""
    del unroll
    check_tile_shape(tile_h, tile_w)
    csr6.check_id_range(prims)
    zeros3 = torch.zeros((prims.count, 3), dtype=torch.float32,
                         device=prims.device)
    (depth, index), diag = _raster_core5(
        prims, width, height, tile_h, tile_w, entry_capacity, chunk_rows,
        check_every, False, zeros3, look5(prims), False, max_big, max_span,
        max_spill, k, plain)
    if return_diag:
        return depth, index, diag
    return depth, index


def render_shaded_csr5(prims: ScreenPrimitives, camera, shading,
                       tile_h: int = 32, tile_w: int = 32, unroll: int = 2,
                       entry_capacity: Optional[int] = None,
                       chunk_rows: int = DEFAULT_CHUNK_ROWS,
                       check_every: int = DEFAULT_CHECK_EVERY,
                       max_big: int = DEFAULT_MAX_BIG,
                       max_span: int = DEFAULT_MAX_SPAN,
                       max_spill: int = DEFAULT_MAX_SPILL,
                       k: int = DEFAULT_K, uniform_color=None,
                       plain: bool = False, return_diag: bool = False):
    """Rasterize and shade in one kernel -> (rgb (H, W, 3), depth, index[,
    diag]) (``render_shaded_csr5``): the per-prim shade of
    ``csr6.preshade``, the walk carrying the winner's attributes, and the
    sphere-Lambert epilogue of :func:`shade5` (the formula of
    ``shade_framebuffer``, lambert or flat).  ``uniform_color`` (r, g, b):
    every binned disc has this color (the presets' constant gray), and
    the kernel takes it from ``meta`` instead of the rows."""
    del unroll
    check_tile_shape(tile_h, tile_w)
    csr6.check_id_range(prims)
    check_supported(shading)
    shade_rgb, _ = csr6.preshade(prims, camera, shading)
    (depth, index, rgb), diag = _raster_core5(
        prims, camera.width, camera.height, tile_h, tile_w, entry_capacity,
        chunk_rows, check_every, True, shade_rgb,
        look5(prims, camera, shading, uniform_color),
        uniform_color is not None, max_big, max_span, max_spill, k, plain)
    if return_diag:
        return rgb, depth, index, diag
    return rgb, depth, index
