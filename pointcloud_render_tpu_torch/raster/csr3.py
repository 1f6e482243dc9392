"""v3 disc fast path: the fixed 2x2 disc binning with a stable sort, the
CUDA kernel's wrapper and its plain PyTorch version, and the fused
8-float shade rows.

The counterpart of ``pointcloud_render_tpu.raster.pallas_csr3`` (the
``pallas3`` backend).  Only discs whose bbox spans at most 2x2 tiles are
binned, one entry per covered tile; capsules, triangles and wider discs
ride the big list (at most ``DEFAULT_MAX_BIG``).  The sort is stable on
``(tile << zq) | z-bucket`` keys over the id-major expansion, so a tile's
run ascends in (z-bucket, prim id) and the walk needs no id tie-break: a
strict ``<`` on depth keeps the first, lowest-id winner (a disc's depth is
constant over its footprint, so equal depths share a bucket).  The walk
tracks the winning ENTRY (its sorted position; big winners as
``-(rank + 2)``), and the shade gathers the entry's 8-float row
``[px, py, z, r^2, c0, c1, c2, flag]``.

1. ``bin_csr_2x2``  — ``_bin_csr_2x2``: keys, the stable sort, the
   per-tile ``starts``, the big list by cumsum rank in prim order and
   ``zmeta`` = (zmin, s, thr_scale) over the binned discs' depth range;
2. ``pack_rows8``   — ``_pack_rows8``: the entry-indexed rows, then the
   big rows, then the background row;
3. ``raster_tiles3`` — the ``csr3_raster`` kernel of
   ``csrc/csr6_raster.cu`` on CUDA tensors (with the z-bucket early
   exit), :func:`raster_tiles3_plain` on CPU tensors;
4. ``resolve_ids`` and the shade of ``render_shaded_csr3``.

Exactness preconditions (the JAX package's): an exact-depth tie between a
big-list prim and a binned disc keeps the big one, which is the
lexicographic (depth, id) winner when big ids sit below binned ids (the
pipeline's ground-first soups); with a finite ``entry_capacity`` the
frame's ``true_entries`` must not exceed it (the sorted entries past it
are dropped).  Ids ride the rows as float32: fewer than 2^24 prims.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.csr4 import NEIGHBOURS, zq_bits
from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_DISC,
    ScreenPrimitives,
)
from pointcloud_render_tpu_torch.shading.shade import (
    background,
    check_supported,
    key_light,
    pixel_centers,
)
from pointcloud_render_tpu_torch.utils.consts import const

TILE = csr6.TILE
ROW_F = 8  # px, py, z, r^2, c0, c1, c2, flag
DEFAULT_MAX_BIG = 1024
IMAX = 2147483647  # the entry image's empty marker
# Entries the kernel walks between two checks of the early exit (1..1024;
# the output does not depend on it): 64 and 128 were the fastest of 64-1024
# on bench.py's disc lane on an H100 (PERF.md §6).
EXIT_BLOCK = 128


def bin_csr_2x2(prims: ScreenPrimitives, width: int, height: int,
                max_big: int = DEFAULT_MAX_BIG) -> dict:
    """The v3 binning (``pallas_csr3._bin_csr_2x2``).

    Valid discs whose bbox spans at most 2x2 tiles bin into one entry per
    covered tile, keyed ``(tile << zq) | qz`` with qz the linear bucket of
    their depth over the binned discs' depth range; every other valid
    prim rides the big list.  Returns a dict of device tensors (T = tiles,
    zq = ``csr4.zq_bits``):
      keys      (4P,) int32 stably sorted keys (T << zq for slots that
                bin nowhere);
      entries   (4P,) int32 prim ids in key order: a tile's run ascends
                in (bucket, prim id);
      starts    (T+1,) int32 — tile t's entries are [starts[t],
                starts[t+1]); starts[T] = the binned entry count;
      big_ids   (max_big,) int32 big prims by rank in prim order (P =
                empty slot); big_n (1,) int32 min(big_count, max_big);
      big_count () int32;
      zmeta     (3,) float32 (zmin, s, thr_scale) of the early exit (all
                zero when no bucket bits fit the key);
      zq_bits   int;
      diag      {"true_entries", "big_overflow"} () int32 tensors.
    """
    csr6.check_id_range(prims)
    dev = prims.device
    p = prims.count
    tiles_x, tiles_y = csr6.grid_shape(width, height)
    num_tiles = tiles_x * tiles_y
    zq = zq_bits(num_tiles)
    tx0, tx1, ty0, ty1 = csr6.tile_span(prims, tiles_x, tiles_y)
    ntx, nty = tx1 - tx0 + 1, ty1 - ty0 + 1
    fits = (ntx <= 2) & (nty <= 2) & (prims.kind == KIND_DISC)
    is_small = prims.valid & fits
    is_big = prims.valid & ~fits
    home = ty0 * tiles_x + tx0
    sent = num_tiles << zq
    if zq > 0:
        nb = const(1 << zq, np.float32, dev)
        inf = const(np.inf, np.float32, dev)
        zero = const(0.0, np.float32, dev)
        z = prims.params[:, 2]
        zmin = torch.where(is_small, z, inf).amin()
        zmax = torch.where(is_small, z, -inf).amax()
        rngz = zmax - zmin
        s = torch.where(rngz > 0, nb / rngz, zero)
        # NaN (prims that never bin) casts to 0, as XLA's convert does.
        qz = torch.nan_to_num(torch.clamp(torch.floor((z - zmin) * s), 0.0,
                                          float((1 << zq) - 1)), nan=0.0)
        home = (home << zq) | qz.to(torch.int32)
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
    # Id-major flattening: a disc has at most one entry per tile, so a
    # tile's run of the stable sort ascends in (bucket, prim id).
    flat = torch.stack(keys, dim=1).reshape(-1).to(torch.int32)
    sorted_keys, flat_order = torch.sort(flat, stable=True)
    entries = torch.div(flat_order, 4, rounding_mode="floor").to(torch.int32)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) << zq
    starts = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    rank = torch.cumsum(is_big.to(torch.int32), 0) - 1
    slot = torch.where(is_big & (rank < max_big), rank,
                       torch.full_like(rank, max_big)).long()
    big_ids = torch.full((max_big + 1,), p, dtype=torch.int32, device=dev)
    big_ids.scatter_(0, slot, torch.arange(p, dtype=torch.int32, device=dev))
    big_count = is_big.to(torch.int32).sum().to(torch.int32)
    diag = dict(
        true_entries=starts[num_tiles],
        big_overflow=torch.clamp(big_count - max_big, min=0).to(torch.int32))
    return dict(keys=sorted_keys, entries=entries, starts=starts,
                big_ids=big_ids[:max_big],
                big_n=torch.clamp(big_count, max=max_big).reshape(1)
                .to(torch.int32).contiguous(),
                big_count=big_count, zmeta=zmeta, zq_bits=zq, diag=diag)


def true_entry_count3(prims: ScreenPrimitives, width: int,
                      height: int) -> torch.Tensor:
    """() int32 binned entries under the 2x2 disc binning: a finite
    ``entry_capacity`` below it drops entries."""
    return bin_csr_2x2(prims, width, height)["diag"]["true_entries"]


def bin_diagnostics3(prims: ScreenPrimitives, width: int, height: int,
                     max_big: int = DEFAULT_MAX_BIG) -> torch.Tensor:
    """Big-list overflow count under the 2x2 disc binning (0 = exact)."""
    return bin_csr_2x2(prims, width, height, max_big)["diag"]["big_overflow"]


def cut_entries(binned: dict, entry_capacity: Optional[int]):
    """(entries, starts) with the sorted entries past a finite
    ``entry_capacity`` dropped and the starts clamped to it
    (``pallas_csr3.py:508-511``)."""
    entries, starts = binned["entries"], binned["starts"]
    if entry_capacity is None:
        return entries, starts
    e = min(entries.shape[0], int(entry_capacity))
    return entries[:e], torch.clamp(starts, max=e)


def pack_rows8(prims: ScreenPrimitives, entries, big_ids, shade_rgb,
               shade_flag, background_rgb) -> torch.Tensor:
    """(E + B + 1, 8) float32 rows [px, py, z, r^2, c0, c1, c2, flag]
    (``pallas_csr3._pack_rows8``): rows [0, E) are the sorted entries'
    prims', rows [E, E + B) the big list's by rank, the last the
    background (flag -1).  Invalid prims' rows and empty big slots (id P)
    are zero; r^2 is squared once per prim, the same float32 multiply as
    per pair."""
    p = prims.count
    dev = prims.device
    r = prims.params[:, 3]
    table8 = torch.cat([prims.params[:, 0:3], (r * r)[:, None], shade_rgb,
                        shade_flag[:, None]], dim=1)
    table8 = torch.where(prims.valid[:, None], table8,
                         torch.zeros_like(table8))
    table8 = torch.cat([table8, torch.zeros((1, ROW_F), dtype=torch.float32,
                                            device=dev)])
    bg = torch.cat([torch.zeros(4, dtype=torch.float32, device=dev),
                    const(background_rgb, np.float32, dev),
                    const([-1.0], np.float32, dev)])[None]
    ids = torch.cat([entries.long(), big_ids.long()])
    return torch.cat([table8[ids], bg]).contiguous()


def _check_inputs3(rows8, big_rows, starts, big_n, zmeta, width, height):
    tiles_x, tiles_y = csr6.grid_shape(width, height)
    if (rows8.dtype != torch.float32 or rows8.ndim != 2
            or rows8.shape[1] != ROW_F):
        raise ValueError("rows8 must be (E, 8) float32")
    if (big_rows.dtype != torch.float32 or big_rows.ndim != 2
            or big_rows.shape[1] != csr6.ROW_F):
        raise ValueError("big_rows must be (B, 16) float32")
    for name, t in (("starts", starts), ("big_n", big_n)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if starts.shape[0] != tiles_x * tiles_y + 1:
        raise ValueError("starts does not match the tile grid")
    if big_n.shape[0] != 1:
        raise ValueError("big_n must hold one element")
    if zmeta.dtype != torch.float32 or zmeta.shape != (3,):
        raise ValueError("zmeta must be (3,) float32")
    csr6._check_one_device(rows8, big_rows, starts, big_n, zmeta)
    return tiles_x, tiles_y


def raster_tiles3(rows8, big_rows, starts, big_n, zmeta, width: int,
                  height: int, zq: int, walked=None, allow_exit: bool = True,
                  block: int = EXIT_BLOCK):
    """The v3 walk -> (depth (H, W) f32 +inf-empty, entry (H, W) i32):
    per tile, the live big rows ``big_rows[:big_n]`` in rank order
    through the 16-float dual evaluation, then the tile's stable run
    ``rows8[starts[t]:starts[t+1]]`` through the disc body, each with a
    strict ``<`` on depth.  The entry image holds the winner's sorted
    position, ``-(rank + 2)`` for a big winner and ``IMAX`` where nothing
    won.  With ``zq`` > 0 and ``allow_exit`` the kernel stops a tile's
    run once the next bucket's depth floor reaches the tile's worst
    winner (it never changes a winner; ``allow_exit=False`` times the
    full walk; ``block`` entries are walked between two checks).  CUDA
    tensors launch the ``csr3_raster`` kernel of
    ``csrc/csr6_raster.cu``; CPU tensors take :func:`raster_tiles3_plain`.
    ``walked``, a (T,) int32 tensor, takes each tile's count of entries
    evaluated before its exit (the whole run on the plain walk).
    ``.launches`` counts launches."""
    tiles_x, tiles_y = _check_inputs3(rows8, big_rows, starts, big_n, zmeta,
                                      width, height)
    if walked is not None and (walked.dtype != torch.int32
                               or walked.shape != (tiles_x * tiles_y,)
                               or walked.device != rows8.device
                               or not walked.is_contiguous()):
        raise ValueError("walked must be a contiguous (T,) int32 tensor on "
                         "the rows' device")
    if rows8.device.type == "cpu":
        if walked is not None:
            walked.copy_(starts[1:] - starts[:-1])
        return raster_tiles3_plain(rows8, big_rows, starts, big_n, zmeta,
                                   width, height, zq)
    if rows8.device.type != "cuda":
        raise ValueError(f"no csr3 kernel for device {rows8.device}")
    rows8, big_rows, starts, big_n, zmeta = (
        t.contiguous() for t in (rows8, big_rows, starts, big_n, zmeta))
    dev = rows8.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    ent = torch.empty((height, width), dtype=torch.int32, device=dev)
    csr6._launch("csr3_raster", (rows8, big_rows, starts, big_n, zmeta,
                                 depth, ent, walked),
                 (big_rows.shape[0], width, height, tiles_x, tiles_y,
                  int(allow_exit and zq > 0), block), dev)
    raster_tiles3.launches += 1
    return depth, ent


raster_tiles3.launches = 0


def _first_winner(groups, n, dev):
    """(depth, key) per pixel over the pairs of ``groups``: the least
    depth (covered pairs with depth < +inf, as a strict ``<`` from +inf
    admits), and among the pairs at that depth the least key — the first
    winner of a walk in key order."""
    depth = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    for group in groups:
        for pix, cov, z, _, _, _ in group():
            keep = cov & (z < float("inf"))
            depth.scatter_reduce_(0, pix[keep], z[keep], reduce="amin")
    key = torch.full((n,), IMAX, dtype=torch.int64, device=dev)
    for group in groups:
        for pix, cov, z, k, _, _ in group():
            keep = cov & (z == depth[pix])
            key.scatter_reduce_(0, pix[keep], k[keep], reduce="amin")
    return depth, key


def _keyed(evaluate):
    """``evaluate`` with the row's position in its group as the key."""
    def ev(rows, rid, qx, qy, with_uv):
        cov, z, _, _, _ = evaluate(rows, rid, qx, qy, with_uv)
        return cov, z, rid, None, None
    return ev


def raster_tiles3_plain(rows8, big_rows, starts, big_n, zmeta, width: int,
                        height: int, zq: int):
    """Plain PyTorch version of :func:`raster_tiles3`, on any device (no
    early exit: the exit never changes a winner).  The big rows, in rank
    order, over the image and the entries over their tile's pixels, each
    clipped to the row's window; per pixel the first winner of each
    stream (least depth, then least rank or entry), and the big one
    where its depth is not above the binned one's (the big list runs
    first and a strict ``<`` never displaces it)."""
    tiles_x, _ = _check_inputs3(rows8, big_rows, starts, big_n, zmeta,
                                width, height)
    dev = rows8.device
    n_pix = width * height
    nb = int(big_n[0])
    big = big_rows[:nb]
    d_big, r_big = _first_winner(
        [csr6._pair_group(big, csr6._windows16(
            big, csr6._full_rect(nb, width, height, dev)),
            _keyed(csr6._eval16), width, False)], n_pix, dev)
    n = int(starts[-1])
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    tx, ty = tile % tiles_x, tile // tiles_x
    rect = (tx * TILE, torch.clamp((tx + 1) * TILE, max=width),
            ty * TILE, torch.clamp((ty + 1) * TILE, max=height))
    binned = rows8[:n]
    d_bin, e_bin = _first_winner(
        [csr6._pair_group(binned, csr6._windows8(binned, rect),
                          _keyed(csr6._eval8), width, False)], n_pix, dev)
    take_bin = d_bin < d_big
    depth = torch.where(take_bin, d_bin, d_big)
    ent = torch.where(take_bin, e_bin,
                      torch.where(d_big < float("inf"), -(r_big + 2),
                                  torch.full_like(r_big, IMAX)))
    return (depth.reshape(height, width),
            ent.to(torch.int32).reshape(height, width))


def resolve_ids(ent, depth, entries, big_ids) -> torch.Tensor:
    """Entry image -> prim-id image (``pallas_csr3._resolve_ids``): binned
    winners read their sorted entry's prim, big winners ``big_ids[rank]``;
    -1 where the depth is infinite."""
    prims_pad = torch.cat([entries, torch.full((1,), -1, dtype=torch.int32,
                                               device=entries.device)])
    binned_id = prims_pad[torch.clamp(ent, 0, prims_pad.shape[0] - 1).long()]
    big_rank = torch.clamp(-ent - 2, 0, big_ids.shape[0] - 1).long()
    idx = torch.where(ent < 0, big_ids[big_rank], binned_id)
    return torch.where(torch.isinf(depth), -1, idx).to(torch.int32)


def _raster_core3(prims, width, height, entry_capacity, shade_rgb,
                  shade_flag, background_rgb):
    """Bin, pack and walk -> (depth, ent, binning, entries, rows) with
    ``rows`` = :func:`pack_rows8` (the walk reads lanes 0-3 of its first
    ``len(entries)`` rows)."""
    b = bin_csr_2x2(prims, width, height)
    entries, starts = cut_entries(b, entry_capacity)
    rows = pack_rows8(prims, entries, b["big_ids"], shade_rgb, shade_flag,
                      background_rgb)
    zeros = torch.zeros((prims.count, 3), dtype=torch.float32,
                        device=prims.device)
    big_rows = csr6.build_table16_rows(prims, zeros, zeros[:, 0],
                                       b["big_ids"])
    depth, ent = raster_tiles3(rows[:entries.shape[0]], big_rows, starts,
                               b["big_n"], b["zmeta"], width, height,
                               b["zq_bits"])
    return depth, ent, b, entries, rows


def rasterize_csr3(prims: ScreenPrimitives, width: int, height: int,
                   entry_capacity: Optional[int] = None):
    """Bin, pack and walk -> (depth, index, diag)
    (``rasterize_pallas_csr3``); the device decides between the kernel
    and the plain walk."""
    zeros = torch.zeros((prims.count, 3), dtype=torch.float32,
                        device=prims.device)
    depth, ent, b, entries, _ = _raster_core3(
        prims, width, height, entry_capacity, zeros, zeros[:, 0],
        (0.0, 0.0, 0.0))
    return (depth, resolve_ids(ent, depth, entries, b["big_ids"]),
            b["diag"])


def render_shaded_csr3(prims: ScreenPrimitives, camera, shading,
                       entry_capacity: Optional[int] = None,
                       uniform_look=None):
    """Rasterize + shade -> (rgb, depth, index, diag)
    (``pallas_csr3.render_shaded_csr3`` with ``return_diag``): the
    winner's 8-float row gathered by its entry (big winners at their
    rank past the entries, empty pixels at the background row), the
    lambert per pixel for discs and the preshaded color otherwise, or
    the row's own color under ``flat``.  ``uniform_look`` = ((disc rgb),
    (preshaded rgb)) of a two-tone scene (lambert only) narrows the
    gather to [px, py, flag] and injects the two colors."""
    check_supported(shading)
    csr6.check_id_range(prims)
    width, height = camera.width, camera.height
    shade_rgb, shade_flag = csr6.preshade(prims, camera, shading)
    depth, ent, b, entries, rows = _raster_core3(
        prims, width, height, entry_capacity, shade_rgb, shade_flag,
        shading.background)
    e = entries.shape[0]
    n_rows = rows.shape[0]
    shade_idx = torch.where(ent == IMAX, n_rows - 1,
                            torch.where(ent < 0, e + (-ent - 2), ent))
    shade_idx = torch.clamp(shade_idx, 0, n_rows - 1).long()
    dev = depth.device
    if uniform_look is not None and shading.mode != "flat":
        a = torch.cat([rows[:, 0:2], rows[:, 7:8]], dim=1)[shade_idx]
        inv_r = a[..., 2]
        qx, qy = pixel_centers(width, height, dev)
        lit = csr6._lambert((qx - a[..., 0]) * inv_r,
                            -(qy - a[..., 1]) * inv_r, key_light(camera),
                            shading)
        uc, ub = csr6._tones(uniform_look, dev)
        rgb = torch.where((inv_r > 0)[..., None], uc * lit[..., None], ub)
    else:
        a = rows[shade_idx]  # (H, W, 8)
        if shading.mode == "flat":
            rgb = a[..., 4:7]
        else:
            inv_r = a[..., 7]
            qx, qy = pixel_centers(width, height, dev)
            lit = csr6._lambert((qx - a[..., 0]) * inv_r,
                                -(qy - a[..., 1]) * inv_r, key_light(camera),
                                shading)
            rgb = torch.where((inv_r > 0)[..., None],
                              a[..., 4:7] * lit[..., None], a[..., 4:7])
    hit = torch.isfinite(depth)
    rgb = torch.clamp(torch.where(hit[..., None], rgb,
                                  background(shading, dev)), 0.0, 1.0)
    index = resolve_ids(ent, depth, entries, b["big_ids"])
    return rgb, depth, index, b["diag"]
