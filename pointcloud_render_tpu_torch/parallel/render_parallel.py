"""Sharded rendering over a ``torch.distributed`` device mesh (the PyTorch
twin of ``pointcloud_render_tpu.parallel.render_parallel``).

The JAX package runs these paths as one ``shard_map`` program over a
device mesh; the port runs them SPMD, one process per rank, over a
``DeviceMesh`` with dimensions ``("frames", "points")``
(:func:`make_render_mesh`).  Every rank of the mesh calls the same
function with the same global arrays; each takes its own block by its
mesh coordinate and returns the replicated result, as the JAX global
arrays read.

* **Point sharding** (``render_point_sharded``,
  ``render_scene_point_sharded``): each rank rasterizes its block of the
  cloud into a private z-buffer with GLOBAL primitive ids, and the
  buffers merge with the lexicographic reduction over the ``"points"``
  group:
      depth*  = all_reduce(MIN, depth)              (empty pixels +inf)
      winner  = all_reduce(MIN, id where depth == depth* else IMAX)
      colour  = all_reduce(SUM, shaded colour where the winner is local)
  The ranks that did not win add -0.0, the exact additive identity
  (+0.0 would turn a winner's -0.0 into +0.0), so the result is the
  single-device frame bit for bit.
* **Frame data parallelism** (``render_batch_sharded``,
  ``render_scene_batch_sharded``, ``render_frames_dp``): each rank renders
  its block of the frame batch; an ``all_gather`` over ``"frames"`` gives
  every rank the whole ``(F, ...)`` batch.

The scene paths map each rank's soup rows to their ids in the full-cloud
soup through the soup's part layout (``run.pipeline.build_primitives(...,
return_layout=True)``): per-point parts are row-major in point index, so
local row j of a part with ``rows`` rows on each of n ranks has global id
``part_start + rank * rows + j``; fixed furniture (the ground) keeps its
ids and is valid on ``"points"`` rank 0 only.  Ids are int32 outside the
kernels, so only each rank's soup must stay below the rows' 2^24 float-id
limit.

Collectives: NCCL on CUDA tensors, gloo on CPU tensors.  Gloo on CUDA
tensors (several ranks on one card, which NCCL refuses) copies each
reduced tensor through the host explicitly (:func:`host_copies`).

Backends (``_rasterize_shard``, as the JAX dispatch): ``pallas4``,
``pallas`` and ``pallas3`` -> the v4 walk, ``pallas6`` and ``auto`` -> the
v6 walk with ``span``, ``bin_triangles``, ``discs_only``, ``allow_exit``,
``cap_rows10``, ``rows8`` and ``max_big`` (``rows9``, ``row_budget`` and
the TPU knobs are dropped, as the JAX package drops them: ROADMAP queue
C), anything else ->
the capped ``tiles.rasterize_tiled`` with ``tile_overflow`` at the
config's ``tile_h``, ``tile_w`` and ``max_per_tile``.  The JAX ``auto`` is
``tiled`` off a TPU; the port's is v6 on every device.  Every entry point
returns the binning overflow summed over the ranks (0: exact).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pointcloud_render_tpu_torch.raster import csr4, csr6, tiles
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    discs_from_points,
)
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.scene.camera import IMAGE_HEIGHT, IMAGE_WIDTH
from pointcloud_render_tpu_torch.shading.shade import (
    background,
    shade_framebuffer,
)
from pointcloud_render_tpu_torch.utils.consts import const

IMAX = 2147483647
AXES = ("frames", "points")


@dataclasses.dataclass(frozen=True)
class ShardedFrame:
    """Replicated render result of a sharded frame (or frame batch)."""

    rgb: torch.Tensor  # (..., H, W, 3) float32
    depth: torch.Tensor  # (..., H, W) float32, +inf empty
    index: torch.Tensor  # (..., H, W) int32 GLOBAL prim id, -1 empty
    overflow: torch.Tensor  # (...,) int32: binned entries dropped; 0 exact


def make_render_mesh(n_frames_axis: int, n_points_axis: int,
                     device_type: str = "cuda") -> DeviceMesh:
    """A ``("frames", "points")`` mesh over the first ``n_frames_axis *
    n_points_axis`` ranks of the world, row-major.  Every rank of the
    world calls it (it creates the groups); ranks past the mesh take no
    part in its renders."""
    need = n_frames_axis * n_points_axis
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    grid = torch.arange(need, dtype=torch.int32).reshape(n_frames_axis,
                                                         n_points_axis)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def mesh_axis(mesh: DeviceMesh, axis: str):
    """-> (size, this rank's coordinate, process group) of ``axis``."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    return size, mesh.get_local_rank(axis), mesh.get_group(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh`` (the current card for CUDA)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_copies(group, device) -> bool:
    """Whether the collectives of ``group`` on ``device`` tensors copy
    through the host: gloo on CUDA tensors (ranks sharing a card)."""
    return torch.device(device).type == "cuda" and \
        dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced by ``op`` over ``group`` (a new tensor where the
    reduction copies through the host, else ``t`` reduced in place)."""
    if host_copies(group, t.device):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along axis 0, in group
    rank order (the mesh coordinate)."""
    dev = t.device
    if host_copies(group, dev):
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts).to(dev)


def merge_winners(depth, gid, group):
    """The lexicographic (depth, id) minimum over ``group`` -> (best depth,
    best id, local_win): ``depth`` +inf and ``gid`` IMAX where empty."""
    best_depth = all_reduce(depth.clone(), dist.ReduceOp.MIN, group)
    contender = torch.where(depth == best_depth, gid, IMAX)
    best_gid = all_reduce(contender, dist.ReduceOp.MIN, group)
    local_win = (gid != IMAX) & (depth == best_depth) & (gid == best_gid)
    return best_depth, best_gid, local_win


def _per_point(c) -> int:
    return c[1] if isinstance(c, tuple) else c


def global_ids(index, layout, shard: int, n_shards: int) -> torch.Tensor:
    """(H, W) int32 ids in the full soup of the local soup rows ``index``
    (IMAX where ``index`` < 0): the static layout walk, with per-point
    parts spread over ``n_shards`` ranks and fixed parts kept."""
    starts, offs, scale = [], [], []
    loc = glob = 0
    for rows, c in layout:
        starts.append(loc)
        offs.append(glob - loc)
        if _per_point(c) == 0:
            scale.append(0)
            glob += rows
        else:
            scale.append(rows)
            glob += rows * n_shards
        loc += rows
    if glob > IMAX:
        raise ValueError(f"the full soup's {glob} rows pass int32 ids")
    dev = index.device
    part = torch.clamp(torch.bucketize(
        index, const(starts, np.int32, dev), right=True) - 1, min=0)
    base = const(offs, np.int64, dev) + shard * const(scale, np.int64, dev)
    gid = index.long() + base[part]
    return torch.where(index >= 0, gid, IMAX).to(torch.int32)


def drop_furniture(prims: ScreenPrimitives, layout) -> ScreenPrimitives:
    """``prims`` with its fixed parts (``rows_per_point == 0`` in the part
    layout, e.g. the ground) marked invalid: every rank but the one that
    draws them (a sharded frame's rank 0, a stream's first chunk on rank
    0) drops them, so they win once."""
    valid = prims.valid
    loc = 0
    for rows, c in layout:
        if _per_point(c) == 0:
            if valid is prims.valid:
                valid = valid.clone()
            valid[loc:loc + rows] = False
        loc += rows
    if valid is prims.valid:
        return prims
    return dataclasses.replace(prims, valid=valid)


def full_rows(layout, n_shards: int) -> int:
    """The full soup's rows of a shard's ``layout``."""
    return sum(rows if _per_point(c) == 0 else rows * n_shards
               for rows, c in layout)


def _merge_and_resolve(prims, camera, depth, index, gid, shading, group,
                       overflow) -> ShardedFrame:
    """Collective lexicographic z-merge and the local winners' shaded
    colour summed over ``group``.  ``depth``/``index`` are the local
    buffers, ``gid`` the global id of each local winner (IMAX empty);
    global ids are unique across ranks, so one rank owns each hit."""
    d = torch.where(index >= 0, depth, float("inf"))
    best_depth, best_gid, local_win = merge_winners(d, gid, group)
    shade_idx = torch.where(local_win, index, -1)
    rgb_local = shade_framebuffer(prims, camera, best_depth, shade_idx,
                                  shading)
    rgb = all_reduce(torch.where(local_win[..., None], rgb_local, -0.0),
                     dist.ReduceOp.SUM, group)
    hit = best_gid != IMAX
    rgb = torch.where(hit[..., None], rgb,
                      background(shading, depth.device))
    return ShardedFrame(
        rgb=rgb, depth=torch.where(hit, best_depth, float("inf")),
        index=torch.where(hit, best_gid, -1),
        overflow=all_reduce(overflow.reshape(1).to(torch.int32),
                            dist.ReduceOp.SUM, group)[0])


def _block(x, lo: int, hi: int, device, axis: int = 0) -> torch.Tensor:
    """float32 ``x[lo:hi]`` along ``axis`` on ``device`` (host arrays are
    sliced before the upload)."""
    sl = (slice(None),) * axis + (slice(lo, hi),)
    if isinstance(x, torch.Tensor):
        return x[sl].to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[sl],
                                                np.float32), device=device)


def _shard_frame(positions, radii, colors, camera, config, shard, n_local,
                 group):
    """One rank's disc-only point-sharded frame -> (rgb, depth, index,
    overflow): flat colours on white, the capped tiled walk, ids offset
    by ``shard * n_local``."""
    offset = shard * n_local
    prims = discs_from_points(positions, camera, radii, colors)
    w, h = camera.width, camera.height
    depth, index, _ = tiles.rasterize_tiled(
        prims, w, h, tile_h=config.tile_h, tile_w=config.tile_w,
        max_per_tile=config.max_per_tile)
    overflow = tiles.tile_overflow(prims, w, h, tile_h=config.tile_h,
                                   tile_w=config.tile_w,
                                   max_per_tile=config.max_per_tile)
    gindex = torch.where(index >= 0, index + offset, IMAX)
    depth = torch.where(index >= 0, depth, float("inf"))
    best_depth, best_gidx, _ = merge_winners(depth, gindex, group)
    local = (best_gidx >= offset) & (best_gidx < offset + n_local)
    local_idx = torch.clamp(best_gidx - offset, 0, n_local - 1).long()
    rgb = all_reduce(torch.where(local[..., None], prims.color[local_idx],
                                 -0.0), dist.ReduceOp.SUM, group)
    hit = best_gidx != IMAX
    rgb = torch.where(hit[..., None], rgb, 1.0)  # white background
    return (rgb, torch.where(hit, best_depth, float("inf")),
            torch.where(hit, best_gidx, -1),
            all_reduce(overflow.reshape(1), dist.ReduceOp.SUM, group)[0])


def render_point_sharded(positions, radii, colors, camera, config,
                         mesh: DeviceMesh, axis: str = "points"):
    """Rasterize one disc-only frame with the cloud sharded over ``axis``.

    ``positions`` (N, 3), ``radii`` (N,) and ``colors`` (N, 3) are the
    global arrays; ``camera`` is on this rank's device.  Returns
    replicated (H, W, 3) rgb, (H, W) depth, global index and the total
    binning overflow (0 = exact; >0 = raise ``max_per_tile``)."""
    n = positions.shape[0]
    n_dev, shard, group = mesh_axis(mesh, axis)
    if n % n_dev:
        raise ValueError(f"point count {n} not divisible by {n_dev}")
    n_local = n // n_dev
    lo, hi = shard * n_local, (shard + 1) * n_local
    dev = mesh_device(mesh)
    return _shard_frame(_block(positions, lo, hi, dev),
                        _block(radii, lo, hi, dev),
                        _block(colors, lo, hi, dev), camera, config, shard,
                        n_local, group)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of tensor / tuple / list / dataclass
    trees of one structure."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t):
        return dataclasses.replace(t, **{
            f.name: _tree_map(fn, *(getattr(x, f.name) for x in trees))
            for f in dataclasses.fields(t)})
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"cannot map over a {type(t).__name__}")


def _frames_block(mesh: DeviceMesh, f: int, axis: str = "frames"):
    """-> (lo, hi, group) of this rank's frames of a batch of ``f``."""
    n_dev, coord, group = mesh_axis(mesh, axis)
    f_local = f // n_dev
    return coord * f_local, (coord + 1) * f_local, group


def _gather_frames(results, group):
    """Per-frame results of this rank -> the whole batch on every rank."""
    stacked = _tree_map(lambda *xs: torch.stack(xs), *results)
    return _tree_map(lambda t: all_gather(t, group), stacked)


def render_batch_sharded(positions, radii, colors, camera, config,
                         mesh: DeviceMesh):
    """Frames x points disc-only batch render.

    ``positions`` (F, N, 3), ``radii`` (F, N), ``colors`` (F, N, 3): F
    divides the ``"frames"`` axis, N the ``"points"`` axis.  Each rank
    renders its point block of its frames, the z-buffers merge over
    ``"points"``, and the frames gather over ``"frames"``.  Returns
    replicated (F, H, W, 3) rgb, (F, H, W) depth and index, (F,)
    overflow."""
    f, n = positions.shape[:2]
    n_pts, shard, pgroup = mesh_axis(mesh, "points")
    if f % mesh_axis(mesh, "frames")[0] or n % n_pts:
        raise ValueError("batch/point axes must divide the mesh axes")
    f_lo, f_hi, fgroup = _frames_block(mesh, f)
    n_local = n // n_pts
    lo, hi = shard * n_local, (shard + 1) * n_local
    dev = mesh_device(mesh)
    frames = [_shard_frame(_block(positions[k], lo, hi, dev),
                           _block(radii[k], lo, hi, dev),
                           _block(colors[k], lo, hi, dev), camera, config,
                           shard, n_local, pgroup)
              for k in range(f_lo, f_hi)]
    return _gather_frames(frames, fgroup)


# ---------------------------------------------------------------------------
# Full-scene sharded rendering (ground + splats + trails, shaded)
# ---------------------------------------------------------------------------


def _rasterize_shard(prims, camera, config):
    """-> (depth, index, overflow) of one rank's soup through the
    config's backend (see the module docstring)."""
    w, h = camera.width, camera.height
    backend = config.backend
    if backend in ("pallas4", "pallas", "pallas3"):
        depth, index, diag = csr4.rasterize_csr4(
            prims, w, h, entry_capacity=config.entry_capacity,
            max_big=config.max_big, bin_triangles=config.bin_triangles)
        return depth, index, diag["big_overflow"]
    if backend in ("pallas6", "auto"):
        depth, index, diag = csr6.rasterize_csr6(
            prims, w, h, max_big=config.max_big, span=config.span,
            bin_triangles=config.bin_triangles,
            discs_only=config.discs_only, allow_exit=config.allow_exit,
            cap_rows10=config.cap_rows10, rows8=config.rows8)
        return depth, index, diag["big_overflow"]
    depth, index, _ = tiles.rasterize_tiled(
        prims, w, h, tile_h=config.tile_h, tile_w=config.tile_w,
        max_per_tile=config.max_per_tile)
    overflow = tiles.tile_overflow(prims, w, h, tile_h=config.tile_h,
                                   tile_w=config.tile_w,
                                   max_per_tile=config.max_per_tile)
    return depth, index, overflow


def _scene_shard_frame(preset, config, shard, n_shards, group, film,
                       droplet_lod, positions, velocities, frame_index,
                       history, rotations) -> ShardedFrame:
    """One rank's slice of a full-scene point-sharded frame: the
    single-device soup (``run.pipeline.build_primitives``) of the local
    points, its rows mapped to their full-cloud soup ids by the part
    layout, the furniture valid on rank 0 only, then the merge."""
    camera = pipeline.frame_camera(preset, frame_index, film[0], film[1],
                                   positions.device)
    prims, layout = pipeline.build_primitives(
        preset, camera, positions, velocities, frame_index, history,
        rotations, droplet_lod=droplet_lod, return_layout=True)
    if shard != 0:
        prims = drop_furniture(prims, layout)
    depth, index, overflow = _rasterize_shard(prims, camera, config)
    gid = global_ids(index, layout, shard, n_shards)
    return _merge_and_resolve(prims, camera, depth, index, gid,
                              config.shading, group, overflow)


def render_scene_point_sharded(preset, positions, config, mesh: DeviceMesh,
                               velocities=None, frame_index=0,
                               history=None, rotations=None,
                               axis: str = "points", width=None, height=None,
                               droplet_lod: str = "capsule") -> ShardedFrame:
    """Full-scene render of ONE frame, point-sharded over ``axis``: the
    single-device ``FramePipeline`` frame's scene (ground, splats or
    droplets, velocity or history trails), winner for winner.

    ``positions`` (N, 3) and the optional ``velocities`` (N, 3),
    ``history`` (T, N, 3) and ``rotations`` (N, 4, 4) are global arrays
    (host or tensor); N must divide the axis.  Returns a replicated
    ShardedFrame on this rank's device."""
    n = positions.shape[0]
    n_dev, shard, group = mesh_axis(mesh, axis)
    if n % n_dev:
        raise ValueError(f"point count {n} not divisible by {n_dev}")
    n_local = n // n_dev
    lo, hi = shard * n_local, (shard + 1) * n_local
    dev = mesh_device(mesh)
    with_history = history is not None and history.shape[0] > 0
    return _scene_shard_frame(
        preset, config, shard, n_dev, group,
        (width or IMAGE_WIDTH, height or IMAGE_HEIGHT), droplet_lod,
        _block(positions, lo, hi, dev),
        None if velocities is None else _block(velocities, lo, hi, dev),
        frame_index,
        _block(history, lo, hi, dev, axis=1) if with_history else None,
        None if rotations is None else _block(rotations, lo, hi, dev))


def render_scene_batch_sharded(preset, positions, velocities, frame_indices,
                               config, mesh: DeviceMesh, width=None,
                               height=None,
                               droplet_lod: str = "capsule") -> ShardedFrame:
    """Frames x points full-scene batch render.

    ``positions``/``velocities`` (F, N, 3): F divides the ``"frames"``
    axis, N the ``"points"`` axis; ``frame_indices`` (F,) the frames'
    camera times.  Velocity-trail presets only (history trails need the
    rolling buffer, see ``run.trajectory``).  Returns a replicated
    ShardedFrame with a leading frame axis."""
    f, n = positions.shape[:2]
    n_pts, shard, pgroup = mesh_axis(mesh, "points")
    if f % mesh_axis(mesh, "frames")[0] or n % n_pts:
        raise ValueError("batch/point axes must divide the mesh axes")
    f_lo, f_hi, fgroup = _frames_block(mesh, f)
    n_local = n // n_pts
    lo, hi = shard * n_local, (shard + 1) * n_local
    dev = mesh_device(mesh)
    film = (width or IMAGE_WIDTH, height or IMAGE_HEIGHT)
    frames = [_scene_shard_frame(
        preset, config, shard, n_pts, pgroup, film, droplet_lod,
        _block(positions[k], lo, hi, dev), _block(velocities[k], lo, hi, dev),
        int(frame_indices[k]), None, None) for k in range(f_lo, f_hi)]
    return _gather_frames(frames, fgroup)


def render_frames_dp(step_fn, frame_args, mesh: DeviceMesh,
                     axis: str = "frames"):
    """Map a single-frame render step over a frame batch sharded on
    ``axis``: this rank calls ``step_fn(*args_k)`` for its block of the
    leading frame axis of ``frame_args``, and the results (a tensor, or
    tuples / lists / dataclasses of them, e.g. FrameBuffers) gather over
    ``axis`` into the replicated ``(F, ...)`` batch.  F must divide the
    axis."""
    f = len(frame_args[0])
    n_dev = mesh_axis(mesh, axis)[0]
    if f % n_dev:
        raise ValueError(f"frame count {f} not divisible by {n_dev}")
    lo, hi, group = _frames_block(mesh, f, axis)
    return _gather_frames([step_fn(*(a[k] for a in frame_args))
                           for k in range(lo, hi)], group)
