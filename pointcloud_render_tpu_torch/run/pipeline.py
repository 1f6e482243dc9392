"""The per-frame pipeline: load -> standardize -> transform -> render -> save.

The PyTorch twin of ``pointcloud_render_tpu.run.pipeline``.  The host side
keeps the reference's exact state semantics (float64 NumPy standardize and
transform); the device side is float32 on ``FramePipeline.device``.
PyTorch runs eagerly, so there is no compiled-step cache.

Ported: the sphere splats, the droplets' capsule LOD (head disc and
tapered tail capsule, velocity-aligned, or oriented by the reference's
seeded random rotations when the cloud has no velocities) and mesh LOD
(the reference's 16x20 teardrop instanced per point, as triangles), the
velocity trails at a fixed segment count or adaptive per trail
(``trail_segments="adaptive"``), the Catmull-Rom history-fit trails
(every preset: traj_ball, traj_vel, traj with its history window, the
other sphere + velocity presets and the example preset's static cloud,
whose 3-D stacks ``process`` iterates), and the look passes: the shadow
map, the GGX ground lobe, the GI fill and supersampled antialiasing
(``render_array``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from pointcloud_render_tpu_torch.configs import ScenePreset
from pointcloud_render_tpu_torch.geometry import droplet as droplet_mod
from pointcloud_render_tpu_torch.geometry import rotation as rotation_mod
from pointcloud_render_tpu_torch.geometry import trails as trails_mod
from pointcloud_render_tpu_torch.io import loaders, png
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    capsules_from_polylines,
    capsules_from_vertex_columns,
    discs_from_points,
    triangles_from_mesh,
)
from pointcloud_render_tpu_torch.raster.project import project_points
from pointcloud_render_tpu_torch.raster.render import (
    FrameBuffers,
    RasterConfig,
    check_config,
    ground_plane,
    render,
)
from pointcloud_render_tpu_torch.scene import normalize
from pointcloud_render_tpu_torch.scene.camera import (
    IMAGE_HEIGHT,
    IMAGE_WIDTH,
    TARGETS,
    Camera,
    camera_origin_torch,
)
from pointcloud_render_tpu_torch.shading import aa, shadow
from pointcloud_render_tpu_torch.shading.shade import (
    check_mode,
    has_look,
    shade_framebuffer,
    without_look,
)
from pointcloud_render_tpu_torch.utils.consts import const

# Straight velocity trails render as this many collinear capsules (the
# reference's 20-segment union, subsampled; see the JAX pipeline).
VEL_TRAIL_RENDER_SEGMENTS = 8
# How many times a frame whose big list overflowed is re-rendered with a
# larger list before the pipeline gives up.
MAX_RENDER_ATTEMPTS = 5
# Capsules per trail of the adaptive build (trail_segments="adaptive"):
# its soup has trail_segments=4's shapes and layout; each trail uses k of
# them.
TRAIL_ADAPTIVE_BUDGET = 4
# The tile edge the adaptive segment count assumes (a heuristic input:
# any k renders exactly).
_TILE = 32.0


def _trail_extents(positions, direction, trail_length, camera,
                   radius_world):
    """(ex, ey): each straight trail's screen extents in pixels, from its
    two projected endpoints and their projected radii."""
    n = positions.shape[0]
    far = positions + direction * trail_length[:, None]
    both = torch.cat([positions, far])
    pr = project_points(both, camera, radii=torch.full_like(
        both[:, 0], float(radius_world)))
    px, py, r = pr["px"], pr["py"], pr["r_px"]
    ex = (px[n:] - px[:n]).abs() + r[:n] + r[n:]
    ey = (py[n:] - py[:n]).abs() + r[:n] + r[n:]
    return ex, ey


def _cheapest_segment_counts(ex, ey, budget: int = TRAIL_ADAPTIVE_BUDGET):
    """(N,) int32: the k in 1..budget of the fewest tile slots for trails
    of screen extents (ex, ey).  A straight trail cut into k capsules
    bins about k (ex / 32k + 1) (ey / 32k + 1) slots; a k whose capsules
    would reach past 3 tiles (the span-4 binning) costs 1e6 more, so only
    trails that no k fits ride the big list.  Ties take the smallest k."""
    dev = ex.device
    emax = torch.maximum(ex, ey)
    penalty = const(1e6, np.float32, dev)
    zero = const(0.0, np.float32, dev)
    costs = []
    for kk in range(1, budget + 1):
        # Divisors as tensors: the CUDA kernel of x / python_scalar
        # multiplies by the reciprocal.
        width = const(_TILE * kk, np.float32, dev)
        c = kk * (ex / width + 1.0) * (ey / width + 1.0)
        over = emax / const(kk, np.float32, dev) > 3.0 * _TILE
        costs.append(c + torch.where(over, penalty, zero))
    return torch.stack(costs).argmin(dim=0).to(torch.int32) + 1


def _adaptive_trail_segment_counts(positions, direction, trail_length,
                                   camera, radius_world,
                                   budget: int = TRAIL_ADAPTIVE_BUDGET):
    """(N,) int32: each trail's segment count k in 1..budget, the one that
    bins the fewest tile slots (the JAX pipeline's heuristic, float32 op
    for op; on the device, without a host sync)."""
    return _cheapest_segment_counts(
        *_trail_extents(positions, direction, trail_length, camera,
                        radius_world), budget)


def check_droplet_lod(droplet_lod: str) -> None:
    """Raise for a droplet LOD that does not exist."""
    if droplet_lod not in ("capsule", "mesh"):
        raise ValueError(f"unknown droplet_lod {droplet_lod!r}")


def scene_config(preset: ScenePreset, config: RasterConfig,
                 droplet_lod: str) -> RasterConfig:
    """The per-scene config policy of the JAX pipeline's ``_make_step``:
    disc and capsule soups (spheres, capsule-LOD droplets) get
    ``no_triangles``; mesh-LOD droplets under ``auto`` get
    ``bin_triangles`` (the v6 walk bins the droplets' small triangles, and
    only the ground rides the big list; on the CPU its plain version does
    the same).  An explicit backend keeps its config as given."""
    if preset.splat == "sphere" or droplet_lod != "mesh":
        return dataclasses.replace(config, no_triangles=True)
    if config.backend == "auto":
        return dataclasses.replace(config, bin_triangles=True)
    return config


def build_primitives(preset: ScenePreset, camera: Camera, positions,
                     velocities=None, frame_index=0, history=None,
                     rotations=None, droplet_lod: str = "capsule",
                     trail_segments: Optional[Union[int, str]] = None,
                     return_layout: bool = False):
    """Assemble the frame's primitive soup on the camera's device.

    Primitive order (= depth-tie priority): ground, splats (capsule-LOD
    droplets: head discs, then tail capsules; mesh-LOD droplets: the
    instanced teardrops' triangles), trails.  Droplets take their
    orientation from ``rotations`` ((N, 4, 4)), else from the velocities,
    else the identity.  ``trail_segments`` overrides
    VEL_TRAIL_RENDER_SEGMENTS (1..20); ``"adaptive"`` cuts each velocity
    trail into its own k in 1..TRAIL_ADAPTIVE_BUDGET capsules
    (``_adaptive_trail_segment_counts``), whose vertices are the k-segment
    build's, in TRAIL_ADAPTIVE_BUDGET capsules per point (those past k
    invalid: they sort past every binned key), so the soup has
    ``trail_segments=4``'s layout.  History presets fit their trails
    through ``history`` ((H, N, 3) prior positions, oldest first; 20
    capsules per point) when it holds a frame.  ``return_layout=True``
    also returns the soup's part layout as a list of ``(rows,
    rows_per_point)`` (0 for fixed furniture like the ground); every
    per-point part is row-major in point index.  The near clip emits the
    mesh's triangles in two blocks of F rows per point, recorded as two
    entries.
    """
    dev = camera.device
    positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
    if velocities is not None:
        velocities = torch.as_tensor(velocities, dtype=torch.float32,
                                     device=dev)
    parts = [ground_plane(camera, preset.ground_half_extent,
                          preset.ground_center)]
    per_point = [0]
    n = positions.shape[0]
    color = np.asarray(preset.point_color, np.float32)
    if preset.splat == "sphere":
        parts.append(discs_from_points(
            positions, camera,
            torch.full((n,), preset.point_radius, dtype=torch.float32,
                       device=dev), color))
        per_point.append(1)
    elif preset.splat == "droplet":
        check_droplet_lod(droplet_lod)
        if rotations is None:
            if velocities is None:
                rotations = torch.eye(4, dtype=torch.float32,
                                      device=dev).expand(n, 4, 4)
            else:
                rotations = rotation_mod.rotation_matrices_from_velocities(
                    velocities, positions)
        rotations = torch.as_tensor(rotations, dtype=torch.float32,
                                    device=dev)
        if droplet_lod == "mesh":
            verts, faces = droplet_mod.instance_droplets(rotations,
                                                         positions)
            tris = triangles_from_mesh(verts, faces, camera, color)
            parts.append(tris)
            per_point.append(("split2", tris.count // (2 * n) if n else 0))
        else:
            # Capsule LOD: head sphere + tapering tail along the rotated
            # -z axis (column 2 of R gives R @ (0,0,-1) = tail direction).
            tail_dir = -rotations[:, :3, 2]
            tip = positions + tail_dir * droplet_mod.TAIL_TIP_OFFSET
            parts.append(discs_from_points(
                positions, camera,
                torch.full((n,), droplet_mod.BASE_RADIUS,
                           dtype=torch.float32, device=dev), color))
            per_point.append(1)
            taper = const(droplet_mod.TAIL_RADII, np.float32,
                          dev).expand(n, 2)
            ones = torch.ones((n,), dtype=torch.bool, device=dev)
            parts.append(capsules_from_vertex_columns(
                [positions, tip], [ones, ones], camera, taper, color))
            per_point.append(1)
    else:
        raise ValueError(f"unknown splat kind {preset.splat!r}")

    if preset.trail == "velocity" and velocities is not None:
        segs = (VEL_TRAIL_RENDER_SEGMENTS if trail_segments is None
                else trail_segments)
        if segs == "adaptive":
            direction, tlen, _ = trails_mod.velocity_trail_lengths(
                positions, velocities, frame_index, preset.trail_schedule)
            k = _adaptive_trail_segment_counts(positions, direction, tlen,
                                               camera, preset.trail_radius)
            pts, vertex_valid = trails_mod.velocity_trails_adaptive(
                positions, velocities, frame_index, k,
                TRAIL_ADAPTIVE_BUDGET, preset.trail_schedule)
            parts.append(capsules_from_polylines(
                pts, vertex_valid, camera, preset.trail_radius,
                np.asarray(preset.trail_color, np.float32)))
            per_point.append(TRAIL_ADAPTIVE_BUDGET)
        else:
            if segs not in range(1, trails_mod.N_TRAIL_POINTS + 1):
                raise ValueError(
                    "trail_segments must be 'adaptive' or in 1.."
                    f"{trails_mod.N_TRAIL_POINTS}")
            sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS,
                                       segs + 1)).astype(np.int32)
            vcols, valid = trails_mod.velocity_trail_vertex_columns(
                positions, velocities, frame_index, sub,
                preset.trail_schedule)
            parts.append(capsules_from_vertex_columns(
                vcols, [valid] * len(vcols), camera, preset.trail_radius,
                np.asarray(preset.trail_color, np.float32)))
            per_point.append(len(vcols) - 1)
    elif (preset.trail == "history" and history is not None
          and history.shape[0] > 0):
        pts, valid, keep = trails_mod.catmull_rom_trails(
            torch.as_tensor(history, dtype=torch.float32, device=dev),
            positions)
        parts.append(capsules_from_polylines(
            pts, keep & valid[:, None], camera, preset.trail_radius,
            np.asarray(preset.trail_color, np.float32)))
        per_point.append(pts.shape[1] - 1)
    soup = ScreenPrimitives.concatenate(parts)
    if not return_layout:
        return soup
    layout = []
    for part, c in zip(parts, per_point):
        if isinstance(c, tuple):  # ("split2", faces per point)
            layout += [(part.count // 2, c[1])] * 2
        else:
            layout.append((part.count, c))
    return soup, layout


def frame_camera(preset: ScenePreset, frame_index: int, width: int,
                 height: int, device) -> Camera:
    """The preset's camera at a frame (the float32 origin schedule)."""
    origin = camera_origin_torch(preset.camera_preset, frame_index,
                                 preset.total_frames, device=device)
    target = const(TARGETS[preset.camera_preset], np.float32, device)
    return Camera(origin=origin, target=target,
                  fov_x_degrees=preset.fov_x_degrees, width=width,
                  height=height)


class FramePipeline:
    """Stateful host-side orchestrator for one preset on one device."""

    def __init__(self, preset: ScenePreset,
                 raster_config: Optional[RasterConfig] = None,
                 droplet_lod: str = "capsule", width: Optional[int] = None,
                 height: Optional[int] = None, device="cuda"):
        self.preset = preset
        self.raster_config = raster_config or RasterConfig()
        check_config(self.raster_config)
        if preset.splat == "droplet":
            check_droplet_lod(droplet_lod)
        self.droplet_lod = droplet_lod
        check_mode(self.raster_config.shading)
        self.film = (width or IMAGE_WIDTH, height or IMAGE_HEIGHT)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")

    # -- state layer (host, reference-exact) -------------------------------
    def load_and_prepare(self, file_path: str) -> np.ndarray:
        """load -> (N, 3|6) -> standardize -> transform (reference order,
        traj_ball_renderer.py:369-374; 3-D stacks take frame 0)."""
        pcl = loaders.load_point_cloud(
            file_path, positions_only=self.preset.positions_only)
        if pcl.ndim == 3:
            pcl = pcl[0]
        return self._prepare(pcl)

    def _prepare(self, pcl):
        pcl = normalize.standardize_point_cloud(pcl)
        return normalize.transform_coordinates(pcl, flip_x=self.preset.flip_x)

    def load_stack(self, file_path: str) -> list:
        """All frames of a (possibly stacked) file, prepared: the example
        renderer iterates every frame of a 3-D stack
        (example_renderer.py:165-169)."""
        pcl = loaders.load_point_cloud(
            file_path, positions_only=self.preset.positions_only)
        if pcl.ndim == 2:
            pcl = pcl[None]
        return [self._prepare(f) for f in pcl]

    # -- device layer -------------------------------------------------------
    def render_array(self, pcl: np.ndarray, frame_index: int,
                     history: Optional[np.ndarray] = None) -> FrameBuffers:
        """Render a prepared (N, 3|6) array on ``self.device``; ``history``
        is the (H, N, 3|6) prior frames of a history-trail preset, oldest
        first, or None.

        The frame's certificate is read back every frame: on big-list
        overflow the big list grows and the frame renders again; binned
        entries past a finite ``entry_capacity`` raise.  The config goes
        through :func:`scene_config` first (mesh-LOD droplets under
        ``auto`` bin their triangles).  Droplets of a history preset
        without velocities take the reference's seeded random rotations
        (traj_renderer.py:566-568, a host loop over the points).

        The look branch (the JAX package's ``_make_step``): with
        ``supersample`` ss the camera's film is ss times the frame's; with
        a look pass on (``shadows``, ``ground_spec``, ``gi``) the camera
        raster runs the configured backend and its certificate with the
        look passes off, and the frame is re-shaded through
        ``shade_framebuffer``, with ``shadows`` under the factor of a
        shadow map rasterized from the emitter (:meth:`_shadow_map`); with
        ss > 1 the rgb is filtered down (``shading/aa.downsample``) and
        depth and index keep every ss-th sample.
        """
        pcl = np.asarray(pcl, np.float32)
        has_vel = pcl.shape[1] == 6
        positions = torch.as_tensor(pcl[:, :3], device=self.device)
        velocities = (torch.as_tensor(pcl[:, 3:6], device=self.device)
                      if has_vel else None)
        rotations = None
        if (self.preset.splat == "droplet" and not has_vel
                and self.preset.trail == "history"):
            rotations = torch.as_tensor(np.stack([
                rotation_mod.random_rotation_matrix(i, pcl[i, :3])
                for i in range(pcl.shape[0])]).reshape(-1, 4, 4)
                .astype(np.float32), device=self.device)
        if (self.preset.trail == "history" and history is not None
                and len(history) > 0):
            history = torch.as_tensor(
                np.asarray(history, np.float32)[:, :, :3], device=self.device)
        else:
            history = None
        scene = (positions, velocities, frame_index, history, rotations)
        w, h = self.film
        ss = self.raster_config.supersample
        camera = frame_camera(self.preset, frame_index, w * ss, h * ss,
                              self.device)
        prims = build_primitives(self.preset, camera, *scene[:4],
                                 rotations=rotations,
                                 droplet_lod=self.droplet_lod)
        fb = self._render_certified(prims, camera, frame_index)
        shading = self.raster_config.shading
        if has_look(shading):
            sf = (self._shadow_map(camera, fb, *scene) if shading.shadows
                  else None)
            fb = FrameBuffers(rgb=shade_framebuffer(
                prims, camera, fb.depth, fb.index, shading, shadow=sf),
                depth=fb.depth, index=fb.index)
        if ss != 1:
            fb = FrameBuffers(rgb=aa.downsample(fb.rgb, ss),
                              depth=fb.depth[::ss, ::ss],
                              index=fb.index[::ss, ::ss])
        return fb

    def _shadow_map(self, camera, fb: FrameBuffers, positions, velocities,
                   frame_index, history, rotations) -> torch.Tensor:
        """The (H, W) shadow factor of a camera frame ``fb``: the soup
        rebuilt from ``shadow.light_camera(size=shadow_size)`` with the
        same points, velocities, history and rotations, its capped tiled
        z-buffer (``shadow.render_shadow_depth``: ``csr1_raster`` on the
        card) and ``shadow.shadow_factor`` with the config's knobs."""
        shading = self.raster_config.shading
        light_cam = shadow.light_camera(size=shading.shadow_size,
                                        device=self.device)
        prims_light = build_primitives(
            self.preset, light_cam, positions, velocities, frame_index,
            history, rotations=rotations, droplet_lod=self.droplet_lod)
        sdepth = shadow.render_shadow_depth(prims_light, light_cam)
        return shadow.shadow_factor(
            camera, fb.depth, fb.index, light_cam, sdepth,
            bias=shading.shadow_bias, min_light=shading.shadow_min_light,
            taps=shading.shadow_taps,
            emitter_half=shading.shadow_emitter_half,
            max_radius_px=shading.shadow_max_radius_px)

    def _render_certified(self, prims, camera, frame_index) -> FrameBuffers:
        """``render`` with the certificate read back: the big list grows
        and the frame renders again on overflow (at most
        MAX_RENDER_ATTEMPTS times); binned entries past a finite
        ``entry_capacity`` raise.  The look passes are off here (the
        caller re-shades)."""
        for _attempt in range(MAX_RENDER_ATTEMPTS):
            config = scene_config(self.preset, self.raster_config,
                                  self.droplet_lod)
            config = dataclasses.replace(
                config, shading=without_look(config.shading))
            fb, diag = render(prims, camera, config, return_diag=True)
            ovf = int(diag["big_overflow"])
            if ovf == 0:
                self._check_capacity(int(diag["true_entries"]), frame_index)
                return fb
            new = max(self.raster_config.max_big * 4,
                      self.raster_config.max_big + ovf)
            self.raster_config = dataclasses.replace(self.raster_config,
                                                     max_big=new)
            print(f"Frame {frame_index}: overflow ({ovf} primitives); "
                  f"retrying with max_big -> {new}")
        raise RuntimeError(
            f"overflow ({ovf} primitives) at frame {frame_index} after "
            f"capacity retries — the render dropped them. Reduce primitive "
            f"screen extents, or span=4 (pallas6) if the overflow is long "
            f"trail segments.")

    def _check_capacity(self, true_entries: int, frame_index) -> None:
        cap = self.raster_config.entry_capacity
        if cap is not None and true_entries > cap:
            raise RuntimeError(
                f"entry capacity violated at frame {frame_index}: "
                f"true_entry_count {true_entries} > capacity {cap}.")

    # -- full frame ----------------------------------------------------------
    def process(self, file_path: str, frame_index: int = 0,
                output_folder: Optional[str] = None,
                write_depth: bool = False,
                history: Optional[np.ndarray] = None) -> str:
        """The reference's process(): load, render, save; returns the
        written PNG path.  ``history`` as in :meth:`render_array`.  For
        ``iterate_stack`` presets every frame of a 3-D stack renders in
        turn to the same output name, as in the reference
        (example_renderer.py:165-199: the last frame's PNG survives)."""
        if self.preset.iterate_stack:
            for pcl in self.load_stack(file_path):
                fb = self.render_array(pcl, frame_index, history)
        else:
            fb = self.render_array(self.load_and_prepare(file_path),
                                   frame_index, history)
        return self.save_outputs(
            fb, file_path, frame_index,
            output_folder or self.preset.output_folder, write_depth)

    def save_outputs(self, fb: FrameBuffers, file_path: str,
                     frame_index: int, folder: str,
                     write_depth: bool = False) -> str:
        """Write the frame's PNG (+ optional depth dump) under the
        reference naming contract (preset.output_name: frame_{idx:04d}_b0
        past 199, else the input stem).  The one place that computes
        output names — run_batch's manifest resume matches by it."""
        stem = os.path.splitext(os.path.basename(file_path))[0]
        name = self.preset.output_name(frame_index, stem)
        os.makedirs(folder, exist_ok=True)
        out_path = os.path.join(folder, f"{name}.png")
        png.write_png(out_path, fb.rgb.cpu().numpy())
        if write_depth:
            np.save(os.path.join(folder, f"{name}_depth.npy"),
                    fb.depth.cpu().numpy())
        return out_path
