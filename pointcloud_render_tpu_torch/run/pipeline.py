"""The per-frame pipeline: load -> standardize -> transform -> render -> save.

The PyTorch twin of ``pointcloud_render_tpu.run.pipeline``.  The host side
keeps the reference's exact state semantics (float64 NumPy standardize and
transform); the device side is float32 on ``FramePipeline.device``.
PyTorch runs eagerly, so there is no compiled-step cache.

Ported: the sphere splats, the droplets' capsule LOD (head disc and
tapered tail capsule, velocity-aligned) and the fixed-segment velocity
trails (the traj_ball and traj_vel frames, the other sphere + velocity
presets and the example preset's static cloud, whose 3-D stacks
``process`` iterates).  The droplets' mesh LOD, history trails and the
adaptive trail segmentation raise ``NotImplementedError`` naming their
ROADMAP entry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.configs import ScenePreset
from pointcloud_render_tpu_torch.geometry import droplet as droplet_mod
from pointcloud_render_tpu_torch.geometry import rotation as rotation_mod
from pointcloud_render_tpu_torch.geometry import trails as trails_mod
from pointcloud_render_tpu_torch.io import loaders, png
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    capsules_from_vertex_columns,
    discs_from_points,
)
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
from pointcloud_render_tpu_torch.shading.shade import check_supported
from pointcloud_render_tpu_torch.utils.consts import const

# Straight velocity trails render as this many collinear capsules (the
# reference's 20-segment union, subsampled; see the JAX pipeline).
VEL_TRAIL_RENDER_SEGMENTS = 8
# How many times a frame whose big list overflowed is re-rendered with a
# larger list before the pipeline gives up.
MAX_RENDER_ATTEMPTS = 5


def check_droplet_lod(droplet_lod: str) -> None:
    """Raise for a droplet LOD the port does not render."""
    if droplet_lod == "mesh":
        raise NotImplementedError(
            "mesh-LOD droplets are not ported yet: they need the binned "
            "triangle walk, ROADMAP queue A item 12 and queue B item 7")
    if droplet_lod != "capsule":
        raise ValueError(f"unknown droplet_lod {droplet_lod!r}")


def build_primitives(preset: ScenePreset, camera: Camera, positions,
                     velocities=None, frame_index=0, rotations=None,
                     droplet_lod: str = "capsule",
                     trail_segments: Optional[int] = None,
                     return_layout: bool = False):
    """Assemble the frame's primitive soup on the camera's device.

    Primitive order (= depth-tie priority): ground, splats (droplets: head
    discs, then tail capsules), trails.  Droplets take their orientation
    from ``rotations`` ((N, 4, 4)), else from the velocities, else the
    identity.  ``trail_segments`` overrides VEL_TRAIL_RENDER_SEGMENTS
    (1..20).  ``return_layout=True`` also returns the soup's part layout
    as a list of ``(rows, rows_per_point)`` (0 for fixed furniture like
    the ground); every per-point part is row-major in point index.
    """
    if preset.trail == "history":
        raise NotImplementedError(
            "history trails are not ported yet: ROADMAP queue A item 11")
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
        # Capsule LOD: head sphere + tapering tail along the rotated -z
        # axis (column 2 of R gives R @ (0,0,-1) = tail direction).
        tail_dir = -rotations[:, :3, 2]
        tip = positions + tail_dir * droplet_mod.TAIL_TIP_OFFSET
        parts.append(discs_from_points(
            positions, camera,
            torch.full((n,), droplet_mod.BASE_RADIUS, dtype=torch.float32,
                       device=dev), color))
        per_point.append(1)
        taper = const(droplet_mod.TAIL_RADII, np.float32, dev).expand(n, 2)
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
            raise NotImplementedError(
                "adaptive trail segments are not part of the port: ROADMAP "
                "queue A, 'Not to port'")
        if not 1 <= segs <= trails_mod.N_TRAIL_POINTS:
            raise ValueError(
                f"trail_segments must be in 1..{trails_mod.N_TRAIL_POINTS}")
        sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS,
                                   segs + 1)).astype(np.int32)
        vcols, valid = trails_mod.velocity_trail_vertex_columns(
            positions, velocities, frame_index, sub, preset.trail_schedule)
        parts.append(capsules_from_vertex_columns(
            vcols, [valid] * len(vcols), camera, preset.trail_radius,
            np.asarray(preset.trail_color, np.float32)))
        per_point.append(len(vcols) - 1)
    soup = ScreenPrimitives.concatenate(parts)
    if not return_layout:
        return soup
    return soup, [(part.count, c) for part, c in zip(parts, per_point)]


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
        check_supported(self.raster_config.shading)
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
    def render_array(self, pcl: np.ndarray, frame_index: int) -> FrameBuffers:
        """Render a prepared (N, 3|6) array on ``self.device``.

        The frame's big-list overflow certificate is read back every frame;
        on overflow the big list grows and the frame renders again.
        """
        pcl = np.asarray(pcl, np.float32)
        has_vel = pcl.shape[1] == 6
        positions = torch.as_tensor(pcl[:, :3], device=self.device)
        velocities = (torch.as_tensor(pcl[:, 3:6], device=self.device)
                      if has_vel else None)
        w, h = self.film
        camera = frame_camera(self.preset, frame_index, w, h, self.device)
        prims = build_primitives(self.preset, camera, positions, velocities,
                                 frame_index, droplet_lod=self.droplet_lod)
        for _attempt in range(MAX_RENDER_ATTEMPTS):
            fb, diag = render(prims, camera, self.raster_config,
                              return_diag=True)
            ovf = int(diag["big_overflow"])
            if ovf == 0:
                return fb
            new = max(self.raster_config.max_big * 4,
                      self.raster_config.max_big + ovf)
            self.raster_config = dataclasses.replace(self.raster_config,
                                                     max_big=new)
            print(f"Frame {frame_index}: overflow ({ovf} primitives); "
                  f"retrying with max_big -> {new}")
        raise RuntimeError(
            f"overflow ({ovf} primitives) at frame {frame_index} after "
            f"capacity retries — the render dropped them.  Reduce "
            f"primitive screen extents.")

    # -- full frame ----------------------------------------------------------
    def process(self, file_path: str, frame_index: int = 0,
                output_folder: Optional[str] = None,
                write_depth: bool = False) -> str:
        """The reference's process(): load, render, save; returns the
        written PNG path.  For ``iterate_stack`` presets every frame of a
        3-D stack renders in turn to the same output name, as in the
        reference (example_renderer.py:165-199: the last frame's PNG
        survives)."""
        if self.preset.iterate_stack:
            for pcl in self.load_stack(file_path):
                fb = self.render_array(pcl, frame_index)
        else:
            fb = self.render_array(self.load_and_prepare(file_path),
                                   frame_index)
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
