"""Cameras and the reference trajectory presets (PyTorch twin).

The counterpart of ``pointcloud_render_tpu.scene.camera``.  The trajectory
functions exist in two forms, as there:

* ``camera_origin(preset, frame_index, total_frames)`` — exact host-side
  float64 replay (a copy of the JAX package's host function);
* ``camera_origin_torch`` — the float32 tensor twin of
  ``camera_origin_jax``, the form the frame pipeline evaluates.

Exactness: every float32 expression is written as separate elementwise
multiplies, adds, divisions and square roots in the JAX package's order —
no ``torch.linalg.norm``, ``torch.cross``, ``lerp`` or matmul, whose fused
kernels may contract a multiply-add into an FMA on the GPU — and no
division by a Python scalar, which PyTorch's CUDA kernel turns into a
multiply by the reciprocal.  The CPU and CUDA results are then bit-equal.

Projection model: perspective pinhole with the field of view along the
image x axis (Mitsuba's default fov_axis, reference:
traj_ball_renderer.py:19 ``fov = 36``), near/far clips 0.1/100, film
1920x1080 (reference: traj_ball_renderer.py:14-27).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from pointcloud_render_tpu_torch.utils.consts import as_f32
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

# --- fixed sensor constants of the reference ------------------------------
IMAGE_WIDTH = 1920  # reference: traj_ball_renderer.py:24
IMAGE_HEIGHT = 1080  # reference: traj_ball_renderer.py:25
NEAR_CLIP = 0.1  # reference: traj_ball_renderer.py:15
FAR_CLIP = 100.0  # reference: traj_ball_renderer.py:14
FOV_TRAJ = 36.0  # degrees, reference: traj_ball_renderer.py:19
FOV_EXAMPLE = 30.0  # degrees, reference: example_renderer.py:22
UP = (0.0, 0.0, 1.0)  # reference: traj_ball_renderer.py:17

# Look-at targets per preset (reference: traj_ball_renderer.py:17,
# traj_b0.py:19, traj_b1.py:19, example_renderer.py:20).
TARGETS = {
    "example": (0.0, 0.0, 0.0),
    "traj": (0.0, 0.0, -0.05),
    "traj_ball": (0.0, 0.0, -0.05),
    "traj_vel": (0.0, 0.0, -0.05),
    "traj_b0": (-0.02, 0.15, -0.05),
    "traj_b1": (0.0, -0.02, 0.0),
    "traj_original": (0.0, 0.0, -0.05),
}

LAST_MOTION_FRAME = 199  # reference: traj_ball_renderer.py:287
FADE_FRAMES = 20  # reference: traj_ball_renderer.py:288
TOTAL_FRAMES = 220  # reference: traj_ball_renderer.py:428

# Two-phase waypoint tables: (start, mid, final). Phase 1 runs frames
# 0..199 start->mid with progress f/199, phase 2 runs frames 200..219
# mid->final with progress (f-199)/20.
_WAYPOINTS = {
    # reference: traj_ball_renderer.py:290-305 (same fn in traj_vel_renderer)
    "traj_ball": ((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6)),
    "traj_vel": ((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6)),
    # reference: traj_b0.py:94-115
    "traj_b0": ((-2.2, -3.3, 2.0), (-1.3, -2.5, 0.8), (-1.0, -2.0, 0.7)),
    # reference: traj_b1.py:94-100
    "traj_b1": ((-3.5, -2.5, 2.8), (-2.3, -1.5, 1.2), (-2.0, -1.2, 1.0)),
}


def camera_origin(
    preset: str, frame_index: int, total_frames: int = TOTAL_FRAMES
) -> Tuple[float, float, float]:
    """Exact replay of the reference camera-origin schedules."""
    if preset == "example":
        # Static pose baked into the XML head (reference: example_renderer.py:20).
        return (2.2, 2.2, 4.2)
    if preset == "traj":
        # Linear dolly over the whole run (reference: traj_renderer.py:519-527).
        progress = frame_index / max(total_frames - 1, 1)
        return (2.8 - 2.0 * progress, 2.8 - 2.0 * progress, 3.0 - 2.0 * progress)
    if preset == "traj_original":
        # Constant frame-199 pose (reference: traj_original.py:62-66).
        return (-1.8, -1.8, 1.8)
    start, mid, final = _WAYPOINTS[preset]
    if frame_index <= LAST_MOTION_FRAME:
        p = frame_index / max(LAST_MOTION_FRAME, 1)
        a, b = start, mid
    else:
        p = (frame_index - LAST_MOTION_FRAME) / max(FADE_FRAMES, 1)
        a, b = mid, final
    return tuple(a[i] + (b[i] - a[i]) * p for i in range(3))


def camera_origin_torch(preset: str, frame_index, total_frames: int = TOTAL_FRAMES,
                        device=None) -> torch.Tensor:
    """(3,) float32 twin of ``camera_origin_jax``: the same f32 expression
    (progress = f / divisor, then start + (mid - start) * progress)."""
    f = as_f32(frame_index, device)
    if preset == "example":
        return as_f32([2.2, 2.2, 4.2], device)
    if preset == "traj":
        p = f / as_f32(max(total_frames - 1, 1), device)
        return as_f32([2.8, 2.8, 3.0], device) - 2.0 * p
    if preset == "traj_original":
        return as_f32([-1.8, -1.8, 1.8], device)
    start, mid, final = (np.array(w, np.float32) for w in _WAYPOINTS[preset])
    p1 = f / as_f32(LAST_MOTION_FRAME, device)
    p2 = (f - LAST_MOTION_FRAME) / as_f32(FADE_FRAMES, device)
    phase1 = as_f32(start, device) + as_f32(mid - start, device) * p1
    phase2 = as_f32(mid, device) + as_f32(final - mid, device) * p2
    return torch.where(f <= LAST_MOTION_FRAME, phase1, phase2)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # jnp.cross's expression order.
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def look_at_axes(origin, target, up=UP, device=None):
    """Orthonormal camera frame: right / up / forward (float32 tensors).

    forward points from origin toward target; right = forward x up;
    camera-up = right x forward (the JAX package's convention).
    """
    if isinstance(origin, torch.Tensor):
        device = origin.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    up = as_f32(up, device)
    forward = target - origin
    forward = forward / _norm3(forward)
    right = _cross3(forward, up)
    right = right / _norm3(right)
    cam_up = _cross3(right, forward)
    return right, cam_up, forward


@dataclasses.dataclass(frozen=True)
class Camera:
    """A posed perspective camera; ``origin``/``target`` are (3,) float32
    tensors on the device the frame renders on."""

    origin: torch.Tensor
    target: torch.Tensor
    up: Optional[tuple] = UP
    fov_x_degrees: float = FOV_TRAJ
    width: int = IMAGE_WIDTH
    height: int = IMAGE_HEIGHT
    near: float = NEAR_CLIP
    far: float = FAR_CLIP

    @property
    def device(self) -> torch.device:
        return torch.as_tensor(self.origin).device

    @property
    def tan_half_fov_x(self) -> float:
        return math.tan(math.radians(self.fov_x_degrees) * 0.5)

    def world_to_camera_matrix(self) -> torch.Tensor:
        """(3, 4) float32 matrix mapping world points to camera space
        (+x image-right, +y image-up, +z depth); the translation uses
        explicit multiply-adds, as in the JAX package.  Computed once per
        camera (the pose never changes) and not to be written into."""
        cached = self.__dict__.get("_w2c")
        if cached is not None:
            return cached
        dev = self.device
        right, cam_up, forward = look_at_axes(self.origin, self.target,
                                              self.up, device=dev)
        rot = torch.stack([right, cam_up, forward])
        o = torch.as_tensor(self.origin, dtype=torch.float32, device=dev)
        trans = -(rot[:, 0] * o[0] + rot[:, 1] * o[1] + rot[:, 2] * o[2])
        w2c = torch.cat([rot, trans[:, None]], dim=1)
        self.__dict__["_w2c"] = w2c
        return w2c

    @staticmethod
    def from_preset(preset: str, frame_index: int = 0,
                    total_frames: int = TOTAL_FRAMES,
                    device="cuda") -> "Camera":
        """The preset's camera at a frame on ``device``: the exact host
        origin schedule rounded to float32, the preset's target, and the
        field of view of the example or trajectory presets."""
        origin = torch.tensor(camera_origin(preset, frame_index,
                                            total_frames),
                              dtype=torch.float32, device=device)
        target = torch.tensor(TARGETS[preset], dtype=torch.float32,
                              device=device)
        fov = FOV_EXAMPLE if preset == "example" else FOV_TRAJ
        return Camera(origin=origin, target=target, fov_x_degrees=fov)
