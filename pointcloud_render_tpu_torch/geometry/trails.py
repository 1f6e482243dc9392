"""Velocity-trail geometry (PyTorch twin of the velocity paths of
``pointcloud_render_tpu.geometry.trails``).

Three length-scale schedules exist across the reference scripts:

* ``"ball"``  — ramp f/19 for frames 0-19, then hold 1.0
  (reference: traj_ball_renderer.py:119-124);
* ``"vel"``   — ramp 0-19, hold 20-199, fade 1-(f-199)/20 for 200-219
  (reference: traj_vel_renderer.py:215-224);
* ``"fixed"`` — constant 1.0 (reference: traj_b0.py:127).

``velocity_trail_points`` is the exact host float64 replay of one trail
(the golden 21-point state layer); ``velocity_trails`` the batched float32
tensor build; ``velocity_trail_vertex_columns`` the production build that
computes only the vertices the renderer samples.  The float32 builds keep
the JAX expression order with explicit component sums (no
``torch.linalg.norm``) and tensor divisors, so CPU and CUDA agree bit for
bit (see ``scene/camera.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_render_tpu_torch.utils.consts import as_f32
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

VELOCITY_EPS = 1e-6  # reference: traj_ball_renderer.py:112
BASE_TRAIL_LENGTH = 0.07  # reference: traj_ball_renderer.py:132
MAX_TRAIL_LENGTH = 0.3  # reference: traj_ball_renderer.py:133
VEL_NORMALIZER = 10.0  # reference: traj_ball_renderer.py:134
N_TRAIL_POINTS = 20  # samples before the appended current position
LAST_MOTION_FRAME = 199
FADE_FRAMES = 20


def trail_length_scale(schedule: str, frame_index, device=None) -> torch.Tensor:
    """Length-scale factor for a frame as a float32 scalar tensor."""
    f = as_f32(frame_index, device)
    if schedule == "fixed":
        return torch.ones_like(f)
    ramp = f / as_f32(19.0, device)
    one = torch.ones_like(f)
    if schedule == "ball":
        return torch.where(f <= 19, ramp, one)
    if schedule == "vel":
        fade = 1.0 - (f - LAST_MOTION_FRAME) / as_f32(FADE_FRAMES, device)
        return torch.where(f <= 19, ramp,
                           torch.where(f <= LAST_MOTION_FRAME, one, fade))
    raise ValueError(f"unknown schedule {schedule!r}")


def velocity_trail_points(position, velocity, length_scale) -> np.ndarray:
    """Exact host-side single-point replay -> (21, 3) float64 polyline.

    Point i sits at position + (-v/|v|) * L * t_i with t_i = (19-i)/19,
    from the far end toward the position; the position itself is then
    appended (so the last two points coincide,
    reference: traj_ball_renderer.py:141-150).
    """
    velocity = np.array(velocity, dtype=np.float64)
    vel_norm = np.linalg.norm(velocity)
    vel_normalized = min(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * length_scale
    direction = -velocity / vel_norm
    ts = (N_TRAIL_POINTS - 1 - np.arange(N_TRAIL_POINTS)) / (N_TRAIL_POINTS - 1)
    pts = np.asarray(position)[None, :] + direction[None, :] * trail_length * ts[:, None]
    return np.concatenate([pts, np.asarray(position, np.float64)[None, :]], axis=0)


def _trail_terms(positions, velocities, frame_index, schedule):
    """Shared float32 terms: (p, direction, trail_length, valid)."""
    p = positions.to(torch.float32)
    v = velocities.to(torch.float32)
    dev = p.device
    scale = trail_length_scale(schedule, frame_index, device=dev)
    vel_norm = sqrt_rn(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                       + v[:, 2] * v[:, 2])
    valid = (vel_norm >= VELOCITY_EPS) & (scale > 0)
    vel_normalized = torch.minimum(vel_norm / as_f32(VEL_NORMALIZER, dev),
                                   torch.ones_like(vel_norm))
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * scale
    safe = torch.where(vel_norm < VELOCITY_EPS, torch.ones_like(vel_norm),
                       vel_norm)
    direction = -v / safe[:, None]
    return p, direction, trail_length, valid


def _ts_full() -> np.ndarray:
    return (N_TRAIL_POINTS - 1
            - np.arange(N_TRAIL_POINTS, dtype=np.float32)) / (N_TRAIL_POINTS - 1)


def velocity_trails(positions, velocities, frame_index, schedule: str = "ball"):
    """Batched trails for a whole cloud.

    Returns (points (N, 21, 3) float32, valid (N,) bool): velocity above
    epsilon, length scale > 0 and every vertex finite
    (reference: traj_ball_renderer.py:112,127).
    """
    p, direction, trail_length, valid = _trail_terms(
        positions, velocities, frame_index, schedule)
    ts = as_f32(_ts_full(), p.device)
    offsets = direction[:, None, :] * (trail_length[:, None] * ts[None, :])[..., None]
    pts = torch.cat([p[:, None, :] + offsets, p[:, None, :]], dim=1)
    valid = valid & torch.isfinite(pts.reshape(pts.shape[0], -1)).all(dim=1)
    return pts, valid


def velocity_trail_vertex_columns(positions, velocities, frame_index,
                                  indices, schedule: str = "ball"):
    """``velocity_trails`` evaluated only at vertex ``indices``, as packed
    (N, 3) columns: ``cols[j]`` is vertex ``indices[j]`` (index 20 is the
    position itself) and ``valid`` the (N,) trail mask over the sampled
    vertices (non-finite values can only come from non-finite inputs,
    which poison every vertex, so this equals the full build's mask)."""
    p, direction, trail_length, valid = _trail_terms(
        positions, velocities, frame_index, schedule)
    ts_full = _ts_full()
    cols = []
    for j in np.asarray(indices, np.int64):
        if j >= N_TRAIL_POINTS:
            pt = p
        else:
            pt = p + direction * (trail_length * np.float32(ts_full[j]))[:, None]
        cols.append(pt)
        valid = valid & torch.isfinite(pt).all(dim=1)
    return cols, valid
