"""Velocity-aligned droplet orientation (Rodrigues) — the PyTorch twin of
``pointcloud_render_tpu.geometry.rotation``.

The reference orients each droplet so its default -z tip axis points along
the (unit) velocity, via an explicit axis-angle/Rodrigues construction with
three edge cases: near-zero velocity -> identity; parallel -> identity;
antiparallel -> pi rotation about a perpendicular axis
(reference: traj_renderer.py:159-202).

``rotation_from_velocity`` and ``random_rotation_matrix`` replay that
float64 scalar math on the host (NumPy, bit-equal to the JAX package's);
``rotation_matrices_from_velocities`` is the branchless float32 batch on
the positions' device, in the JAX expression order with explicit
component sums, ``sqrt_rn`` norms and no matmul.  ``arccos``, ``cos`` and
``sin`` are correctly rounded neither in PyTorch nor in XLA, so its
matrices agree with the JAX package's to a few ulp (ROADMAP queue C).
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_render_tpu_torch.utils.consts import const
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

VELOCITY_EPS = 1e-6  # reference: traj_renderer.py:165
AXIS_EPS = 1e-8  # reference: traj_renderer.py:177
DEFAULT_TIP_AXIS = (0.0, 0.0, -1.0)  # droplet rest orientation, traj_renderer.py:171


def rotation_from_velocity(velocity, translation) -> np.ndarray:
    """Exact host-side replay; returns the flattened 4x4 row-major matrix."""
    velocity = np.array(velocity, dtype=np.float64)
    vel_norm = np.linalg.norm(velocity)
    if vel_norm < VELOCITY_EPS:
        matrix = np.eye(4, dtype=np.float64)
        matrix[:3, 3] = translation
        return matrix.flatten()

    target = velocity / vel_norm
    default = np.array(DEFAULT_TIP_AXIS, dtype=np.float64)
    dot = np.clip(np.dot(default, target), -1.0, 1.0)
    axis = np.cross(default, target)
    axis_norm = np.linalg.norm(axis)

    if axis_norm < AXIS_EPS:
        if dot > 0.999:
            matrix = np.eye(4, dtype=np.float64)
            matrix[:3, 3] = translation
            return matrix.flatten()
        # Antiparallel: rotate pi about any perpendicular axis.
        helper = (np.array([1.0, 0.0, 0.0]) if abs(target[0]) < 0.9
                  else np.array([0.0, 1.0, 0.0]))
        axis = np.cross(target, helper)
        axis_norm = np.linalg.norm(axis)
        axis = axis / axis_norm if axis_norm > AXIS_EPS else np.array([0.0, 1.0, 0.0])
        angle = np.pi
    else:
        axis = axis / axis_norm
        angle = np.arccos(dot)

    cos_a, sin_a = np.cos(angle), np.sin(angle)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], dtype=np.float64)
    rot = np.eye(3) + sin_a * k + (1 - cos_a) * (k @ k)
    matrix = np.eye(4, dtype=np.float64)
    matrix[:3, :3] = rot
    matrix[:3, 3] = translation
    return matrix.flatten()


def _cross(a, b):
    """Row-wise a x b in ``jnp.cross``'s expression order."""
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=1)


def _norm(x):
    """Row-wise Euclidean norm, components summed in order."""
    return sqrt_rn(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2])


def rotation_matrices_from_velocities(velocities, positions) -> torch.Tensor:
    """Branchless batch version: (N,3),(N,3) -> (N,4,4) float32 on the
    positions' device (a tensor's, or the CPU for host arrays).

    All three reference branches are evaluated and selected with where():
    no data-dependent control flow."""
    dev = positions.device if isinstance(positions, torch.Tensor) else None
    t = torch.as_tensor(positions, dtype=torch.float32, device=dev)
    dev = t.device
    v = torch.as_tensor(velocities, dtype=torch.float32, device=dev)
    n = v.shape[0]
    one = const(1.0, np.float32, dev)

    vel_norm = _norm(v)
    safe_norm = torch.where(vel_norm < VELOCITY_EPS, one, vel_norm)
    target = v / safe_norm[:, None]

    default = const(DEFAULT_TIP_AXIS, np.float32, dev)
    dot = torch.clamp(target[:, 0] * default[0] + target[:, 1] * default[1]
                      + target[:, 2] * default[2], -1.0, 1.0)
    axis = _cross(default.expand(n, 3), target)
    axis_norm = _norm(axis)

    # Antiparallel fallback axis (reference: traj_renderer.py:183-188).
    helper = torch.where((torch.abs(target[:, 0]) < 0.9)[:, None],
                         const((1.0, 0.0, 0.0), np.float32, dev),
                         const((0.0, 1.0, 0.0), np.float32, dev))
    anti_axis = _cross(target, helper)
    anti_norm = _norm(anti_axis)
    anti_ok = anti_norm > AXIS_EPS
    anti_axis = torch.where(
        anti_ok[:, None],
        anti_axis / torch.where(anti_ok, anti_norm, one)[:, None],
        const((0.0, 1.0, 0.0), np.float32, dev))

    degenerate = axis_norm < AXIS_EPS
    unit_axis = torch.where(
        degenerate[:, None], anti_axis,
        axis / torch.where(degenerate, one, axis_norm)[:, None])
    angle = torch.where(degenerate, const(np.pi, np.float32, dev),
                        torch.arccos(dot))

    cos_a = torch.cos(angle)
    sin_a = torch.sin(angle)
    ax, ay, az = unit_axis[:, 0], unit_axis[:, 1], unit_axis[:, 2]
    zeros = torch.zeros_like(ax)
    k = torch.stack([
        torch.stack([zeros, -az, ay], dim=-1),
        torch.stack([az, zeros, -ax], dim=-1),
        torch.stack([-ay, ax, zeros], dim=-1),
    ], dim=-2)  # (N, 3, 3)
    eye = const(np.eye(3), np.float32, dev)
    # For a unit axis a, K@K == a a^T - I (an outer product, no matmul).
    kk = unit_axis[:, :, None] * unit_axis[:, None, :] - eye
    rot = eye + sin_a[:, None, None] * k + (1 - cos_a)[:, None, None] * kk

    # Identity when the velocity is negligible or already aligned.
    is_identity = (vel_norm < VELOCITY_EPS) | (degenerate & (dot > 0.999))
    rot = torch.where(is_identity[:, None, None], eye, rot)

    mats = torch.zeros((n, 4, 4), dtype=torch.float32, device=dev)
    mats[:, :3, :3] = rot
    mats[:, :3, 3] = t
    mats[:, 3, 3] = 1.0
    return mats


def random_rotation_matrix(seed: int, translation) -> np.ndarray:
    """Seeded random rotation fallback when no velocity exists.

    Replays reference: traj_renderer.py:398-418 exactly (NumPy legacy RNG
    seeded per point index), so position-only droplet scenes reproduce.
    """
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis = axis / np.linalg.norm(axis)
    angle = rng.uniform(0, 2 * np.pi)
    cos_a, sin_a = np.cos(angle), np.sin(angle)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + sin_a * k + (1 - cos_a) * (k @ k)
    matrix = np.eye(4)
    matrix[:3, :3] = rot
    matrix[:3, 3] = translation
    return matrix.flatten()
