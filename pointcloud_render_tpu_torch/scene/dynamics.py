"""Dynamic clouds: velocity advection and motion coloring on the device
(PyTorch twin of ``pointcloud_render_tpu.scene.dynamics``).

The reference realizes dynamics by loading a different file per frame
(traj_ball_renderer.py:434-439); here a dynamic cloud can also be stepped
on the device, positions advected by their velocities inside the frame
loop of ``run/trajectory.py``, with optional motion coloring.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_render_tpu_torch.utils.consts import const
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn


def advect(positions: torch.Tensor, velocities: torch.Tensor, dt: float):
    """Forward-Euler advection: p + v * float32(dt) (the reference's
    implicit model: frame files are snapshots of particles moving along
    their velocity)."""
    return positions + velocities * float(np.float32(dt))


def motion_colors(velocities: torch.Tensor, v_max: float = 10.0,
                  slow=(0.2, 0.4, 1.0), fast=(1.0, 0.3, 0.1)):
    """Speed-mapped colors: lerp slow -> fast on |v| / v_max (clamped).

    v_max defaults to the reference's velocity normalizer
    (traj_ball_renderer.py:134: min(|v| / 10, 1)).
    """
    v = velocities.to(torch.float32)
    dev = v.device
    speed = sqrt_rn(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    scale = const(v_max, np.float32, dev)
    t = torch.clamp(speed / scale, 0.0, 1.0)[:, None]
    lo = np.asarray(slow, np.float32)
    hi = np.asarray(fast, np.float32)
    return const(lo, np.float32, dev) + const(hi - lo, np.float32, dev) * t
