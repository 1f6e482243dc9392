"""PointCloud: the scene-state container, and the reference scene model's
default constants.

The counterpart of ``pointcloud_render_tpu.scene.pointcloud``.  The JAX
package's ``PointCloud`` is a registered pytree of device arrays; here it
is a plain frozen dataclass of tensors.  The entry points take (N, 3|6)
arrays and tensors as they are; ``PointCloud`` converts to and from the
reference's raw layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DEFAULT_POINT_COLOR = (0.3, 0.3, 0.3)  # reference: traj_ball_renderer.py:94-96
DEFAULT_SPHERE_RADIUS = 0.01  # reference: traj_ball_renderer.py:39 (sphere radius)
TRAIL_RADIUS = 0.0007  # reference: traj_ball_renderer.py:160
TRAIL_COLOR = (0.2, 1.0, 0.4)  # reference: traj_ball_renderer.py:179


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A batch of N points with optional per-point channels.

    Attributes:
      positions: (N, 3) float tensor, world-space positions.
      velocities: (N, 3) float tensor or None (PLY files without velocity
        fields give their normals, reference: traj_ball_renderer.py:253-273).
      colors: (N, 3) float tensor or None: the reference's constant gray.
      radii: (N,) float tensor or None: the reference's constant sphere
        radius 0.01.
    """

    positions: torch.Tensor
    velocities: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    radii: Optional[torch.Tensor] = None

    @property
    def num_points(self) -> int:
        return self.positions.shape[0]

    @property
    def has_velocity(self) -> bool:
        return self.velocities is not None

    def as_array(self) -> np.ndarray:
        """The reference's raw (N, 3|6) layout, on the host."""
        pos = self.positions.detach().cpu().numpy()
        if self.velocities is None:
            return pos
        return np.column_stack([pos, self.velocities.detach().cpu().numpy()])

    @staticmethod
    def from_array(data) -> "PointCloud":
        """From the reference's raw (N, 3) / (N, 6) array layout (host
        tensors of the array's dtype)."""
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] not in (3, 6):
            raise ValueError(f"expected (N,3) or (N,6) array, got {data.shape}")
        t = torch.as_tensor(data)
        if data.shape[1] == 6:
            return PointCloud(positions=t[:, :3], velocities=t[:, 3:6])
        return PointCloud(positions=t)
