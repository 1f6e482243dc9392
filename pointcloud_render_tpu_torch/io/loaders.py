"""Point-cloud loading with the reference's format/velocity detection.

Dispatch mirrors reference behavior exactly (traj_ball_renderer.py:223-279):

* ``.npy``  — raw array, returned as-is (may be (N,3), (N,6) or a (F,N,C)
  frame stack);
* ``.npz``  — the ``'pred'`` payload key (reference: traj_ball_renderer.py:234);
* ``.ply``  — x/y/z plus, in priority order, velocity columns (vx,vy,vz)
  or normal columns (nx,ny,nz) used as velocity (reference:
  traj_ball_renderer.py:253-273; the normals are used as-is, NOT negated);
* anything else raises ValueError (reference: traj_ball_renderer.py:279).

The twin of ``pointcloud_render_tpu.io.loaders``: PLY files go through
the native reader (``io/native.py``) where the library loads, else (and
where it rejects a file) through the NumPy parser.
"""

from __future__ import annotations

import os

import numpy as np

from pointcloud_render_tpu_torch.io import native
from pointcloud_render_tpu_torch.io import ply as plyio

NPZ_PAYLOAD_KEY = "pred"


def load_point_cloud(file_path: str, positions_only: bool = False) -> np.ndarray:
    """Load a cloud as the raw (N, 3|6) / stacked (F, N, C) array layout.

    Args:
      file_path: path ending in .npy/.npz/.ply.
      positions_only: drop velocity/normal channels even when present
        (example_renderer semantics, reference: example_renderer.py:101-111).
    """
    ext = os.path.splitext(file_path)[1]
    if ext == ".npy":
        data = np.load(file_path, allow_pickle=True)
    elif ext == ".npz":
        data = np.load(file_path)[NPZ_PAYLOAD_KEY]
    elif ext == ".ply":
        data = _load_ply(file_path, positions_only=positions_only)
    else:
        raise ValueError("Unsupported file format.")
    if positions_only and data.ndim >= 2 and data.shape[-1] >= 3:
        return data[..., :3]
    return data


def _load_ply(file_path: str, positions_only: bool = False) -> np.ndarray:
    reader = _native_ply_reader()
    if reader is not None:
        try:
            return reader(file_path, positions_only)
        except OSError:
            pass  # the NumPy parser below reads or rejects it
    vertex = plyio.read_ply(file_path)["vertex"]
    base = [vertex["x"], vertex["y"], vertex["z"]]
    if not positions_only:
        if all(k in vertex for k in ("vx", "vy", "vz")):
            return np.column_stack(base + [vertex["vx"], vertex["vy"], vertex["vz"]])
        if all(k in vertex for k in ("nx", "ny", "nz")):
            return np.column_stack(base + [vertex["nx"], vertex["ny"], vertex["nz"]])
    return np.column_stack(base)


def _native_ply_reader():
    """``native.read_ply_array`` where the library loads, else None."""
    return native.read_ply_array if native.available() else None
