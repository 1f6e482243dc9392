"""Minimal OBJ mesh IO (the PyTorch port's host copy of
``pointcloud_render_tpu.io.obj``).

The reference's only mesh is its generated droplet OBJ consumed by
Mitsuba (traj_renderer.py:44-53).  Supports v / f records; faces may be
polygons (fan-triangulated) and may carry the v/vt/vn slash syntax (only
the vertex index is used).
"""

from __future__ import annotations

import numpy as np


def read_obj(path):
    """Returns (vertices (V,3) float32, faces (F,3) int32, zero-based)."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    # OBJ is 1-based; negatives index from the end.
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"no triangle geometry in OBJ file {path!r}")
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32))


def write_obj(path, vertices, faces):
    """Writes 'v x y z' / 1-based 'f a b c' lines (reference droplet
    format, traj_renderer.py:147-151)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
