"""Animation export: frame sequences -> GIF and PNG sequences (the twin
of ``pointcloud_render_tpu.run.video``).

The reference leaves its 220 PNGs for external assembly; ``write_gif``
writes an animated GIF straight from ``TrajectoryScanRenderer`` output (or
any list of (H, W, 3) uint8 frames) through Pillow.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from pointcloud_render_tpu_torch.io import png


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 30.0,
              loop: int = 0) -> str:
    from PIL import Image  # noqa: PLC0415

    if not frames:
        raise ValueError("no frames")
    imgs = [Image.fromarray(np.asarray(f), mode="RGB") for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 1), loop=loop)
    return path


def write_frame_sequence(folder: str, frames: Sequence[np.ndarray],
                         pattern: str = "frame_{:04d}.png") -> list:
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(folder, pattern.format(i))
        png.write_png(p, np.asarray(f), srgb=False)
        paths.append(p)
    return paths
