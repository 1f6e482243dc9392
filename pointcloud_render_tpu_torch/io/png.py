"""PNG output.

The reference writes frames through ``mi.util.write_bitmap(path.png)``
(reference: traj_ball_renderer.py:361-363).  Here frames are float RGB in
[0, 1]; they are gamma-encoded (sRGB) and written as 8-bit RGB PNG through
the native encoder (``io/native.py``) where its library loads, else PIL
when it is installed, else a pure-Python zlib encoder, as
``pointcloud_render_tpu.io.png`` writes them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from pointcloud_render_tpu_torch.io import native


def to_srgb_u8(image: np.ndarray) -> np.ndarray:
    """Linear float RGB [0,1] -> sRGB-encoded uint8 (Mitsuba-style output)."""
    img = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    srgb = np.where(img <= 0.0031308, img * 12.92,
                    1.055 * np.power(img, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image: np.ndarray, srgb: bool = True) -> None:
    """Write an (H, W, 3) image. Float inputs are treated as linear RGB."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = to_srgb_u8(image) if srgb else (
            np.clip(image, 0, 1) * 255 + 0.5).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    if native.available() and native.write_png(path, image):
        return
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError:
        _write_png_pure(path, image)
        return
    Image.fromarray(image, mode="RGB").save(path)


def _write_png_pure(path: str, image: np.ndarray) -> None:
    h, w, _ = image.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
