"""ctypes binding to the repository's native IO library (the port's copy
of ``pointcloud_render_tpu.io.native``).

``native/libpcr_native.so`` (``make -C native``, source
``native/pcr_native.cc``) parses binary and ASCII PLY files and encodes
PNGs on the host.  ``available()`` is False where the library is missing
or does not load; the callers then take their NumPy and Python paths.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

LIBRARY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libpcr_native.so")


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its signatures declared, or None."""
    if not os.path.exists(LIBRARY):
        return None
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError:
        return None
    lib.pcr_read_ply.restype = ctypes.c_longlong
    lib.pcr_read_ply.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_longlong,
                                 ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.pcr_ply_vertex_count.restype = ctypes.c_longlong
    lib.pcr_ply_vertex_count.argtypes = [ctypes.c_char_p]
    lib.pcr_write_png.restype = ctypes.c_int
    lib.pcr_write_png.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_ubyte),
                                  ctypes.c_int, ctypes.c_int]
    return lib


def available() -> bool:
    return _lib() is not None


def _need():
    lib = _lib()
    if lib is None:
        raise OSError(f"the native IO library {LIBRARY} is not available")
    return lib


def read_ply_array(path: str, positions_only: bool = False) -> np.ndarray:
    """(N, 3) or (N, 6) float32 vertex array of a PLY file: x/y/z, then
    velocities or normals as the loaders pick them; raises OSError where
    the library rejects the file."""
    lib = _need()
    n = lib.pcr_ply_vertex_count(path.encode())
    if n < 0:
        raise OSError(f"native PLY parse failed for {path}")
    out = np.empty((n, 6), np.float32)
    ncols = ctypes.c_int(0)
    rc = lib.pcr_read_ply(path.encode(),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          n, ctypes.byref(ncols), 1 if positions_only else 0)
    if rc < 0:
        raise OSError(f"native PLY parse failed for {path} (rc={rc})")
    # The rows are packed at a stride of ncols from the start of ``out``.
    k = ncols.value
    return out.reshape(-1)[:n * k].reshape(n, k).copy()


def write_png(path: str, image_u8: np.ndarray) -> bool:
    """Encode an (H, W, 3) uint8 image to ``path``; True on success."""
    lib = _need()
    img = np.ascontiguousarray(image_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rc = lib.pcr_write_png(path.encode(),
                           img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                           w, h)
    return rc == 0
