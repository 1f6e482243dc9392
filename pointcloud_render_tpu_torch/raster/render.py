"""High-level render entry: primitive soup -> framebuffers -> shaded RGB.

The PyTorch twin of ``pointcloud_render_tpu.raster.render``.  Backends:

  "auto", "pallas6" — the v6 tile rasterizer (``raster/csr6.py``): the
                      CUDA kernels for CUDA tensors, their plain PyTorch
                      versions for CPU tensors;
  "pallas4"         — the v4 tile rasterizer (``raster/csr4.py``: 2x2
                      entry binning, the z-bucket early exit, a semantic
                      ``entry_capacity``), kernel or plain likewise;
  "pallas3"         — the v3 disc fast path (``raster/csr3.py``: 2x2 disc
                      binning with a stable sort, a strict-< merge on
                      entry index, the z-bucket early exit, the fused
                      8-float shade rows, a semantic ``entry_capacity``;
                      its fixed big list of 1024 holds every capsule and
                      triangle), kernel or plain likewise;
  "cpu", "tiled", "bruteforce" — the plain PyTorch version of the v6 walk
                      explicitly, on any device (the JAX package's exact
                      reference backends; one plain rasterizer serves all
                      three).
  "pallas"          — v2, not ported yet (ROADMAP queue B item 11):
                      NotImplementedError.

``RasterConfig`` keeps every field of the JAX package's so configs stay
compatible.  The TPU performance knobs (``tiles_per_program``,
``dma_slots``, ``chunk_rows``, ``unroll``, ``starts_method``, the
``*_carry`` build variants, ``chunk``, ``tile_h``/``tile_w``,
``max_per_tile``, ``max_tiles_per_prim``, ``row_budget``,
``no_triangles``) are accepted and have no effect here; ``entry_capacity``
drops entries under ``pallas4`` and ``pallas3`` and is checked against the
frame's ``true_entries`` by the pipelines;
``allow_exit`` only decides, as in the JAX package, whether a two-tone
disc scene may take the fused (u, v) shade (forced on, it may not).
``discs_only`` walks 8-float disc rows (capsules ride the big list) and
``uniform_look`` shades two-tone scenes from two constant colors.
``bin_triangles`` bins small triangles (the mesh-LOD droplets) into the
16-float walk of ``pallas6`` and ``pallas4``, as the JAX package does;
``pallas4`` shades generically, as ``render_shaded_csr4`` does.
``rows9`` and ``rows8`` walk the kind-split 9-float rows (binned capsules
through the renormalized segment-frame evaluation; one kernel serves
both) and ``cap_rows10`` the 10-float capsule rows (the default walk's
winners and depth bits), at ``span`` 2, 4 or 8 as the default 16-float
walk; ``three_tone`` shades per-kind-constant soups from three or four
representative colors.  The plain backends run
the plain version of the same walk, so a rows9 config renders the rows9
winners there too.  Semantic knobs outside the ported slices raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr3, csr4, csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    triangles_from_mesh,
)
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from pointcloud_render_tpu_torch.utils.consts import const

KERNEL_BACKENDS = ("auto", "pallas6", "pallas4", "pallas3")
PLAIN_BACKENDS = ("cpu", "tiled", "bruteforce")
UNPORTED_BACKENDS = {
    "pallas": "ROADMAP queue B item 11 (pallas_csr2, v2)",
}


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """The JAX package's RasterConfig, every field kept (see the module
    docstring for which fields act here)."""

    backend: str = "auto"
    shading: ShadingConfig = dataclasses.field(default_factory=ShadingConfig)
    chunk: int = 8
    tile_h: int = 8
    tile_w: int = 128
    max_per_tile: int = 512
    max_tiles_per_prim: int = 8
    no_triangles: bool = False
    discs_only: bool = False
    bin_triangles: bool = False
    # Big-list capacity (prims too wide to bin, and the ground); a frame
    # whose big list overflows reports diag["big_overflow"] > 0 and the
    # pipeline retries with a larger list.
    max_big: int = 1024
    span: int = 2
    tiles_per_program: int = 1
    dma_slots: int = 2
    chunk_rows: Optional[int] = None
    allow_exit: Optional[bool] = None
    starts_method: str = "scan"
    cap_rows10: bool = False
    rows8: bool = False
    rows8_carry: bool = False
    cap10_carry: bool = False
    rows9: bool = False
    rows9_carry: bool = False
    row_budget: Optional[int] = None
    unroll: int = 4
    entry_capacity: Optional[int] = None
    supersample: int = 1
    uniform_look: Optional[tuple] = None
    three_tone: Optional[tuple] = None


def check_config(config: RasterConfig) -> None:
    """Raise for backends and semantic knobs the port does not have yet,
    and (ValueError) for the combinations the JAX package rejects."""
    if config.backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {config.backend!r} is not ported yet: "
            + UNPORTED_BACKENDS[config.backend])
    if config.backend not in KERNEL_BACKENDS + PLAIN_BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}")
    if config.three_tone is not None and config.uniform_look is not None:
        raise ValueError("three_tone and uniform_look are exclusive")
    if config.three_tone is not None and len(config.three_tone) not in (3, 5):
        raise ValueError("three_tone takes 3 or 5 prim ids")
    if config.span not in csr6.SPANS:
        raise ValueError(f"span must be one of {csr6.SPANS}")
    if config.rows8_carry and not config.rows8:
        raise ValueError("rows8_carry is a rows8 build variant: requires "
                         "rows8=True")
    if config.rows9_carry and not config.rows9:
        raise ValueError("rows9_carry is a rows9 build variant: requires "
                         "rows9=True")
    if config.allow_exit and config.span != 2:
        raise ValueError("allow_exit requires span=2")
    csr6._kind_split(config.rows8, config.rows9, config.discs_only,
                     config.allow_exit, config.bin_triangles,
                     config.cap_rows10)
    csr6.check_cap10(config.cap_rows10, config.discs_only,
                     config.bin_triangles, config.allow_exit,
                     config.cap10_carry)
    if config.backend not in ("pallas3", "pallas4"):
        csr6.check_disc_span(config.discs_only, config.span)
    if config.supersample != 1:
        raise NotImplementedError(
            f"supersample={config.supersample} is not ported yet: ROADMAP "
            "queue A item 13 (shading/aa.py)")


@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    rgb: torch.Tensor  # (H, W, 3) float32
    depth: torch.Tensor  # (H, W) float32, +inf empty
    index: torch.Tensor  # (H, W) int32, -1 empty


def rasterize(prims: ScreenPrimitives, width: int, height: int,
              config: Optional[RasterConfig] = None):
    """Run the configured backend -> (depth, index) buffers."""
    config = config or RasterConfig()
    check_config(config)
    if config.backend == "pallas4":
        depth, index, _ = csr4.rasterize_csr4(
            prims, width, height, entry_capacity=config.entry_capacity,
            max_big=config.max_big, bin_triangles=config.bin_triangles)
        return depth, index
    if config.backend == "pallas3":
        depth, index, _ = csr3.rasterize_csr3(
            prims, width, height, entry_capacity=config.entry_capacity)
        return depth, index
    depth, index, _ = csr6.rasterize_csr6(
        prims, width, height, max_big=config.max_big,
        plain=config.backend in PLAIN_BACKENDS,
        discs_only=config.discs_only, span=config.span, rows8=config.rows8,
        rows9=config.rows9, bin_triangles=config.bin_triangles,
        cap_rows10=config.cap_rows10)
    return depth, index


def render(prims: ScreenPrimitives, camera,
           config: Optional[RasterConfig] = None,
           return_diag: bool = False):
    """Rasterize + shade a primitive soup through a Camera -> FrameBuffers.

    ``return_diag=True`` also returns ``{"true_entries", "big_overflow"}``
    (int32 device scalars); ``big_overflow`` must be 0 for an exact frame,
    and ``true_entries`` at most a finite ``entry_capacity``.
    """
    config = config or RasterConfig()
    check_config(config)
    if config.backend == "pallas4":
        rgb, depth, index, diag = csr4.render_shaded_csr4(
            prims, camera, config.shading,
            entry_capacity=config.entry_capacity, max_big=config.max_big,
            bin_triangles=config.bin_triangles)
    elif config.backend == "pallas3":
        rgb, depth, index, diag = csr3.render_shaded_csr3(
            prims, camera, config.shading,
            entry_capacity=config.entry_capacity,
            uniform_look=config.uniform_look)
    else:
        rgb, depth, index, diag = csr6.render_shaded_csr6(
            prims, camera, config.shading, max_big=config.max_big,
            plain=config.backend in PLAIN_BACKENDS,
            discs_only=config.discs_only, uniform_look=config.uniform_look,
            allow_exit=config.allow_exit, span=config.span,
            rows8=config.rows8, rows9=config.rows9,
            three_tone=config.three_tone,
            bin_triangles=config.bin_triangles,
            cap_rows10=config.cap_rows10)
    fb = FrameBuffers(rgb=rgb, depth=depth, index=index)
    return (fb, diag) if return_diag else fb


# ---------------------------------------------------------------------------
# Stage geometry (the reference scene's fixed furniture)
# ---------------------------------------------------------------------------

GROUND_COLOR = (1.0, 1.0, 1.0)  # white roughplastic, traj_ball_renderer.py:30-35


def ground_plane(camera, half_extent: float, center=(0.0, 0.0, -0.5),
                 color=GROUND_COLOR) -> ScreenPrimitives:
    """The reference's ground rectangle as two triangles (Mitsuba's
    rectangle is the unit square scaled then translated, reference:
    traj_ball_renderer.py:58-65), with one shared plane normal."""
    cx, cy, cz = center
    e = half_extent
    verts = np.array([
        [cx - e, cy - e, cz],
        [cx + e, cy - e, cz],
        [cx + e, cy + e, cz],
        [cx - e, cy + e, cz],
    ], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    # Four vertices, the same every frame: uploaded once.
    return triangles_from_mesh(const(verts, np.float32, camera.device),
                               const(faces, np.int64, camera.device),
                               camera, np.asarray(color),
                               face_normal=(0.0, 0.0, 1.0))

