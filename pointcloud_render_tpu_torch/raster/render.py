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
  "pallas"          — v2 (``raster/csr2.py``): strip tiles of ``tile_h`` x
                      ``tile_w``, v1's binning (``raster/csr.py``), the
                      big list first and the saturation early exit;
                      kernel or plain likewise;
  "cpu", "tiled", "bruteforce" — the JAX package's exact reference
                      backends: the plain version of the default v6 walk
                      (16-float rows at span 2; one plain rasterizer
                      serves all three), on any device.

As in the JAX package, ``pallas`` and the three plain backends rasterize
and then shade through ``shading.shade.shade_framebuffer`` (no
``uniform_look`` or ``three_tone`` epilogue; the GGX lobe and the GI fill
when they are on); the fused epilogues of ``auto``/``pallas6``,
``pallas4`` and ``pallas3`` raise for the look knobs, which the JAX
package's fused kernels drop (``FramePipeline`` re-shades a look frame
through ``shade_framebuffer`` whatever the backend, and applies
``supersample``, which ``render`` leaves to it); the plain backends ignore
the walk's knobs (``rows9``, ``rows8``, ``cap_rows10``, ``discs_only``,
``span``, ``bin_triangles``) and report ``true_entries`` 0.

``RasterConfig`` keeps every field of the JAX package's so configs stay
compatible.  Under ``pallas``, ``tile_h``, ``tile_w``,
``max_tiles_per_prim``, ``no_triangles``, ``discs_only`` and
``entry_capacity`` decide what is binned, what rides the big list and
what is dropped; its big list is fixed at 1024, as the JAX package never
forwards ``max_big`` to v2.  The TPU performance knobs
(``tiles_per_program``, ``dma_slots``, ``chunk_rows``, ``unroll``,
``starts_method``, the ``*_carry`` build variants, ``chunk``,
``max_per_tile``) are accepted and have no effect, and so
are ``tile_h``/``tile_w``, ``max_tiles_per_prim`` and ``no_triangles``
outside ``pallas``; ``entry_capacity`` drops entries under ``pallas4``,
``pallas3`` and ``pallas`` and is checked against the frame's
``true_entries`` by the pipelines.  Under the v6 backends: ``allow_exit``
turns the z-bucket early exit of the 16-float walk on or off (None: on
for generic soups at span 2, as in the JAX package; the winners do not
change) and decides whether a two-tone disc scene may take the fused
(u, v) shade (forced on, it may not); ``discs_only`` walks
8-float disc rows (capsules ride the big list) and ``uniform_look`` shades
two-tone scenes from two constant colors; ``bin_triangles`` bins small
triangles (the mesh-LOD droplets) into the 16-float walk of ``pallas6``
and ``pallas4``, as the JAX package does (``pallas4`` shades generically,
as ``render_shaded_csr4`` does); ``rows9`` and ``rows8`` walk the
kind-split 9-float rows (binned capsules through the renormalized
segment-frame evaluation; one kernel serves both) and ``cap_rows10`` the
10-float capsule rows (the default walk's winners and depth bits), at
``span`` 2, 4 or 8 as the default 16-float walk; ``three_tone`` shades
per-kind-constant soups from three or four representative colors;
``row_budget`` walks rows for the first ``row_budget`` sorted positions
only (every v6 walk, as the JAX package's row gather): binned prims past
it are dropped from the frame and counted in the diag's
``row_overflow``, which must be 0 for an exact frame (size the budget
with ``csr6.bin_diagnostics6(..., return_binned=True)``).  The
v6 backends reject what ``pallas_csr6`` rejects; the others only what
their JAX functions reject.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr2, csr3, csr4, csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    triangles_from_mesh,
)
from pointcloud_render_tpu_torch.shading.shade import (
    ShadingConfig,
    shade_framebuffer,
)
from pointcloud_render_tpu_torch.utils.consts import const

V6_BACKENDS = ("auto", "pallas6")
KERNEL_BACKENDS = V6_BACKENDS + ("pallas4", "pallas3", "pallas")
# The backends whose render() shades in a fused epilogue (no look passes).
FUSED_BACKENDS = V6_BACKENDS + ("pallas4", "pallas3")
PLAIN_BACKENDS = ("cpu", "tiled", "bruteforce")


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
    """Raise (ValueError) for an unknown backend, a ``supersample`` that is
    not a positive int, and the combinations the configured backend's JAX
    function rejects: ``pallas_csr6``'s under ``auto``/``pallas6``."""
    if config.backend not in KERNEL_BACKENDS + PLAIN_BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}")
    if config.supersample < 1 or int(config.supersample) != config.supersample:
        raise ValueError(f"supersample must be an int >= 1, got "
                         f"{config.supersample!r}")
    if config.backend not in V6_BACKENDS:
        return
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


@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    rgb: torch.Tensor  # (H, W, 3) float32
    depth: torch.Tensor  # (H, W) float32, +inf empty
    index: torch.Tensor  # (H, W) int32, -1 empty


def _rasterize_diag(prims: ScreenPrimitives, width: int, height: int,
                    config: RasterConfig):
    """(depth, index, diag) of the backends that rasterize and then shade:
    ``pallas`` (v2, with the certificate the JAX package's ``render``
    computes for it) and the plain backends (the plain default v6 walk;
    ``true_entries`` 0, as they drop no entry, and the big list's
    overflow, which the pipelines heal)."""
    if config.backend == "pallas":
        return csr2.rasterize_csr2(
            prims, width, height, tile_h=config.tile_h, tile_w=config.tile_w,
            max_tiles_per_prim=config.max_tiles_per_prim,
            no_triangles=config.no_triangles, discs_only=config.discs_only,
            entry_capacity=config.entry_capacity)
    depth, index, diag = csr6.rasterize_csr6(prims, width, height,
                                             max_big=config.max_big,
                                             plain=True)
    return depth, index, dict(
        true_entries=torch.zeros((), dtype=torch.int32, device=depth.device),
        big_overflow=diag["big_overflow"])


def rasterize(prims: ScreenPrimitives, width: int, height: int,
              config: Optional[RasterConfig] = None):
    """Run the configured backend -> (depth, index) buffers."""
    config = config or RasterConfig()
    check_config(config)
    if config.backend == "pallas4":
        depth, index, _ = csr4.rasterize_csr4(
            prims, width, height, entry_capacity=config.entry_capacity,
            max_big=config.max_big, bin_triangles=config.bin_triangles)
    elif config.backend == "pallas3":
        depth, index, _ = csr3.rasterize_csr3(
            prims, width, height, entry_capacity=config.entry_capacity)
    elif config.backend in V6_BACKENDS:
        depth, index, _ = csr6.rasterize_csr6(
            prims, width, height, max_big=config.max_big,
            discs_only=config.discs_only, span=config.span,
            rows8=config.rows8, rows9=config.rows9,
            bin_triangles=config.bin_triangles, cap_rows10=config.cap_rows10,
            allow_exit=config.allow_exit, row_budget=config.row_budget)
    else:
        depth, index, _ = _rasterize_diag(prims, width, height, config)
    return depth, index


def render(prims: ScreenPrimitives, camera,
           config: Optional[RasterConfig] = None,
           return_diag: bool = False):
    """Rasterize + shade a primitive soup through a Camera -> FrameBuffers.

    ``return_diag=True`` also returns ``{"true_entries", "big_overflow"}``
    (int32 device scalars), and under the v6 backends ``row_overflow``;
    ``big_overflow`` and ``row_overflow`` must be 0 for an exact frame,
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
    elif config.backend in V6_BACKENDS:
        rgb, depth, index, diag = csr6.render_shaded_csr6(
            prims, camera, config.shading, max_big=config.max_big,
            discs_only=config.discs_only, uniform_look=config.uniform_look,
            allow_exit=config.allow_exit, span=config.span,
            rows8=config.rows8, rows9=config.rows9,
            three_tone=config.three_tone,
            bin_triangles=config.bin_triangles,
            cap_rows10=config.cap_rows10, row_budget=config.row_budget)
    else:
        depth, index, diag = _rasterize_diag(prims, camera.width,
                                             camera.height, config)
        rgb = shade_framebuffer(prims, camera, depth, index, config.shading)
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

