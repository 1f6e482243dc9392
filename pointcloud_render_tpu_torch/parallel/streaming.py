"""Streaming rasterization for clouds larger than one frame's soup (the
PyTorch twin of ``pointcloud_render_tpu.parallel.streaming``).

A cloud streams through the card in fixed-size chunks.  The card keeps a
running depth buffer, a running global-id buffer and a winner-attribute
buffer; each chunk's soup goes through one of the port's tile walks and
folds into them by the lexicographic (depth, id) minimum that every walk
uses, with ids offset by the primitives of the chunks before it.  So the
result is the single-pass render of the concatenated soups, winner for
winner; ids are int32 outside the kernels, so only each chunk's soup
must stay below the 2^24 float-id limit of the rows.

On CUDA the host stages each chunk in one of two pinned buffers and
copies it to the card on a copy stream, so that chunk k+1's copy overlaps
chunk k's raster; events order the copy before its raster and keep a
staging buffer from being refilled before its previous copy has read it.
The loop waits for the card once, after the last chunk, to read the
certificates (big-list overflow, and v4's entry count).

Backends (``backend``): ``"pallas6"`` (the default) is the v6 walk
(``csr6.rasterize_csr6``) with the configured kernel knobs, ``"pallas"``
the v4 walk (``csr4.rasterize_csr4``; not v2, as in ``render()``), any
other the capped ``tiled`` backend (``tiles.rasterize_tiled`` at its
defaults, which reports nothing).  CUDA tensors launch the kernels, CPU
tensors take their plain versions.  The JAX package's ``mesh=`` (each
chunk point-sharded across devices) is ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster import csr4, csr6, tiles
from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_DISC,
    KIND_TRIANGLE,
    ScreenPrimitives,
    discs_from_points,
)
from pointcloud_render_tpu_torch.shading.shade import (
    ShadingConfig,
    key_light,
    shade_winner_attrs,
)
from pointcloud_render_tpu_torch.utils.consts import const, device_key

IMAX = 2147483647
PAD_POSITION = 1e30  # a padded point: behind every far plane, culled
STAGING_SLOTS = 2


def drop_furniture(prims: ScreenPrimitives, layout) -> ScreenPrimitives:
    """``prims`` with its fixed parts (``rows_per_point == 0`` in the part
    layout, e.g. the ground) marked invalid: a chunk after the first
    renders none of them, so they win once across the stream."""
    valid = prims.valid
    loc = 0
    for rows, c in layout:
        if (c[1] if isinstance(c, tuple) else c) == 0:
            if valid is prims.valid:
                valid = valid.clone()
            valid[loc:loc + rows] = False
        loc += rows
    if valid is prims.valid:
        return prims
    return dataclasses.replace(prims, valid=valid)


def _fill_chunk(bufs, arrays):
    """Write a chunk's arrays into their (rows, ...) float32 buffers, the
    rows past the chunk padded: positions with PAD_POSITION, colours and
    extras with 0."""
    for k, (buf, a) in enumerate(zip(bufs, arrays)):
        buf[:a.shape[0]] = a
        buf[a.shape[0]:] = PAD_POSITION if k == 0 else 0.0


class _Staging:
    """Pinned host slots and their device twins for one stream's chunks.

    ``put`` fills the next slot (after the copy that last read it has
    finished) and copies it to the device on the copy stream, after the
    raster that last read the device slot; the current stream waits for
    the copy.  ``release`` marks the slot's device tensors as read by
    everything queued so far on the current stream.  The device slots
    come from the current stream's pool, so the copy stream first waits
    for the work queued there: a block that stream freed may still be read
    by its pending kernels."""

    def __init__(self, device: torch.device, rows: int, tails):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.host = [[torch.empty((rows,) + t, dtype=torch.float32,
                                  pin_memory=True) for t in tails]
                     for _ in range(STAGING_SLOTS)]
        self.dev = [[torch.empty((rows,) + t, dtype=torch.float32,
                                 device=device) for t in tails]
                    for _ in range(STAGING_SLOTS)]
        self.stream.wait_stream(torch.cuda.current_stream(device))
        self.copied = [None] * STAGING_SLOTS
        self.consumed = [None] * STAGING_SLOTS
        self.count = 0
        self.waits = 0  # puts that found their slot's last copy pending

    def put(self, arrays):
        slot = self.count % STAGING_SLOTS
        self.count += 1
        if self.copied[slot] is not None:
            if not self.copied[slot].query():
                self.waits += 1
            self.copied[slot].synchronize()
        _fill_chunk([buf.numpy() for buf in self.host[slot]], arrays)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            if self.consumed[slot] is not None:
                self.stream.wait_event(self.consumed[slot])
            for d, h in zip(self.dev[slot], self.host[slot]):
                d.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[slot] = done
        compute.wait_event(done)
        return slot, self.dev[slot]

    def release(self, slot):
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.consumed[slot] = done


class StreamingRasterizer:
    """Chunked rasterizer with persistent depth, id and attribute buffers.

    Args (as the JAX package's, plus ``device``):
      camera: the Camera; its tensors must sit on ``device``.
      chunk_points: points per streamed chunk (a short chunk is padded).
      radius_world: world-space splat radius of the default disc soup.
      backend: "pallas6" (None) | "pallas" (v4) | anything else: the
        capped ``tiled`` backend (see the module docstring).
      color: (3,) colour of chunks given without per-point colours.
      mesh: not ported; raises NotImplementedError (ROADMAP A15).
      entry_capacity: v4's entry capacity (``"pallas"``).
      soup_fn: optional ``(positions, colors, *extras) -> prims`` or
        ``(prims, layout)`` per-chunk soup builder (device tensors in);
        ``run.pipeline.build_primitives(..., return_layout=True)`` gives
        the layout, whose fixed parts the chunks after the first drop.
      shading: the ShadingConfig of ``resolve_rgb`` and of the triangles'
        pre-lit attribute colour.
      max_big: the big-list capacity of the pallas backends.
      config: an optional RasterConfig whose v6 knobs ``"pallas6"``
        forwards: ``span``, ``cap_rows10``, ``rows8``, ``discs_only``,
        ``bin_triangles`` and ``allow_exit``; ``rows9`` is dropped, as
        the JAX package drops it (ROADMAP queue C).
      device: "cuda" (the default) or "cpu" (the plain walks).

    Across chunks of a multi-part soup the parts interleave per chunk, so
    exact depth ties between different parts resolve in (chunk, part,
    point) order; one chunk is the monolithic render of its soup.
    """

    def __init__(self, camera, chunk_points: int, radius_world: float,
                 backend: Optional[str] = None, color=(0.3, 0.3, 0.3),
                 mesh=None, entry_capacity: Optional[int] = None,
                 soup_fn=None, shading: ShadingConfig = ShadingConfig(),
                 max_big: int = 1024, config=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded streaming (each chunk point-sharded over "
                "torch.distributed) is not ported yet: ROADMAP A15")
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self.device = device_key(device)
        for name in ("origin", "target"):
            t = getattr(camera, name)
            if not isinstance(t, torch.Tensor) or \
                    device_key(t.device) != self.device:
                where = t.device if isinstance(t, torch.Tensor) else "host"
                raise ValueError(f"the camera's {name} is on {where}, the "
                                 f"stream on {self.device}: build the "
                                 "camera on the stream's device")
        self.camera = camera
        self.chunk_points = int(chunk_points)
        self.radius = float(radius_world)
        self.color = np.asarray(color, np.float32)
        self.backend = backend or "pallas6"
        self.entry_capacity = entry_capacity
        self.soup_fn = soup_fn
        self.shading = shading
        self.max_big = int(max_big)
        self.config = config
        self._max_entries = 0
        # The last stream's soup rows per chunk (its id stride), and the
        # chunks that found their staging slot's last copy still pending.
        self.prims_per_chunk = None
        self.staging_waits = 0

    # -- device step ---------------------------------------------------------

    def build_soup(self, chunk, colors, extras=()):
        """A chunk's soup -> (prims, layout); layout None for a soup_fn
        that returns bare prims."""
        if self.soup_fn is not None:
            out = self.soup_fn(chunk, colors, *extras)
            return out if isinstance(out, tuple) else (out, None)
        n = chunk.shape[0]
        prims = discs_from_points(
            chunk, self.camera,
            torch.full((n,), self.radius, dtype=torch.float32,
                       device=chunk.device), colors)
        return prims, [(n, 1)]

    def raster_soup(self, prims):
        """-> (depth, index, entries, overflow) of one soup; the
        certificates are () int32 device tensors or None."""
        w, h = self.camera.width, self.camera.height
        if self.backend == "pallas6":
            cfg = self.config
            kw = {}
            if cfg is not None:
                kw = dict(span=cfg.span, cap_rows10=cfg.cap_rows10,
                          rows8=cfg.rows8, discs_only=cfg.discs_only,
                          bin_triangles=cfg.bin_triangles,
                          allow_exit=cfg.allow_exit)
            d, i, diag = csr6.rasterize_csr6(prims, w, h,
                                             max_big=self.max_big, **kw)
            return d, i, None, diag["big_overflow"]
        if self.backend == "pallas":
            d, i, diag = csr4.rasterize_csr4(
                prims, w, h, entry_capacity=self.entry_capacity,
                max_big=self.max_big)
            return d, i, diag["true_entries"], diag["big_overflow"]
        d, i, _ = tiles.rasterize_tiled(prims, w, h)
        return d, i, None, None

    def attribute_table(self, prims) -> torch.Tensor:
        """(P, 6) float32 winner attributes (px, py, rflag, rgb): rflag is
        the projected radius for discs, -1 for capsules (the trail boost
        at shading) and 0 for triangles, whose rgb is pre-lit here with
        the face-normal Lambert (``shade_framebuffer``'s formula); flat
        mode keeps the colour."""
        is_tri = prims.kind == KIND_TRIANGLE
        params = prims.params
        rflag = torch.where(
            prims.kind == KIND_DISC, params[:, 3],
            torch.where(is_tri, torch.zeros_like(params[:, 3]),
                        torch.full_like(params[:, 3], -1.0)))
        rgb = prims.color
        if self.shading.mode != "flat":
            l_cam = key_light(self.camera)
            n = prims.normal
            ndotl = n[:, 0] * l_cam[0] + n[:, 1] * l_cam[1] + \
                n[:, 2] * l_cam[2]
            lit = self.shading.ambient + self.shading.diffuse * \
                torch.clamp(ndotl, min=0.0)
            rgb = torch.where(is_tri[:, None], rgb * lit[:, None], rgb)
        return torch.cat([params[:, 0:2], rflag[:, None], rgb], dim=1)

    def fold(self, prims, d, i, offset: int, depth, index, attrs):
        """Fold one soup's render (ids offset by ``offset``) into the
        running buffers -> (depth, index, attrs): the winners' attributes
        gathered, then the lexicographic (depth, id) minimum."""
        h, w = i.shape
        attr = self.attribute_table(prims).index_select(
            0, torch.clamp(i, min=0).reshape(-1).long()).reshape(h, w, 6)
        hit = i >= 0
        gi = torch.where(hit, i + offset, IMAX)
        d = torch.where(hit, d, float("inf"))
        take = (d < depth) | ((d == depth) & (gi < index))
        return (torch.where(take, d, depth), torch.where(take, gi, index),
                torch.where(take[..., None], attr, attrs))

    def step_soup(self, prims, layout, offset: int, depth, index, attrs):
        """One chunk's soup through raster and fold -> (depth, index,
        attrs, entries, overflow); a chunk after the first drops the
        soup's fixed parts."""
        if offset != 0 and layout is not None:
            prims = drop_furniture(prims, layout)
        d, i, entries, overflow = self.raster_soup(prims)
        return (*self.fold(prims, d, i, offset, depth, index, attrs),
                entries, overflow)

    def step(self, chunk, colors, extras, offset: int, depth, index, attrs):
        """One chunk of device tensors through soup, raster and merge ->
        (depth, index, attrs, entries, overflow), as the JAX ``_step``."""
        prims, layout = self.build_soup(chunk, colors, extras)
        return self.step_soup(prims, layout, offset, depth, index, attrs)

    # -- host loop -----------------------------------------------------------

    def _host_chunk(self, chunk):
        """A chunk as float32 host arrays to stage: [positions] for bare
        positions (the default colour is made on the device), else
        [positions, colours, *extras]."""
        if isinstance(chunk, tuple):
            pos, colors, *extras = chunk
            pos = np.asarray(pos, np.float32)
            arrays = [pos, np.broadcast_to(np.asarray(colors, np.float32),
                                           (pos.shape[0], 3))]
            arrays += [np.asarray(e, np.float32) for e in extras]
        else:
            pos = np.asarray(chunk, np.float32)
            arrays = [pos]
        if pos.shape[0] > self.chunk_points:
            raise ValueError(f"a chunk of {pos.shape[0]} points exceeds "
                             f"chunk_points {self.chunk_points}")
        return arrays

    def _default_colors(self, n: int) -> torch.Tensor:
        """(chunk_points, 3) of the default colour, zero past ``n``."""
        col = const(self.color, np.float32, self.device).expand(
            self.chunk_points, 3)
        if n == self.chunk_points:
            return col
        live = torch.arange(self.chunk_points, device=self.device) < n
        return torch.where(live[:, None], col, torch.zeros_like(col))

    def rasterize(self, chunks: Iterable, return_attrs: bool = False):
        """Consume an iterable of (C, 3) position chunks, or (positions,
        colors[, *extras]) tuples (host arrays; every chunk of one form;
        the last may be short).  Returns (depth, index) with global
        primitive ids (-1 empty), plus the (H, W, 6) attribute buffer when
        ``return_attrs`` (``resolve_rgb`` shades it)."""
        cam = self.camera
        dev = self.device
        rows = self.chunk_points
        depth = torch.full((cam.height, cam.width), float("inf"),
                           dtype=torch.float32, device=dev)
        index = torch.full((cam.height, cam.width), IMAX, dtype=torch.int32,
                           device=dev)
        attrs = torch.zeros((cam.height, cam.width, 6), dtype=torch.float32,
                            device=dev)
        entries_max = overflow_max = None
        offset = 0
        prims_per_chunk = None
        form = None
        staging = None
        for chunk in chunks:
            arrays = self._host_chunk(chunk)
            n = arrays[0].shape[0]
            shape = [a.shape[1:] for a in arrays]
            if form is None:
                form = shape
            elif shape != form:
                raise ValueError("every chunk must have the form of the "
                                 f"first: {form}, got {shape}")
            slot = None
            if dev.type == "cuda":
                if staging is None:
                    staging = _Staging(dev, rows, form)
                slot, staged = staging.put(arrays)
            else:
                bufs = [np.empty((rows,) + t, np.float32) for t in form]
                _fill_chunk(bufs, arrays)
                staged = [torch.from_numpy(b) for b in bufs]
            if len(staged) == 1:
                pos, colors, extras = staged[0], self._default_colors(n), ()
            else:
                pos, colors, extras = staged[0], staged[1], tuple(staged[2:])
            prims, layout = self.build_soup(pos, colors, extras)
            if prims_per_chunk is None:
                prims_per_chunk = prims.count
            elif prims.count != prims_per_chunk:
                raise ValueError(
                    f"a chunk's soup holds {prims.count} primitives, the "
                    f"first chunk's {prims_per_chunk}: global ids need a "
                    "fixed soup size per chunk")
            if offset + prims_per_chunk > IMAX:
                raise ValueError("the stream's global ids pass int32")
            depth, index, attrs, entries, overflow = self.step_soup(
                prims, layout, offset, depth, index, attrs)
            if slot is not None:
                staging.release(slot)
            if entries is not None:
                entries_max = entries if entries_max is None else \
                    torch.maximum(entries_max, entries)
            if overflow is not None:
                overflow_max = overflow if overflow_max is None else \
                    torch.maximum(overflow_max, overflow)
            offset += prims_per_chunk
        self.prims_per_chunk = prims_per_chunk
        if staging is not None:
            self.staging_waits += staging.waits
        certs = [c for c in (entries_max, overflow_max) if c is not None]
        if certs:
            # One read-back for the whole stream.
            values = torch.stack(certs).tolist()
            worst = values[0] if entries_max is not None else 0
            ovf = values[-1] if overflow_max is not None else 0
            self._max_entries = worst
            if ovf > 0:
                raise RuntimeError(
                    f"streaming big-list overflow ({ovf} primitives) — "
                    f"the render silently dropped them; raise max_big or "
                    f"reduce primitive extents.")
            if (self.entry_capacity is not None
                    and worst > self.entry_capacity):
                raise RuntimeError(
                    f"streaming entry_capacity {self.entry_capacity} "
                    f"exceeded (a chunk binned {worst} entries) — the "
                    f"render silently truncated; rerun with capacity >= "
                    f"{worst}.")
        index = torch.where(torch.isinf(depth), -1, index)
        if return_attrs:
            return depth, index, attrs
        return depth, index

    def resolve_rgb(self, depth, index, attrs, shaded: bool = True):
        """Winner attributes -> (H, W, 3) float32 RGB through
        ``shade.shade_winner_attrs`` (the monolithic render's sphere
        Lambert, the trail boost on capsule winners, pre-lit triangles);
        ``shaded=False``: the winner's colour on white."""
        hit = index >= 0
        if not shaded:
            white = const(np.ones(3, np.float32), np.float32, hit.device)
            return torch.where(hit[..., None], attrs[..., 3:6], white)
        return shade_winner_attrs(attrs[..., 0], attrs[..., 1],
                                  attrs[..., 2], attrs[..., 3:6], hit,
                                  self.camera, self.shading)
