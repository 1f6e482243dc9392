"""On-device trajectory rendering: the frame loop of a flythrough.

The PyTorch twin of ``pointcloud_render_tpu.run.trajectory``.  The
reference renders a 220-frame flythrough as 220 independent script-level
iterations, reloading and re-preparing the cloud each time
(traj_ball_renderer.py:460-467).  Here the cloud goes to the device once
and the whole loop runs there: every frame evaluates the camera
trajectory, builds its primitives, rasterizes and encodes sRGB uint8 into
a per-chunk buffer, so device->host moves 6 MB per frame instead of 24.

Where the JAX package compiles a chunk into one ``lax.scan`` dispatch,
PyTorch runs eagerly: a chunk is a Python loop that never waits for the
device.  The running maxima of the exactness certificate stay device
tensors, and one device->host copy of the chunk's frames plus one
certificate read-back happen per chunk; the host reads chunk c back
while the device already renders chunk c + 1 (two buffers in turn).

Static clouds use dt=0 (a pure camera flythrough); dynamic clouds advect
by their velocities each frame, with optional motion coloring.  Sphere
and droplet presets (capsule or mesh LOD, oriented by the velocities,
with velocity trails: traj_vel; mesh-LOD droplets under ``auto`` bin their
triangles, as in ``FramePipeline``).  History-trail presets (traj) carry
a rolling (HISTORY_WINDOW, N, 3) position buffer on the device instead of
the reference's preload of every frame (traj_renderer.py:718-742): it
starts as copies of the initial cloud, so the first frames' trails are
degenerate (the Catmull-Rom dedup collapses the copies: no trail) and
grow as real history accumulates; after each frame the positions it
rendered are pushed in.  The JAX scan pads a short last chunk with
frozen steps; the eager loop renders only real frames, so the state
never advances past the last of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pointcloud_render_tpu_torch.configs import ScenePreset
from pointcloud_render_tpu_torch.geometry.trails import HISTORY_WINDOW
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.run.pipeline import (
    build_primitives,
    check_droplet_lod,
    frame_camera,
    scene_config,
)
from pointcloud_render_tpu_torch.scene import dynamics
from pointcloud_render_tpu_torch.scene.camera import IMAGE_HEIGHT, IMAGE_WIDTH
from pointcloud_render_tpu_torch.shading.shade import check_supported


def srgb_encode_u8(rgb: torch.Tensor) -> torch.Tensor:
    """Linear [0, 1] float -> sRGB uint8, on the tensor's device.  The
    value converted lies in [0.5, 255.5], so the cast truncates toward
    zero within uint8's range.  ``torch.pow`` is not correctly rounded
    (nor is XLA's): frames agree with the JAX package's within 1 level."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    srgb = torch.where(rgb <= 0.0031308, rgb * 12.92,
                       1.055 * torch.pow(rgb, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).to(torch.uint8)


class TrajectoryScanRenderer:
    """Renders a preset's trajectory in chunks of frames on one device."""

    def __init__(self, preset: ScenePreset,
                 raster_config: Optional[RasterConfig] = None,
                 dt: float = 0.0, motion_color: bool = False,
                 droplet_lod: str = "capsule", frames_per_chunk: int = 8,
                 width: Optional[int] = None, height: Optional[int] = None,
                 device="cuda"):
        if preset.splat == "droplet":
            check_droplet_lod(droplet_lod)
        self.preset = preset
        self.raster_config = raster_config or RasterConfig()
        check_config(self.raster_config)
        check_supported(self.raster_config.shading)
        self.dt = float(dt)
        self.motion_color = motion_color
        self.droplet_lod = droplet_lod
        self.frames_per_chunk = int(frames_per_chunk)
        self.film = (width or IMAGE_WIDTH, height or IMAGE_HEIGHT)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self._probed = False

    def _soup(self, positions, velocities, frame_index, history=None):
        """(camera, primitive soup) of one frame."""
        w, h = self.film
        camera = frame_camera(self.preset, frame_index, w, h, self.device)
        if not self.motion_color:
            return camera, build_primitives(self.preset, camera, positions,
                                            velocities, frame_index, history,
                                            droplet_lod=self.droplet_lod)
        prims, layout = build_primitives(self.preset, camera, positions,
                                         velocities, frame_index, history,
                                         droplet_lod=self.droplet_lod,
                                         return_layout=True)
        # Recolor the splats by speed: the first per-point block of the
        # soup layout (head discs for droplets), not a hardcoded offset
        # past the ground's rows.
        off = 0
        for count, per in layout:
            if per == 1:
                break
            off += count
        else:
            raise ValueError("motion_color needs a per-point splat block "
                             f"(layout {layout}): mesh LOD unsupported")
        color = prims.color.clone()
        color[off:off + positions.shape[0]] = dynamics.motion_colors(
            velocities)
        return camera, dataclasses.replace(prims, color=color)

    def _probe_max_big(self, positions, velocities, frame_indices):
        """Size ``max_big`` from the measured big-list overflow at five
        sampled trajectory frames (+50% margin, rounded up to 512).  The
        walk has no other capacity; close-dolly trail frames can push the
        big list past the default.  The per-chunk certificate still checks
        every frame afterwards: this probe only avoids a wasted first
        render.  Advects the cloud to each sampled frame when dt != 0, and
        bins with the render's own ``discs_only``, span, kind split and
        ``bin_triangles``.  History presets see their real trail
        capsules: under linear advection frame j's positions are exactly
        p - v * dt * (fi - j), clamped at frame 0, where the scan's buffer
        holds the initial cloud (the JAX probe's rule)."""
        ids = sorted(frame_indices)
        if not ids:
            return
        samples = {ids[0], ids[len(ids) // 4], ids[len(ids) // 2],
                   ids[3 * len(ids) // 4], ids[-1]}
        w, h = self.film
        worst = 0
        for fi in sorted(samples):
            p = (dynamics.advect(positions, velocities, self.dt * fi)
                 if self.dt else positions)
            hist = None
            if self.preset.trail == "history":
                hist = self._probe_history(p, velocities, fi)
            camera = frame_camera(self.preset, fi, w, h, self.device)
            prims = build_primitives(self.preset, camera, p, velocities, fi,
                                     hist, droplet_lod=self.droplet_lod)
            cfg = self._config()
            worst = max(worst, int(csr6.bin_diagnostics6(
                prims, w, h, max_big=cfg.max_big, discs_only=cfg.discs_only,
                span=cfg.span, kind_split=cfg.rows8 or cfg.rows9,
                bin_triangles=cfg.bin_triangles)))
        if worst > 0:
            mb = self.raster_config.max_big + int(worst * 1.5)
            self.raster_config = dataclasses.replace(
                self.raster_config, max_big=((mb + 511) // 512) * 512)

    def _probe_history(self, p, velocities, fi):
        """The (HISTORY_WINDOW, N, 3) buffer the scan holds at frame
        ``fi`` (see :meth:`_probe_max_big`)."""
        if velocities is None or not self.dt:
            return p[None].expand(HISTORY_WINDOW, *p.shape)
        f = torch.full((), float(fi), dtype=torch.float32, device=p.device)
        offs = torch.arange(HISTORY_WINDOW, 0, -1, dtype=torch.float32,
                            device=p.device)
        j = torch.clamp(f - offs, min=0.0)
        back = (self.dt * (f - j))[:, None, None]
        return p[None] - velocities[None] * back

    def _config(self) -> RasterConfig:
        """The render's config: :func:`scene_config` of the given one."""
        return scene_config(self.preset, self.raster_config,
                            self.droplet_lod)

    def _chunk_buffers(self):
        """(device frames, host frames, host certificate) of one chunk;
        on a card the host side is pinned so the copies are asynchronous."""
        w, h = self.film
        shape = (self.frames_per_chunk, h, w, 3)
        frames = torch.empty(shape, dtype=torch.uint8, device=self.device)
        if self.device.type != "cuda":
            return frames, frames, torch.empty(2, dtype=torch.int32)
        return (frames,
                torch.empty(shape, dtype=torch.uint8, pin_memory=True),
                torch.empty(2, dtype=torch.int32, pin_memory=True))

    def render_frames(self, positions, velocities, frame_indices):
        """Render the given frame indices in chunks; returns a list of
        (H, W, 3) uint8 numpy frames and the final (advected) positions, a
        tensor on the device.  ``velocities`` may be None (no velocity
        trails; a history buffer of a cloud at rest).  Each call starts
        its own history buffer from ``positions``."""
        dev = self.device
        pos = torch.as_tensor(positions, dtype=torch.float32, device=dev)
        vel = (None if velocities is None else
               torch.as_tensor(velocities, dtype=torch.float32, device=dev))
        if vel is None and (self.dt or self.motion_color):
            raise ValueError("dt != 0 and motion_color need velocities")
        ids = list(frame_indices)
        if not self._probed:
            self._probe_max_big(pos, vel, ids)
            self._probed = True
        # The frame ids go to the device once; a frame then reads its own
        # as a device scalar (a per-frame upload would wait for the stream).
        ids_dev = torch.tensor(ids, dtype=torch.float32, device=dev)
        fpc = self.frames_per_chunk
        buffers = [self._chunk_buffers()
                   for _ in range(min(2, -(-len(ids) // fpc)))]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        cfg = self._config()
        hist = (pos[None].expand(HISTORY_WINDOW, *pos.shape)
                if self.preset.trail == "history" else None)
        out, pending = [], None
        for c, lo in enumerate(range(0, len(ids), fpc)):
            # A short last chunk renders its own frames only: an eager loop
            # has no fixed trip count to pad, so the state never advances
            # past the last real frame.
            chunk_ids = ids[lo:lo + fpc]
            frames, host_frames, host_cert = buffers[c % 2]
            tc_max, ovf_max = zero, zero
            for k in range(len(chunk_ids)):
                camera, prims = self._soup(pos, vel, ids_dev[lo + k], hist)
                fb, diag = render(prims, camera, cfg, return_diag=True)
                # The certificate's running maxima over every frame of the
                # chunk stay on the device.
                tc_max = torch.maximum(tc_max, diag["true_entries"])
                ovf_max = torch.maximum(ovf_max, diag["big_overflow"])
                frames[k] = srgb_encode_u8(fb.rgb)
                if hist is not None:
                    # The frame rendered only prior frames; push its own.
                    hist = torch.cat([hist[1:], pos[None]])
                if self.dt:
                    pos = dynamics.advect(pos, vel, self.dt)
            n = len(chunk_ids)
            done = None
            if dev.type == "cuda":
                host_frames[:n].copy_(frames[:n], non_blocking=True)
                done = torch.cuda.Event()
            host_cert.copy_(torch.stack([tc_max, ovf_max]), non_blocking=True)
            if done is not None:
                done.record(torch.cuda.current_stream(dev))
            if pending is not None:
                self._finish_chunk(*pending, out)
            pending = (done, host_frames, host_cert, chunk_ids)
        if pending is not None:
            self._finish_chunk(*pending, out)
        return out, pos

    def _finish_chunk(self, done, host_frames, host_cert, chunk_ids, out):
        """Wait for a chunk's copies, certify it and keep its frames."""
        if done is not None:
            done.synchronize()
        tc_max, ovf_max = (int(x) for x in host_cert.tolist())
        self._certify_chunk(tc_max, ovf_max, chunk_ids)
        host = host_frames.numpy()
        out.extend(host[k].copy() for k in range(len(chunk_ids)))

    def _certify_chunk(self, tc_max: int, ovf_max: int, chunk_ids):
        """Per-chunk exactness check after the fact: the loop carried the
        maxima of the binned-entry count and of the big-list overflow over
        every rendered frame; a violation means dropped primitives, so
        fail loudly instead of returning a silently truncated image."""
        cap = self.raster_config.entry_capacity
        if cap is not None and tc_max > cap:
            raise RuntimeError(
                f"entry capacity violated in frames {chunk_ids[0]}.."
                f"{chunk_ids[-1]}: max true_entry_count {tc_max} > "
                f"capacity {cap}; re-render with entry_capacity >= {tc_max}.")
        if ovf_max > 0:
            raise RuntimeError(
                f"overflow ({ovf_max} primitives) in frames "
                f"{chunk_ids[0]}..{chunk_ids[-1]}: the render dropped "
                f"them.  Raise max_big (the big list), or reduce primitive "
                f"screen extents.")
