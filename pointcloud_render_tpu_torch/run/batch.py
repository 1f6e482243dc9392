"""Batch runner: frame-file discovery, resume manifest, per-frame metrics.

The PyTorch twin of ``pointcloud_render_tpu.run.batch`` (the reference's
main() loops, traj_ball_renderer.py:419-477): the same frame-file
synthesis (frames 200-219 reuse frame 199), missing-file warnings and
per-frame error containment, plus a manifest of completed frames so an
interrupted batch resumes at the first unrendered frame.  History-trail
presets (traj) preload every frame once (load, standardize, transform)
and slide a window of ``preset.history_window`` prior frames over them
(traj_renderer.py:718-742); the render reuses the preloaded frame.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from pointcloud_render_tpu_torch.configs import ScenePreset
from pointcloud_render_tpu_torch.run.metrics import (
    FrameRecord,
    MetricsSink,
    stage,
)
from pointcloud_render_tpu_torch.run.pipeline import FramePipeline

MANIFEST_NAME = "manifest.json"


class Manifest:
    """Frame-completion journal (JSON: {frame_index: png_name})."""

    def __init__(self, folder: str):
        self.path = os.path.join(folder, MANIFEST_NAME)
        self.done = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.done = {int(k): v for k, v in json.load(f).items()}
            except (json.JSONDecodeError, ValueError):
                self.done = {}

    def is_done(self, frame_index: int, out_folder: str) -> bool:
        name = self.done.get(frame_index)
        return bool(name) and os.path.exists(os.path.join(out_folder, name))

    def mark(self, frame_index: int, png_path: str):
        self.done[frame_index] = os.path.basename(png_path)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self.done.items()}, f)
        os.replace(tmp, self.path)


def preload_frames(pipeline: FramePipeline, plan) -> dict:
    """{frame index: prepared (N, 3|6) array, or None where it failed to
    load} for every (frame, path) of ``plan``: the history preload."""
    frames = {}
    for fi, path in plan:
        try:
            frames[fi] = pipeline.load_and_prepare(path)
        except Exception as e:  # noqa: BLE001 — reference continues
            print(f"Warning: Failed to load {os.path.basename(path)}: {e}")
            frames[fi] = None
    return frames


def history_window(frames: dict, frame_index: int,
                   window: int) -> Optional[np.ndarray]:
    """The (H, N, 3) positions of the preloaded frames among the
    ``window`` frame indices before ``frame_index``, oldest first (missing
    and failed frames skipped), or None when there are none."""
    lo = max(0, frame_index - window)
    hs = [frames.get(h) for h in range(lo, frame_index)]
    hs = [h[:, :3] for h in hs if h is not None]
    return np.stack(hs) if hs else None


def run_batch(preset: ScenePreset, input_folder: Optional[str] = None,
              output_folder: Optional[str] = None, frames=None,
              pipeline: Optional[FramePipeline] = None, resume: bool = True,
              sink: Optional[MetricsSink] = None,
              write_depth: bool = False) -> MetricsSink:
    """Render a preset's whole frame schedule.  Returns the metrics sink;
    a frame that raised has a record with ``status == "error"``."""
    input_folder = input_folder or preset.input_folder
    output_folder = output_folder or preset.output_folder
    frames = list(frames if frames is not None else preset.frames)
    pipeline = pipeline or FramePipeline(preset)
    sink = sink or MetricsSink()
    os.makedirs(output_folder, exist_ok=True)
    manifest = Manifest(output_folder)

    plan = []
    for fi in frames:
        path = os.path.join(input_folder, preset.frame_file(fi))
        if os.path.isfile(path):
            plan.append((fi, path))
        else:
            print(f"Warning: File not found: {path}")
    if not plan:
        print(f"No target files found in folder: {input_folder}")
        return sink

    all_frames = (preload_frames(pipeline, plan)
                  if preset.trail == "history" else None)
    t_start = time.perf_counter()
    for fi, path in plan:
        if resume and manifest.is_done(fi, output_folder):
            continue
        rec = FrameRecord(frame_index=fi, file=os.path.basename(path))
        try:
            history = None
            if all_frames is not None:
                history = history_window(all_frames, fi,
                                         preset.history_window)
            with stage(rec, "load"):
                pcl = all_frames.get(fi) if all_frames is not None else None
                if pcl is None:
                    pcl = pipeline.load_and_prepare(path)
            rec.points = int(pcl.shape[0])
            with stage(rec, "render"):
                fb = pipeline.render_array(pcl, fi, history)
                if pipeline.device.type == "cuda":
                    torch.cuda.synchronize(pipeline.device)
            with stage(rec, "save"):
                out_path = pipeline.save_outputs(fb, path, fi,
                                                 output_folder,
                                                 write_depth)
            manifest.mark(fi, out_path)
        except Exception as e:  # noqa: BLE001 — reference: print and continue
            rec.status = "error"
            rec.error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        sink.emit(rec)

    total = time.perf_counter() - t_start
    s = sink.summary()
    s["wall_s"] = total
    print(f"Batch done: {s}")
    return sink
