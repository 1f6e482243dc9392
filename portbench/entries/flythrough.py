"""Entry ``flythrough``: whole trajectories through
``TrajectoryScanRenderer.render_frames``.

Set-up makes the cloud on the device from the seed (positions uniform in
[-0.5, 0.5)^3, velocities normal(0, 2) per axis), builds the renderer
from the configuration's preset and raster knobs, and renders the
traffic's warm-up frames once (the renderer sizes its big list from
them).  One step renders the traffic's frames in one call, as a user
renders a flythrough, and keeps the frames the check samples.  The
check renders the sampled frames with the plain reference and counts the
pixels whose RGB differs, in every call.

Traffic keys: ``frames`` [start, stop, step], ``frames_per_chunk``,
``warm_frames``, ``checked_frames`` (how many frames the check samples
from the seed) and ``tail_from`` (one of them is drawn from the frames
at or past it: the close dolly).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import common, profile
from portbench.reference import render as ref


def _frames(traffic):
    start, stop, step = traffic["frames"]
    return list(range(start, stop, step))


def sampled_frames(ids, count, tail_from, seed):
    """``count`` frames drawn from the seed: one from each of count - 1
    equal runs of the frames before ``tail_from`` and one from those at
    or past it."""
    rng = np.random.default_rng(seed)
    head = [f for f in ids if f < tail_from]
    tail = [f for f in ids if f >= tail_from]
    runs = np.array_split(np.asarray(head), max(1, count - (1 if tail
                                                             else 0)))
    out = [int(rng.choice(r)) for r in runs if len(r)]
    if tail:
        out.append(int(rng.choice(tail)))
    return sorted(set(out))


def make_cloud(ctx):
    """(positions, velocities) of the configuration's cloud on the device,
    from the seed."""
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(common.seed_u64(ctx.seed))
    n = ctx.config["points"]
    positions = torch.rand((n, 3), generator=gen, device=ctx.device) - 0.5
    velocities = torch.randn((n, 3), generator=gen, device=ctx.device) * 2.0
    return positions, velocities


def checked_frames(ctx):
    traffic = ctx.traffic
    return sampled_frames(_frames(traffic), traffic["checked_frames"],
                          traffic["tail_from"], common.seed_u64(ctx.seed))


def setup(ctx):
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run.trajectory import \
        TrajectoryScanRenderer
    from pointcloud_render_tpu_torch.utils import kernels

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    if dev.type == "cuda":
        kernels.build_all(tuple(cfg["kernels"]))
    positions, velocities = make_cloud(ctx)
    film = cfg["scene"]
    renderer = TrajectoryScanRenderer(
        PRESETS[cfg["preset"]], RasterConfig(**cfg["raster"]), dt=cfg["dt"],
        frames_per_chunk=traffic["frames_per_chunk"], width=film["width"],
        height=film["height"], device=dev)
    renderer.render_frames(positions, velocities, traffic["warm_frames"])
    return dict(ctx=ctx, renderer=renderer, positions=positions,
                velocities=velocities, ids=_frames(traffic),
                check=checked_frames(ctx), kept=[])


def _call(state):
    frames, _ = state["renderer"].render_frames(
        state["positions"], state["velocities"], state["ids"])
    pos = {f: k for k, f in enumerate(state["ids"])}
    state["kept"].append({f: frames[pos[f]] for f in state["check"]})
    return len(frames)


def step(state):
    n = len(state["ids"])
    try:
        return _call(state), n
    except RuntimeError as err:  # a certificate the renderer refused
        print(f"flythrough: call failed: {err}", flush=True)
        return 0, n


def end_to_end(state, units, seconds):
    return {"frames_per_s": units / seconds}


def trace(state):
    """Soup-build spans at the checked frames (outside the scan, between
    CUDA events), then one whole call under the profiler."""
    from pointcloud_render_tpu_torch.run.pipeline import (
        build_primitives,
        frame_camera,
    )

    ctx, r = state["ctx"], state["renderer"]
    dev = ctx.device
    w, h = r.film
    spans = []
    for f in state["check"]:
        fi = torch.tensor(float(f), dtype=torch.float32, device=dev)

        def build():
            cam = frame_camera(r.preset, fi, w, h, dev)
            build_primitives(r.preset, cam, state["positions"],
                             state["velocities"], fi)
        spans += common.event_ms(build, 1, dev)
    if dev.type == "cuda":
        units, prof = profile.traced(lambda: _call(state))
    else:
        units, prof = _call(state), None
    calls = [state["ids"].index(f) for f in state["check"]]
    return dict(profile=prof, units=units, spans={"soup_build_ms": spans},
                roofline_calls={"csr6_raster": calls})


def release(state):
    state.pop("renderer")
    if state["ctx"].device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(state):
    """The pixels of each checked frame, in every call, whose RGB differs
    from the plain reference's frame; the reference's counts for the
    rooflines."""
    ctx = state["ctx"]
    scene = ctx.config["scene"]
    worst, counts = 0, None
    for f in state["check"]:
        want, keys = ref.flythrough_frame(state["positions"],
                                          state["velocities"], f, scene)
        want = want.cpu().numpy()
        for kept in state["kept"]:
            worst = max(worst, common.mismatched_pixels(kept[f], want))
        counts = _add(counts, keys)
    checks = [("px_mismatch", worst, ctx.workload["limits"]["px_mismatch"])]
    return checks, {"reference": dict(counts, images=len(state["check"]),
                                      pixels=scene["width"] * scene["height"])}


def _add(counts, keys):
    counts = counts or {"accepted": {}, "prims": {}}
    for name in ("accepted", "prims"):
        for k, v in getattr(keys, name).items():
            counts[name][k] = counts[name].get(k, 0) + v
    return counts


def control(ctx, dtype):
    """The control: the plain reference in the program's place with its
    soups stored in ``dtype`` -> its worst px_mismatch over the checked
    frames."""
    positions, velocities = make_cloud(ctx)
    scene = ctx.config["scene"]
    worst = 0
    for f in checked_frames(ctx):
        want, _ = ref.flythrough_frame(positions, velocities, f, scene)
        got, _ = ref.flythrough_frame(positions, velocities, f, scene,
                                      quantize=dtype)
        worst = max(worst, common.mismatched_pixels(got.cpu().numpy(),
                                                    want.cpu().numpy()))
    return worst
