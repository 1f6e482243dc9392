#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pointcloud_render_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels (one source, three kernels) from csrc/ with nvcc;
  3. hold the csr6 tile kernel against its plain PyTorch version on six
     seeded soups at 1920x1080 and one traj_ball frame, and the two
     disc-row kernels (csr6_disc8, csr6_disc8_uv) against theirs on the
     seeded soups and a disc scene with exact depth ties and two wide
     discs on the big list: depth bits, winner index and the (u, v) bits
     with their +inf markers must be equal;
  4. the soup built on the card must equal the soup built on the CPU;
  5. write seeded binary 1M-point PLYs (positions + velocities, the
     traffic of bench.py's flagship lane) and render frames 10, 120 and
     205 through the traj_ball CLI at 1920x1080: every frame record ok,
     PNGs written, the kernel launched by that run;
  6. frame 205's big list overflows the default max_big and a fresh
     FramePipeline self-heals it on the card; every frame's big-list
     certificate is 0 after self-heal; count the big list over the fade
     tail (frames 200-219) and self-heal at its peak; at frames 120, 205
     and that peak, time warm frames, the frames' stages, a profiler trace
     of warm frames (device busy share and the top device kernels), and
     the kernel beside its plain version;
  7. the disc lane of bench.py (ground + 1M sphere splats of radius 0.002,
     discs_only, uniform_look, max_big 256): both disc kernels equal their
     plain versions on the 1M-point cloud at frames 0, 120 and 219; the
     fused shade equals shade_by_id(uniform_look) bit for bit; then the
     220-frame flythrough through TrajectoryScanRenderer at 1920x1080 in
     chunks of 8: certificate 0 on every chunk, one csr6_disc8_uv launch
     per frame, frames equal to the plain backend's, frames/s, ms/frame,
     the stages of one warm frame and a trace of one warm chunk (device
     idle share, host synchronisations); 8 frames without uniform_look
     (csr6_disc8) and 8 advected traj_ball frames with trails
     (csr6_raster) show the loop drives those kernels too;
  8. the droplet slice: (a) the kind-split kernel csr6_rows9 against its
     plain version at spans 2, 4 and 8 on seeded 1080p traj_vel soups
     (head discs, tapered tail capsules, trail capsules, exact depth ties,
     long capsules past each span, invalid rows) and on the seeded soups of
     phase 3; (b) the traj_vel CLI on phase 5's PLYs, frames 10, 120 and
     205, default config (csr6_raster over the droplet soup); (c) the
     droplet lane of bench.py: 1M droplets with 4-segment velocity
     trails, span and max_big by bench.py's probe, the four-tone reps of
     frame 20 with their certificate, rows9: certificate 0 and one
     csr6_rows9 launch on each of the 12 frames, the kernel equal to its
     plain version and rows8 equal to rows9 at frames 20, 120 and 219,
     the four-tone shade beside the generic one, the kernel's time,
     plain time and bound, the stages of one warm frame, warm ms/frame,
     a trace of one warm frame, and 8 frames of the scan on the lane's
     config (one csr6_rows9 launch each).
The last two lines are the card line and {"ok": true, "device": {...}};
before them a {"kernels": [...]} line with each kernel's numbers: launches
on its main path, time beside its plain version and its bound (the pairs
the walk must evaluate times the float32 operations per pair, over the
card's float32 rate without multiply-add fusion; or its bytes over the
memory rate if that is larger).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
FRAMES = (10, 120, 205)
KERNEL_SOURCE = "pointcloud_render_tpu_torch/csrc/csr6_raster.cu"
REPLACES = {
    "csr6_raster": "pointcloud_render_tpu/raster/pallas_csr6.py:601",
    "csr6_disc8": "pointcloud_render_tpu/raster/pallas_csr6.py:268",
    "csr6_disc8_uv": "pointcloud_render_tpu/raster/pallas_csr6.py:505",
    "csr6_rows9": "pointcloud_render_tpu/raster/pallas_csr6.py:435",
}
LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))  # bench.py's disc lane
SCAN_FRAMES = 220
SCAN_CHUNK = 8
# The card's peaks (NVIDIA's H100 SXM data sheet): 67 TFLOP/s float32
# counts a fused multiply-add as two; the walks are IEEE per operation
# (no fusion), so they retire at most half of that in operations.
F32_OPS_PER_S = 67e12 / 2
BYTES_PER_S = 3.35e12
# float32 operations that every (row, pixel) pair must execute.  What is
# the same for a whole pixel column of a row (dx, dx * dx, dx * sdx, the
# qx products of the edge functions) is not a pair's, and what is read
# only at covered pairs (the three compares of the (depth, id) merge, and
# a capsule's depth z = z0 + sdz * t and a triangle's 1 / iz with its
# select, which the compiler may sink into the covered branch) is a small
# share with splats of a few pixels in 1024-pixel tiles: both are left
# out.
#   disc row:     dy, dy * dy, + dx2, <= r2                              4
#   capsule row:  dy, the projection t (3), its clip (2), cx and cy (4),
#                 rad (2), cx * cx + cy * cy <= rad * rad (5)           17
#   triangle row: three edge functions (3 each), the 1/z plane (5),
#                 four compares                                         18
#   rows9 capsule row (renormalized): dy, a and g (2 each; dx * ux and
#                 dx * uy are per column), the clip (2), a - t,
#                 am * am + g * g (3), rad (2), d2 <= rad * rad (2),
#                 rad > 0                                               16
#   rows9 disc row: as the disc row                                      4
OPS_CAPSULE16, OPS_TRIANGLE16, OPS_DISC8 = 17, 18, 4
OPS_DISC9, OPS_CAPSULE9 = 4, 16
# bench.py's droplet lane (bench.py:624-659, :913, tuned_defaults.json
# "droplet"): 12 frames over linspace(20, 219), 4 capsules per trail.
DROPLET_POINTS = 1_000_000
DROPLET_FRAMES = 12
DROPLET_SEGMENTS = 4


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def flagship_cloud(n, seed):
    """bench.py's flagship traffic: positions uniform in [-0.5, 0.5)^3 and
    velocities normal(0, 2) per axis.  Near the camera (frames 200-219)
    thousands of trail segments at 1M points pass the 2x2-tile span and
    ride the big list, past the default max_big of 1024."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    return pos, vel


def soup_camera(device):
    """The fixed camera of the seeded soups."""
    import torch

    from pointcloud_render_tpu_torch.scene.camera import Camera

    return Camera(origin=torch.tensor([2.0, 2.0, 2.0], device=device),
                  target=torch.tensor([0.0, 0.0, -0.05], device=device))


def disc_lane_soup(device):
    """A two-tone disc scene at 1920x1080: the white ground, two wide gray
    discs that ride the big list, and 20k gray discs three times over
    (exact depth ties between the copies)."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.raster.primitives import (
        ScreenPrimitives,
        discs_from_points,
    )
    from pointcloud_render_tpu_torch.raster.render import ground_plane

    cam = soup_camera(device)
    rng = np.random.default_rng(2027)
    dup = rng.uniform(-0.5, 0.5, (20000, 3)).astype(np.float32)

    def discs(pos, r):
        return discs_from_points(
            torch.tensor(pos, device=device), cam,
            torch.full((pos.shape[0],), r, device=device),
            np.asarray(LOOK[0], np.float32))

    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0.0, 0.0, -0.5)), discs(dup[:2] * 0.2, 0.15),
         discs(dup, 0.012), discs(dup, 0.012), discs(dup[::-1].copy(), 0.012)])


def soups(device):
    """Six seeded soups at 1920x1080 covering ties, a dense tile, big-list
    prims, edge tiles, invalid rows and near-clipped triangles."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.raster.primitives import (
        ScreenPrimitives,
        capsules_from_vertex_columns,
        discs_from_points,
        triangles_from_mesh,
    )
    from pointcloud_render_tpu_torch.raster.render import ground_plane

    cam = soup_camera(device)
    gray = np.array([0.3, 0.3, 0.3], np.float32)
    green = np.array([0.2, 1.0, 0.4], np.float32)

    def t(a):
        return torch.tensor(a, device=device)

    def discs(pos, r):
        return discs_from_points(t(pos), cam, torch.full(
            (pos.shape[0],), r, device=device), gray)

    def caps(pts, r):
        ones = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
        return capsules_from_vertex_columns(
            [t(pts[:, j]) for j in range(pts.shape[1])],
            [ones] * pts.shape[1], cam, r, green)

    def ground():
        return ground_plane(cam, 10.0, (0.0, 0.0, -0.5))

    rng = np.random.default_rng(2026)
    out = {}
    pos = rng.uniform(-0.6, 0.6, (60000, 3)).astype(np.float32)
    # Trails: random walks of ~6 px steps (binned capsules).
    steps = rng.normal(0.0, 0.005, (4000, 9, 3)).cumsum(axis=1)
    pts = (steps + rng.uniform(-0.5, 0.5, (4000, 1, 3))).astype(np.float32)
    out["mixed"] = ScreenPrimitives.concatenate(
        [ground(), discs(pos, 0.01), caps(pts, 0.0007)])
    dup = rng.uniform(-0.5, 0.5, (20000, 3)).astype(np.float32)
    out["ties"] = ScreenPrimitives.concatenate(
        [ground(), discs(dup, 0.012), discs(dup, 0.012),
         discs(dup[::-1].copy(), 0.012)])
    dense = np.concatenate([rng.normal(0, 0.004, (30000, 2)),
                            rng.uniform(-0.5, 0.5, (30000, 1))], axis=1)
    out["dense_tile"] = ScreenPrimitives.concatenate(
        [ground(), discs(dense.astype(np.float32), 0.004)])
    wide = rng.uniform(-0.4, 0.4, (700, 3)).astype(np.float32)
    out["big_list"] = ScreenPrimitives.concatenate(
        [ground(), discs(wide, 0.15), discs(pos[:5000], 0.01)])
    # Edge tiles: a cloud filling the frame past its right and bottom
    # edges (1080 = 33.75 tiles: the last tile row is partial).
    edge = rng.uniform(-1.6, 1.6, (40000, 3)).astype(np.float32)
    out["edge_tiles"] = ScreenPrimitives.concatenate(
        [discs(edge, 0.006), caps(pts[:1000] * 2.5, 0.001)])
    eye = np.array([2.0, 2.0, 2.0], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    side = np.cross(fwd, [0.0, 0.0, 1.0]).astype(np.float32)
    verts, faces = [], []
    for k in range(30):
        a, b = rng.uniform(-0.1, 0.2), rng.uniform(0.4, 2.0)
        base = len(verts)
        verts += [eye + fwd * a + side * rng.uniform(-0.5, 0.5),
                  eye + fwd * b + side * rng.uniform(-0.5, 0.5),
                  eye + fwd * b + np.array([0, 0, rng.uniform(-0.4, 0.4)])]
        faces.append([base, base + 1, base + 2])
    tris = triangles_from_mesh(np.asarray(verts, np.float32),
                               np.asarray(faces), cam,
                               np.array([0.9, 0.4, 0.1], np.float32))
    mixed = out["mixed"]
    valid = mixed.valid.clone()
    valid[torch.arange(0, valid.shape[0], 5, device=device)] = False
    out["invalid_nearclip"] = ScreenPrimitives.concatenate(
        [tris, ScreenPrimitives(kind=mixed.kind, params=mixed.params,
                                color=mixed.color, valid=valid,
                                bbox=mixed.bbox, normal=mixed.normal)])
    return out


def time_ms(fn, reps):
    """Median of ``reps`` CUDA-event-timed calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def region_entries(b, span, regions):
    """Tile entries of the binned rows per ordinal region (one region, or
    discs then capsules under a kind split): each sorted position counts
    the tiles its class covers."""
    import numpy as np

    from pointcloud_render_tpu_torch.raster import csr6

    k2 = span * span
    counts = (b["starts"][1:] - b["starts"][:-1]).reshape(
        regions, -1, k2).sum(dim=1).cpu().numpy().astype(np.int64)
    spill_x, spill_y = csr6.class_spill(span)
    weights = (np.array(spill_x) + 1) * (np.array(spill_y) + 1)
    return [int(c @ weights) for c in counts]


def walk_bound(b, soup, width, height, row_bytes, ops_binned, n_images,
               span=2, id_bytes=4):
    """(bound ms, "operations" | "bytes") of one tile walk on this soup:
    the least time the card could take for the pairs the walk must
    evaluate (1024 pixels x tile entries of binned rows, every pixel x
    every live big row, each at its body's float32 operations) and for
    its bytes (each row it evaluates read once with its sorted id, the
    range starts, the output images written once).  ``ops_binned`` is one
    count, or (disc, capsule) counts for a kind-split binning, whose rows
    sit in sorted order (``id_bytes`` 0)."""
    if isinstance(ops_binned, int):
        ops_binned = (ops_binned,)
    entries = region_entries(b, span, len(ops_binned))
    nb = int(b["big_n"][0])
    n_small = int(b["starts"][-1])
    n_tri = int((soup.kind[b["big_ids"][:nb].long()] == 2).sum())
    pixels = width * height
    ops = (1024 * sum(e * o for e, o in zip(entries, ops_binned))
           + pixels * (n_tri * OPS_TRIANGLE16 + (nb - n_tri) * OPS_CAPSULE16))
    nbytes = (n_small * (row_bytes + id_bytes) + nb * (64 + 4)
              + b["starts"].numel() * 4 + pixels * 4 * n_images)
    t_ops, t_bytes = ops / F32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_equal_bits(got, want, what):
    """Every image of ``got`` equals ``want`` bit for bit -> max |err| of
    the finite depths (0.0 when equal; kept for the kernels line)."""
    import torch

    check(len(got) == len(want), f"{what}: output count differs")
    for k, (a, b) in enumerate(zip(got, want)):
        a32 = a if a.dtype == torch.int32 else a.view(torch.int32)
        b32 = b if b.dtype == torch.int32 else b.view(torch.int32)
        check(torch.equal(a32, b32),
              f"{what}: output {k} differs from the plain version on "
              f"{int((a32 != b32).sum())} pixels")
    check(bool((got[1] >= 0).any()), f"{what}: empty render, nothing compared")
    fin = torch.isfinite(want[0])
    return (float((got[0][fin] - want[0][fin]).abs().max())
            if bool(fin.any()) else 0.0)


def compare(soup, width, height, csr6, max_big, timing=False):
    """csr6_raster vs plain on one soup -> dict(err, ms, plain_ms, bound_ms,
    bound_by); the times and the bound only with ``timing``."""
    import torch

    b = csr6.bin_csr6(soup, width, height, max_big)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    table = csr6.build_table16(soup, zeros, zeros[:, 0])
    args = (table, b["order"], b["starts"], b["big_ids"], b["big_n"],
            width, height)
    got = csr6.raster_tiles(*args)
    torch.cuda.synchronize()
    want = csr6.raster_tiles_plain(*args)
    torch.cuda.synchronize()
    out = dict(err=check_equal_bits(got, want, "csr6_raster"))
    if timing:
        bound_ms, bound_by = walk_bound(b, soup, width, height, 64,
                                        OPS_CAPSULE16, 2)
        out.update(ms=time_ms(lambda: csr6.raster_tiles(*args), 11),
                   plain_ms=time_ms(lambda: csr6.raster_tiles_plain(*args), 2),
                   bound_ms=bound_ms, bound_by=bound_by)
    return out


def compare_disc(soup, flag, width, height, csr6, max_big, timing=False):
    """csr6_disc8 and csr6_disc8_uv vs their plain versions on one soup ->
    {kernel name: dict(err, ms, plain_ms, bound_ms, bound_by)}; ``flag``
    is preshade's disc flag (lane 5 of the disc rows, lane 13 of the big
    rows), which the (u, v) walk multiplies by."""
    import torch

    b = csr6.bin_csr6(soup, width, height, max_big, discs_only=True)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    args = (csr6.build_table8(soup, flag),
            csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["order"], b["starts"], b["big_n"], width, height)
    out = {}
    for name, kernel, plain, images in (
            ("csr6_disc8", csr6.raster_tiles_disc8,
             csr6.raster_tiles_disc8_plain, 2),
            ("csr6_disc8_uv", csr6.raster_tiles_disc8_uv,
             csr6.raster_tiles_disc8_uv_plain, 4)):
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        out[name] = dict(err=check_equal_bits(got, want, name))
        if timing:
            bound_ms, bound_by = walk_bound(b, soup, width, height, 32,
                                            OPS_DISC8, images)
            out[name].update(
                ms=time_ms(lambda k=kernel: k(*args), 11),
                plain_ms=time_ms(lambda f=plain: f(*args), 2),
                bound_ms=bound_ms, bound_by=bound_by)
    return out, b


def compare_rows9(soup, width, height, csr6, max_big, span, timing=False):
    """csr6_rows9 vs its plain version on one soup at ``span`` -> (dict(err,
    ms, plain_ms, bound_ms, bound_by), binning); the times and the bound
    only with ``timing``."""
    import torch

    b = csr6.bin_csr6(soup, width, height, max_big, span=span,
                      kind_split=True)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    args = (csr6.build_table9(soup, b["order"], b["starts"][-1]),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], width, height, span)
    got = csr6.raster_tiles_rows9(*args)
    torch.cuda.synchronize()
    want = csr6.raster_tiles_rows9_plain(*args)
    torch.cuda.synchronize()
    out = dict(err=check_equal_bits(got, want, f"csr6_rows9 span {span}"))
    if timing:
        bound_ms, bound_by = walk_bound(b, soup, width, height, 36,
                                        (OPS_DISC9, OPS_CAPSULE9), 2,
                                        span=span, id_bytes=0)
        out.update(ms=time_ms(lambda: csr6.raster_tiles_rows9(*args), 11),
                   plain_ms=time_ms(
                       lambda: csr6.raster_tiles_rows9_plain(*args), 1),
                   bound_ms=bound_ms, bound_by=bound_by)
    return out, b


def droplet_soups(device):
    """Seeded traj_vel soups at 1920x1080 for csr6_rows9, at frames 120 and
    205: ``tests/torch_soups.droplet_soup`` of 30k droplets (ties, every
    7th row invalid) with 400 long straight capsules, which at this film
    pass 2x2, 4x4 and 8x8 tiles (the big list at each span) and reach 5-8
    tiles on both axes (binned only at span 8)."""
    import importlib.util

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.run import pipeline

    # By file name: an installed package named ``tests`` may shadow the
    # checkout's.
    spec = importlib.util.spec_from_file_location(
        "torch_soups", os.path.join(REPO, "tests", "torch_soups.py"))
    torch_soups = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_soups)
    preset = PRESETS["traj_vel"]
    return {f"droplets_f{fi}": torch_soups.droplet_soup(
        pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, device), n=30000,
        seed=2028, frame=fi, long_caps=400) for fi in (120, 205)}


def stage_times(stages, reps=3):
    """Stream time per stage of one frame -> {name: ms}: ``stages`` is a
    list of (name, fn), run in order, each fn reading and filling one dict
    of the frame's values; CUDA events between stages, mean of ``reps``
    runs after a warm-up.  An interval also holds any time the stream
    waited for the host to launch its next op."""
    import torch

    totals = dict.fromkeys((name for name, _ in stages), 0.0)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(stages) + 1)]
        ev[0].record()
        frame = {}
        for k, (_, fn) in enumerate(stages):
            fn(frame)
            ev[k + 1].record()
        torch.cuda.synchronize()
        if rep:
            for k, name in enumerate(totals):
                totals[name] += ev[k].elapsed_time(ev[k + 1]) / reps
    return totals


def lane_stages(csr6, trajectory, soup_fn, cfg, fi):
    """The stages of one droplet-lane frame, in the order
    render_shaded_csr6 runs them under rows9 + three_tone (no preshade)."""
    import torch

    w, h, span = WIDTH, HEIGHT, cfg.span

    def build(f):
        f["soup"], f["cam"] = soup_fn(fi)

    def binning(f):
        f["b"] = csr6.bin_csr6(f["soup"], w, h, cfg.max_big, span=span,
                               kind_split=True)

    def tables(f):
        soup, b = f["soup"], f["b"]
        f["zeros"] = torch.zeros((soup.count, 3), device=soup.device)
        f["rows9"] = csr6.build_table9(soup, b["order"], b["starts"][-1])
        f["big"] = csr6.build_table16_rows(soup, f["zeros"],
                                           f["zeros"][:, 0], b["big_ids"])

    def kernel(f):
        b = f["b"]
        f["depth"], f["index"] = csr6.raster_tiles_rows9(
            f["rows9"], f["big"], b["starts"], b["big_n"], w, h, span)

    def shade(f):
        f["rgb"] = csr6.shade_by_id(f["soup"], f["cam"], cfg.shading,
                                    f["depth"], f["index"], f["zeros"],
                                    f["zeros"][:, 0],
                                    three_tone=cfg.three_tone)

    return [("camera+soup build", build), ("binning (kind split)", binning),
            ("table9 + big rows", tables), ("csr6_rows9 kernel", kernel),
            ("shade_by_id (four-tone)", shade),
            ("srgb_encode_u8", lambda f: trajectory.srgb_encode_u8(f["rgb"])),
            ("overflow read-back",
             lambda f: int(f["b"]["diag"]["big_overflow"]))]


def droplet_cli(card, inp, out, counters):
    """Phase 8 (b): the traj_vel CLI on phase 5's PLYs (frames 10, 120,
    205, default config: csr6_raster over the droplet soup) -> its
    csr6_raster launches."""
    import torch

    from pointcloud_render_tpu_torch.cli import traj_vel_renderer

    for c in counters:
        c.launches = 0
    sink = traj_vel_renderer.main(
        ["--input-folder", inp, "--output-folder", out,
         "--frames", ",".join(map(str, FRAMES)), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = counters[0].launches
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == 3 and all(s == "ok" for _, s, _ in statuses),
          f"traj_vel frame records not all ok: {statuses}")
    for fi in FRAMES:
        check(os.path.getsize(os.path.join(out, f"frame_{fi:04d}_b0.png"))
              > 1000, f"traj_vel frame_{fi:04d}_b0.png missing")
    check(launches >= 3 and sum(c.launches for c in counters[1:]) == 0,
          f"traj_vel CLI: csr6_raster launched {launches} times, want >= 3 "
          "and no other kernel")
    for r in sink.records:
        t = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in r.timings_s.items())
        print(f"[droplet cli] frame {r.frame_index}: {r.points} points {t} "
              f"({card})", flush=True)
    print(f"[droplet cli] traj_vel frames 10, 120, 205 ok, PNGs written; "
          f"csr6_raster launches {launches}", flush=True)
    return launches


def droplet_lane(card, dev, max_err, counters, tmp) -> dict:
    """Phase 8 (c): bench.py's droplet lane -> dict(launches, ms, plain_ms,
    bound_ms, bound_by) of csr6_rows9 (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import csr6
    from pointcloud_render_tpu_torch.raster.render import (
        RasterConfig,
        render,
    )
    from pointcloud_render_tpu_torch.run import pipeline, trajectory

    n = DROPLET_POINTS
    preset = PRESETS["traj_vel"]
    # bench.py:383-384, :698-699: positions uniform in [-0.5, 0.5)^3 from
    # seed 0, velocities normal(0, 2) from seed 1.
    pos_host = np.random.default_rng(0).uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32)
    vel_host = np.random.default_rng(1).normal(0, 2, (n, 3)).astype(
        np.float32)
    pos = torch.tensor(pos_host, device=dev)
    vel = torch.tensor(vel_host, device=dev)
    frames = np.linspace(20, 219, DROPLET_FRAMES).astype(np.int32).tolist()

    def soup_fn(fi):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        return pipeline.build_primitives(
            preset, cam, pos, vel, fi,
            trail_segments=DROPLET_SEGMENTS), cam

    # Span and max_big by bench.py's rules (:727-760): the big count at
    # each span over the probe frames; the smallest span whose worst
    # frame has at most 2048 big rows; 1.5x that plus 64, rounded.
    probe = list(dict.fromkeys([frames[0], frames[len(frames) // 2],
                                frames[-2], frames[-1]]))
    bigs = {s: [] for s in csr6.SPANS}
    for fi in probe:
        soup, _ = soup_fn(fi)
        for s in csr6.SPANS:
            bigs[s].append(int(csr6.bin_csr6(soup, WIDTH, HEIGHT,
                                             span=s)["big_count"]))
    span = next((s for s in csr6.SPANS if max(bigs[s]) <= 2048), 8)
    need = int(max(bigs[span]) * 1.5) + 64
    max_big = 384 if need <= 384 else ((need + 255) // 256) * 256
    check(max_big <= 65536, f"droplet lane: probed big list {bigs}")
    print(f"[droplet] {n} droplets, {DROPLET_SEGMENTS}-segment trails, "
          f"{soup.count} prims; big list at probe frames {probe} by span "
          f"{bigs}: span {span}, max_big {max_big}", flush=True)
    # The four-tone reps of frame 20 and their certificate (:780-804).
    soup, cam = soup_fn(frames[0])
    reps3, ok3 = csr6.derive_three_tone(soup)
    reps4, ok4 = csr6.derive_four_tone(soup)
    check(not bool(ok3) and bool(ok4), f"droplet soup tone certificates: "
          f"three-tone {bool(ok3)}, four-tone {bool(ok4)}; want False, True")
    tones = tuple(int(r) for r in reps4.cpu())
    cfg = RasterConfig(rows9=True, span=span, max_big=max_big,
                       three_tone=tones)
    print(f"[droplet] four-tone reps {tones}, certificate ok; config rows9, "
          f"span {span}, max_big {max_big}", flush=True)

    # The kernel against its plain version, rows8 against rows9, and the
    # four-tone shade against the generic one at three frames.
    timed = {}
    for fi in (20, 120, 219):
        soup, cam = soup_fn(fi)
        res, b = compare_rows9(soup, WIDTH, HEIGHT, csr6, max_big, span,
                               timing=fi == 120)
        max_err["csr6_rows9"] = max(max_err["csr6_rows9"], res["err"])
        fb8 = render(soup, cam, dataclasses.replace(cfg, rows9=False,
                                                    rows8=True))
        fb9 = render(soup, cam, cfg)
        for field in ("depth", "index", "rgb"):
            a, c = getattr(fb8, field), getattr(fb9, field)
            check(torch.equal(a.view(torch.int32), c.view(torch.int32)),
                  f"droplet frame {fi}: rows8 {field} differs from rows9")
        rgb_p, flag = csr6.preshade(soup, cam, cfg.shading)
        generic = csr6.shade_by_id(soup, cam, cfg.shading, fb9.depth,
                                   fb9.index, rgb_p, flag)
        gap = float((generic - fb9.rgb).abs().max())
        u8 = int((trajectory.srgb_encode_u8(generic)
                  != trajectory.srgb_encode_u8(fb9.rgb)).sum())
        check(gap <= 1e-6, f"droplet frame {fi}: four-tone shade {gap} from "
              "the generic shade")
        region = region_entries(b, span, 2)
        print(f"[droplet] frame {fi}: {soup.count} prims, "
              f"{int(b['starts'][-1])} binned, tile entries discs "
              f"{region[0]} capsules {region[1]}, big list "
              f"{int(b['big_count'])}; csr6_rows9 == plain bit for bit, "
              f"rows8 == rows9, four-tone rgb within {gap:.3g} of the "
              f"generic shade, {u8} u8 values differ", flush=True)
        if fi == 120:
            timed = res
            print(f"[time] csr6_rows9 kernel {res['ms']:.3f} ms (median of "
                  f"11), plain {res['plain_ms']:.1f} ms (median of 1), "
                  f"bound {res['bound_ms']:.3f} ms by {res['bound_by']} at "
                  f"the droplet lane's frame-120 shape ({card})", flush=True)

    # The main path: the lane's 12 frames through build_primitives +
    # render, certificate read once at the end.
    for c in counters:
        c.launches = 0
    ovf, cover = [], []
    for fi in frames:
        soup, cam = soup_fn(fi)
        fb, diag = render(soup, cam, cfg, return_diag=True)
        ovf.append(diag["big_overflow"])
        cover.append((fb.index >= 0).float().mean())
    torch.cuda.synchronize()
    launches = csr6.raster_tiles_rows9.launches
    others = {c.__name__: c.launches for c in counters if c.launches}
    check(launches == len(frames) and set(others) == {"raster_tiles_rows9"},
          f"droplet lane: csr6_rows9 launched {launches} times over "
          f"{len(frames)} frames; launches {others}")
    ovf = torch.stack(ovf).cpu().tolist()
    cover = torch.stack(cover).cpu().tolist()
    check(not any(ovf), f"droplet lane certificates {ovf}")
    check(min(cover) > 0.05, f"droplet lane frames look empty: {cover}")
    print(f"[droplet] lane frames {frames}: certificate 0 on every frame, "
          f"csr6_rows9 launches {launches}, covered share "
          f"{min(cover):.3f}..{max(cover):.3f}", flush=True)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        for fi in frames:
            soup, cam = soup_fn(fi)
            render(soup, cam, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / len(frames))
    print(f"[droplet] warm ms/frame over the lane's {len(frames)} frames "
          f"(soup build + render, one synchronisation per pass): "
          f"{times[0]:.3f}, {times[1]:.3f} ({card})", flush=True)
    for stage, ms in stage_times(lane_stages(csr6, trajectory, soup_fn,
                                             cfg, 120)).items():
        print(f"[stage] droplet lane frame 120 {stage}: {ms:.3f} ms "
              f"({card})", flush=True)
    busy, wall_us, top, _ = device_profile(
        lambda: render(*soup_fn(120), cfg), 1, tmp)
    if top:
        print(f"[trace] droplet lane frame 120: device busy "
              f"{busy / 1e3:.2f} of {wall_us / 1e3:.2f} ms wall, idle share "
              f"{1 - busy / wall_us:.3f} ({card})", flush=True)
        for name, us in top[:6]:
            print(f"[trace] droplet {us / 1e3:9.3f} ms  {name[:90]}",
                  flush=True)
    else:
        print("[trace] droplet lane: the profiler saw no device activity; "
              "device busy share not measured", flush=True)

    # The scan on the lane's config (its own 8-segment trails).
    before = csr6.raster_tiles_rows9.launches
    scan = trajectory.TrajectoryScanRenderer(
        preset, cfg, frames_per_chunk=8, width=WIDTH, height=HEIGHT,
        device=dev)
    scan_frames, _ = scan.render_frames(pos_host, vel_host, range(116, 124))
    torch.cuda.synchronize()
    scan_launches = csr6.raster_tiles_rows9.launches - before
    check(scan_launches == 8, f"droplet scan: csr6_rows9 launched "
          f"{scan_launches} times, want 8")
    check(all((f.min(axis=2) < 250).mean() > 0.01 for f in scan_frames),
          "droplet scan frames look empty")
    print(f"[droplet] scan of traj_vel frames 116-123 on the lane's config: "
          f"csr6_rows9 launches {scan_launches}, max_big "
          f"{scan.raster_config.max_big}, certificate 0", flush=True)
    return dict(timed, launches=launches)


def frame_stages(pipeline, csr6, preset, pcl, fi, dev, max_big):
    """The stages of one traj_ball frame, in the order render_shaded_csr6
    runs them."""
    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    shading = ShadingConfig()

    def build(f):
        f["cam"] = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        f["soup"] = pipeline.build_primitives(preset, f["cam"], pcl[:, :3],
                                              pcl[:, 3:], fi)

    def preshade(f):
        f["rgb"], f["flag"] = csr6.preshade(f["soup"], f["cam"], shading)

    def binning(f):
        f["b"] = csr6.bin_csr6(f["soup"], WIDTH, HEIGHT, max_big)

    def table(f):
        f["table"] = csr6.build_table16(f["soup"], f["rgb"], f["flag"])

    def kernel(f):
        b = f["b"]
        f["depth"], f["index"] = csr6.raster_tiles(
            f["table"], b["order"], b["starts"], b["big_ids"], b["big_n"],
            WIDTH, HEIGHT)

    def shade(f):
        csr6.shade_by_id(f["soup"], f["cam"], shading, f["depth"],
                         f["index"], f["rgb"], f["flag"])

    return [("camera+soup build", build), ("preshade", preshade),
            ("binning (sort, starts, big list)", binning),
            ("table16", table), ("csr6_raster kernel", kernel),
            ("shade_by_id", shade),
            ("overflow read-back",
             lambda f: int(f["b"]["diag"]["big_overflow"]))]


def device_profile(render, frames, trace_dir):
    """torch.profiler trace of ``frames`` warm calls of ``render`` ->
    (device busy us, wall us, [(kernel name, device us)] by time, {CUDA
    runtime call: count} for the launches, copies and synchronisations the
    host made).  Busy is the union of the
    intervals of device kernels, copies and memsets; wall is the host
    clock around the traced calls, profiler cost included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    by_name = {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    calls = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and (
                "Synchronize" in name or "Launch" in name
                or "Memcpy" in name):
            calls[name] = calls.get(name, 0) + 1
    return busy, wall, sorted(by_name.items(), key=lambda kv: -kv[1]), calls


def scan_stages(pipeline, csr6, trajectory, preset, pos, fi, dev, max_big):
    """The stages of one disc-lane frame, in the order the scan runs
    them."""
    import torch

    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    shading = ShadingConfig()
    fi_dev = torch.tensor(float(fi), device=dev)

    def build(f):
        f["cam"] = pipeline.frame_camera(preset, fi_dev, WIDTH, HEIGHT, dev)
        f["soup"] = pipeline.build_primitives(preset, f["cam"], pos, None,
                                              fi_dev)

    def preshade(f):
        f["rgb"], f["flag"] = csr6.preshade(f["soup"], f["cam"], shading)

    def binning(f):
        f["b"] = csr6.bin_csr6(f["soup"], WIDTH, HEIGHT, max_big,
                               discs_only=True)

    def tables(f):
        f["table8"] = csr6.build_table8(f["soup"], f["flag"])
        f["big"] = csr6.build_table16_rows(f["soup"], f["rgb"], f["flag"],
                                           f["b"]["big_ids"])

    def kernel(f):
        b = f["b"]
        f["depth"], _, f["u"], f["v"] = csr6.raster_tiles_disc8_uv(
            f["table8"], f["big"], b["order"], b["starts"], b["big_n"],
            WIDTH, HEIGHT)

    def shade(f):
        f["lit"] = csr6.shade_uv(f["cam"], shading, f["depth"], f["u"],
                                 f["v"], LOOK)

    return [("camera+soup build", build), ("preshade", preshade),
            ("binning (sort, starts, big list)", binning),
            ("table8 + big rows", tables), ("csr6_disc8_uv kernel", kernel),
            ("shade_uv", shade),
            ("srgb_encode_u8", lambda f: trajectory.srgb_encode_u8(f["lit"]))]


def disc_lane(card, dev, max_err) -> dict:
    """Phase 7 -> {kernel name: dict(launches, ms, plain_ms, bound_ms,
    bound_by)} for csr6_disc8 and csr6_disc8_uv (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import csr6
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline, trajectory
    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    n = 1_000_000
    max_big = 256
    # bench.py:383-398, :903: positions uniform in [-0.5, 0.5)^3 from seed
    # 0, gray splats of radius 0.002, the ground at z = -0.5, no trails.
    pos_host = np.random.default_rng(0).uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32)
    pos = torch.tensor(pos_host, device=dev)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.002,
                                 point_color=LOOK[0])
    cfg = RasterConfig(discs_only=True, max_big=max_big, uniform_look=LOOK)
    shading = ShadingConfig()
    counters = (csr6.raster_tiles, csr6.raster_tiles_disc8,
                csr6.raster_tiles_disc8_uv, csr6.raster_tiles_rows9)

    def reset_counts():
        for c in counters:
            c.launches = 0

    # Both kernels against their plain versions at the lane's own shapes,
    # and the two shade epilogues against each other.
    timed = {}
    for fi in (0, 120, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        soup = pipeline.build_primitives(preset, cam, pos, None, fi)
        rgb_p, flag = csr6.preshade(soup, cam, shading)
        res, b = compare_disc(soup, flag, WIDTH, HEIGHT, csr6, max_big,
                              timing=fi == 120)
        for kernel, r in res.items():
            max_err[kernel] = max(max_err[kernel], r["err"])
        print(f"[disc] frame {fi}: {soup.count} prims, "
              f"{int(b['starts'][-1])} binned, true_entries "
              f"{int(b['diag']['true_entries'])}, big list "
              f"{int(b['big_count'])} of max_big {max_big}; csr6_disc8 and "
              "csr6_disc8_uv == plain bit for bit", flush=True)
        if fi == 120:
            timed = res
            for kernel, r in res.items():
                print(f"[time] {kernel} kernel {r['ms']:.3f} ms (median of "
                      f"11), plain {r['plain_ms']:.1f} ms (median of 2), "
                      f"bound {r['bound_ms']:.3f} ms by {r['bound_by']} at "
                      f"the disc lane's frame-120 shape ({card})", flush=True)
        zeros = torch.zeros((soup.count, 3), device=dev)
        depth, index, u, v = csr6.raster_tiles_disc8_uv(
            csr6.build_table8(soup, flag),
            csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["order"], b["starts"], b["big_n"], WIDTH, HEIGHT)
        fused = csr6.shade_uv(cam, shading, depth, u, v, LOOK)
        by_id = csr6.shade_by_id(soup, cam, shading, depth, index, rgb_p,
                                 flag, uniform_look=LOOK)
        check(torch.equal(fused.view(torch.int32), by_id.view(torch.int32)),
              f"frame {fi}: shade_uv differs from shade_by_id(uniform_look)")
        generic = csr6.shade_by_id(soup, cam, shading, depth, index, rgb_p,
                                   flag)
        print(f"[disc] frame {fi}: shade_uv == shade_by_id(uniform_look) bit "
              "for bit; max |rgb| difference from the generic shade "
              f"{float((fused - generic).abs().max()):.3g}", flush=True)

    # The big list at the frames the scan's probe samples: the lane runs
    # at max_big 256 and its certificate fails the run on any overflow.
    probed = {}
    for fi in (0, 55, 110, 165, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        soup = pipeline.build_primitives(preset, cam, pos, None, fi)
        probed[fi] = int(csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big,
                                       discs_only=True)["big_count"])
    print(f"[scan] big list at the probed frames: {probed}", flush=True)
    check(max(probed.values()) <= max_big,
          f"the disc lane's big list exceeds max_big {max_big}: {probed}")

    # The flythrough: warm-up chunk (the probe, first launches), then the
    # whole trajectory as the main path with the counts reset.
    film = dict(frames_per_chunk=SCAN_CHUNK, width=WIDTH, height=HEIGHT,
                device="cuda")
    scan = trajectory.TrajectoryScanRenderer(preset, cfg, **film)
    scan.render_frames(pos_host, None, range(SCAN_CHUNK))
    check(scan.raster_config.max_big == max_big,
          f"the probe raised max_big to {scan.raster_config.max_big}: the "
          "lane's big list does not fit")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    frames, final = scan.render_frames(pos, None, range(SCAN_FRAMES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    uv_launches = csr6.raster_tiles_disc8_uv.launches
    check(uv_launches == SCAN_FRAMES and csr6.raster_tiles.launches == 0
          and csr6.raster_tiles_disc8.launches == 0
          and csr6.raster_tiles_rows9.launches == 0,
          f"{SCAN_FRAMES}-frame scan: csr6_disc8_uv launched {uv_launches} "
          "times, want one per frame and no other kernel")
    check(len(frames) == SCAN_FRAMES and all(
        f.shape == (HEIGHT, WIDTH, 3) and f.dtype == np.uint8
        for f in frames), "scan frames malformed")
    check(torch.equal(final, pos), "a static scan moved the cloud")
    cover = [float((f.min(axis=2) < 250).mean()) for f in frames]
    check(min(cover) > 0.01 and cover[199] > cover[0],
          f"scan frames look empty: coverage {min(cover):.4f}.."
          f"{max(cover):.4f}")
    print(f"[scan] {SCAN_FRAMES} frames, {n} points, {WIDTH}x{HEIGHT}, chunks "
          f"of {SCAN_CHUNK}: certificate 0 on every chunk (max_big {max_big})"
          f", csr6_disc8_uv launches {uv_launches}, {wall:.3f} s wall, "
          f"{SCAN_FRAMES / wall:.2f} frames/s warm ({card})", flush=True)
    # The same three frames through the plain backend on the card.
    check_ids = (0, 120, SCAN_FRAMES - 1)
    plain_frames, _ = trajectory.TrajectoryScanRenderer(
        preset, dataclasses.replace(cfg, backend="cpu"), **film
    ).render_frames(pos, None, check_ids)
    for fi, want in zip(check_ids, plain_frames):
        check(np.array_equal(frames[fi], want),
              f"scan frame {fi} differs from the plain backend's")
    print("[scan] frames 0, 120, 219 equal the plain backend's bit for bit",
          flush=True)
    del frames
    per_frame = []
    for lo in range(0, SCAN_FRAMES, SCAN_CHUNK):
        ids = range(lo, min(lo + SCAN_CHUNK, SCAN_FRAMES))
        t0 = time.perf_counter()
        scan.render_frames(pos, None, ids)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1e3 / len(ids))
    q1, med, q3 = statistics.quantiles(per_frame, n=4)
    print(f"[scan] ms/frame over {len(per_frame)} chunks rendered one call "
          f"each: median {med:.3f}, quartiles {q1:.3f}-{q3:.3f} ({card})",
          flush=True)
    for stage, ms in stage_times(scan_stages(pipeline, csr6, trajectory,
                                             preset, pos, 120, dev,
                                             max_big)).items():
        print(f"[stage] disc lane frame 120 {stage}: {ms:.3f} ms ({card})",
              flush=True)
    for line in host_profile(
            lambda: scan.render_frames(pos, None, range(104, 120))):
        print(f"[host] 16 warm frames: {line} ({card})", flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        busy, wall_us, top, calls = device_profile(
            lambda: scan.render_frames(pos, None, range(104, 112)), 1, tmp)
    if top:
        syncs = {k: v for k, v in calls.items() if "Synchronize" in k}
        print(f"[trace] one warm chunk (frames 104-111): device busy "
              f"{busy / 1e3:.2f} of {wall_us / 1e3:.2f} ms wall, idle share "
              f"{1 - busy / wall_us:.3f}; host calls in the chunk {calls} "
              f"({card})", flush=True)
        for name, us in top[:8]:
            print(f"[trace] scan {us / 8e3:9.3f} ms/frame  {name[:90]}",
                  flush=True)
        waits = sum(syncs.values())
        check(waits < SCAN_CHUNK, f"the chunk synchronised {waits} times: "
              "the frame loop waits for the device inside a chunk")
    else:
        print("[trace] scan: the profiler saw no device activity; device "
              "busy share not measured", flush=True)

    # The non-fused disc walk on the same loop (no uniform_look).
    reset_counts()
    plain_look, _ = trajectory.TrajectoryScanRenderer(
        preset, RasterConfig(discs_only=True, max_big=max_big), **film
    ).render_frames(pos, None, range(116, 124))
    torch.cuda.synchronize()
    disc8_launches = csr6.raster_tiles_disc8.launches
    check(disc8_launches == 8 and csr6.raster_tiles_disc8_uv.launches == 0,
          f"discs_only scan: csr6_disc8 launched {disc8_launches} times, "
          "want 8")
    fused_look, _ = scan.render_frames(pos, None, range(116, 124))
    diff = np.abs(np.stack(plain_look).astype(np.int16)
                  - np.stack(fused_look).astype(np.int16))
    print(f"[scan] 8 frames without uniform_look: csr6_disc8 launches "
          f"{disc8_launches}; u8 frames differ from the fused look's by at "
          f"most {int(diff.max())} level(s) on {int((diff > 0).sum())} of "
          f"{diff.size} values", flush=True)

    # The same loop on the traj_ball preset with trails, advected.
    _, vel_host = flagship_cloud(n, seed=11)
    dt = 0.002
    reset_counts()
    trail = trajectory.TrajectoryScanRenderer(PRESETS["traj_ball"], dt=dt,
                                              **film)
    trail_frames, moved = trail.render_frames(pos_host, vel_host,
                                              range(100, 108))
    torch.cuda.synchronize()
    check(csr6.raster_tiles.launches == 8,
          f"trail scan: csr6_raster launched {csr6.raster_tiles.launches} "
          "times, want 8")
    drift = float((moved.cpu() - torch.tensor(pos_host + vel_host * (dt * 8))
                   ).abs().max())
    check(drift < 1e-5, f"advected positions off by {drift}")
    check(all((f.min(axis=2) < 250).mean() > 0.01 for f in trail_frames),
          "trail scan frames look empty")
    print(f"[scan] 8 advected traj_ball frames (trails, dt {dt}): csr6_raster "
          f"launches {csr6.raster_tiles.launches}, max_big "
          f"{trail.raster_config.max_big}, certificate 0", flush=True)
    return dict(
        csr6_disc8=dict(timed["csr6_disc8"], launches=disc8_launches),
        csr6_disc8_uv=dict(timed["csr6_disc8_uv"], launches=uv_launches))


def host_profile(render, top=10):
    """cProfile of one call of ``render`` (ending in a synchronise) ->
    lines "cumulative s, calls, function" of the port's own functions and
    the array copies that take the most host time."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    render()
    torch.cuda.synchronize()
    prof.disable()
    rows = []
    for (path, line, name), (_, calls, _, cum, _) in pstats.Stats(
            prof).stats.items():
        if "pointcloud_render_tpu_torch" in path or name.startswith(
                "<method 'copy'"):
            rows.append((cum, calls, f"{os.path.basename(path)}:{line} {name}"
                         if line else name))
    rows.sort(reverse=True)
    return [f"{cum:.4f} s cumulative, {calls} calls, {what}"
            for cum, calls, what in rows[:top]]


def run() -> dict:
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    try:
        from pointcloud_render_tpu_torch.cli import traj_ball_renderer
        from pointcloud_render_tpu_torch.configs import PRESETS
        from pointcloud_render_tpu_torch.io import ply
        from pointcloud_render_tpu_torch.raster import csr6
        from pointcloud_render_tpu_torch.run import pipeline
        from pointcloud_render_tpu_torch.scene import normalize
        from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
        from pointcloud_render_tpu_torch.utils import convert, kernels
    except ImportError as e:
        raise SmokeFailure(f"the port is not importable here: {e}") from e
    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    counters = (csr6.raster_tiles, csr6.raster_tiles_disc8,
                csr6.raster_tiles_disc8_uv, csr6.raster_tiles_rows9)

    # Phase 2: build from the checkout's sources.
    t0 = time.perf_counter()
    kernels.load("csr6_raster")
    print(f"[build] csr6_raster.cu (csr6_raster, csr6_disc8, csr6_disc8_uv, "
          f"csr6_rows9) {time.perf_counter() - t0:.1f} s", flush=True)
    for line in kernels.build_log("csr6_raster").splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "Compiling entry" in line):
            print(f"[build] {line.strip()}", flush=True)

    # Phase 3: kernel vs plain on seeded soups.
    default_big = csr6.DEFAULT_MAX_BIG
    max_err = dict.fromkeys(REPLACES, 0.0)
    shading = ShadingConfig()
    seeded = soups(dev)
    for name, soup in seeded.items():
        err = compare(soup, WIDTH, HEIGHT, csr6, default_big)["err"]
        max_err["csr6_raster"] = max(max_err["csr6_raster"], err)
        print(f"[kernel==plain] csr6_raster {name}: {soup.count} prims ok",
              flush=True)
    # The disc-row kernels on the same soups (their capsules ride the big
    # list; "mixed" is left to "invalid_nearclip", the same rows with
    # holes) and on a two-tone disc scene: exact ties, two wide discs.
    del seeded["mixed"]
    seeded["disc_ties_wide"] = disc_lane_soup(dev)
    cam = soup_camera(dev)
    for name, soup in seeded.items():
        _, flag = csr6.preshade(soup, cam, shading)
        res, b = compare_disc(soup, flag, WIDTH, HEIGHT, csr6, 1 << 16)
        for kernel, r in res.items():
            max_err[kernel] = max(max_err[kernel], r["err"])
        print(f"[kernel==plain] csr6_disc8, csr6_disc8_uv {name}: "
              f"{soup.count} prims, big list {int(b['big_count'])} ok",
              flush=True)
    # Phase 8 (a): the kind-split kernel at spans 2, 4 and 8 on the same
    # soups and on seeded traj_vel soups.
    seeded.update(droplet_soups(dev))
    for name, soup in seeded.items():
        for span in csr6.SPANS:
            res, b = compare_rows9(soup, WIDTH, HEIGHT, csr6, 1 << 16, span)
            max_err["csr6_rows9"] = max(max_err["csr6_rows9"], res["err"])
            print(f"[kernel==plain] csr6_rows9 span {span} {name}: "
                  f"{soup.count} prims, {int(b['starts'][-1])} binned, big "
                  f"list {int(b['big_count'])} ok", flush=True)
    del seeded
    preset = PRESETS["traj_ball"]
    pos, vel = flagship_cloud(20000, seed=7)
    pcl = normalize.transform_coordinates(normalize.standardize_point_cloud(
        np.concatenate([pos, vel], axis=1)), flip_x=preset.flip_x)
    cam = pipeline.frame_camera(preset, 120, WIDTH, HEIGHT, dev)
    small = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:],
                                      120)
    err = compare(small, WIDTH, HEIGHT, csr6, default_big)["err"]
    max_err["csr6_raster"] = max(max_err["csr6_raster"], err)
    print(f"[kernel==plain] traj_ball 20k frame 120: {small.count} prims ok",
          flush=True)

    # Phase 4: the soup built on the card equals the CPU build.
    for fi in FRAMES:
        built = []
        for d in (dev, torch.device("cpu")):
            c = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, d)
            built.append(convert.soup_to_numpy(pipeline.build_primitives(
                preset, c, pcl[:, :3], pcl[:, 3:], fi)))
        for field, arr in built[0].items():
            check(np.array_equal(arr.view(np.uint8),
                                 built[1][field].view(np.uint8)),
                  f"frame {fi}: soup field {field} differs CUDA vs CPU")
    print("[soup] CUDA == CPU bit for bit at frames 10, 120, 205", flush=True)

    # Phase 5: the main path through the CLI.
    n = 1_000_000
    pos, vel = flagship_cloud(n, seed=11)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        inp, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(inp)
        for k, fi in enumerate((10, 120, 199)):
            drift = (0.01 * k * vel).astype(np.float32)
            ply.write_ply(os.path.join(inp, f"frame_{fi:04d}_b0.ply"),
                          pos + drift, velocities=vel)
        for c in counters:
            c.launches = 0
        sink = traj_ball_renderer.main(
            ["--input-folder", inp, "--output-folder", out,
             "--frames", ",".join(map(str, FRAMES)), "--device", "cuda"])
        torch.cuda.synchronize()
        launches = csr6.raster_tiles.launches
        statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
        check(len(statuses) == 3 and all(s == "ok" for _, s, _ in statuses),
              f"frame records not all ok: {statuses}")
        for name in ("frame_0010_b0", "frame_0120_b0", "frame_0205_b0"):
            check(os.path.getsize(os.path.join(out, f"{name}.png")) > 1000,
                  f"{name}.png missing")
        check(launches >= 3, f"kernel launched {launches} times, want >= 3")
        for r in sink.records:
            t = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                         r.timings_s.items())
            print(f"[cli] frame {r.frame_index}: {r.points} points {t} "
                  f"({card})", flush=True)
        print(f"[cli] csr6_raster launches in the CLI run: {launches}",
              flush=True)

        # Phase 6: frame 205's big list overflows the default max_big and
        # a fresh pipeline self-heals it on the card; every frame's
        # certificate is 0 after self-heal.
        pipe = pipeline.FramePipeline(preset, device=dev)
        check(pipe.raster_config.max_big == default_big,
              f"FramePipeline's max_big is {pipe.raster_config.max_big}")
        clouds, big = {}, {}
        for fi, name in ((10, 10), (120, 120), (205, 199)):
            pcl = pipe.load_and_prepare(
                os.path.join(inp, f"frame_{name:04d}_b0.ply"))
            clouds[fi] = pcl
            cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
            soup = pipeline.build_primitives(preset, cam, pcl[:, :3],
                                             pcl[:, 3:], fi)
            big[fi] = int(csr6.bin_csr6(soup, WIDTH, HEIGHT)["big_count"])
            before = pipe.raster_config.max_big
            fb = pipe.render_array(pcl, fi)
            after = pipe.raster_config.max_big
            ovf = int(csr6.bin_diagnostics6(soup, WIDTH, HEIGHT, after))
            check(ovf == 0, f"frame {fi}: big list overflow {ovf}")
            check(fb.rgb.shape == (HEIGHT, WIDTH, 3)
                  and bool(torch.isfinite(fb.rgb).all())
                  and bool((fb.index >= 0).any()),
                  f"frame {fi} output malformed")
            print(f"[heal] frame {fi}: big list {big[fi]}, max_big {before} "
                  f"-> {after}, big_overflow 0 after self-heal", flush=True)
        check(big[205] > default_big,
              f"frame 205's big list ({big[205]}) fits max_big "
              f"{default_big}: the self-heal was not exercised")
        check(pipe.raster_config.max_big > default_big,
              "the pipeline did not self-heal")
        tail = {}
        for fi in range(200, 220):  # the fade tail, closest to the camera
            cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
            soup = pipeline.build_primitives(preset, cam, clouds[205][:, :3],
                                             clouds[205][:, 3:], fi)
            tail[fi] = int(csr6.bin_csr6(soup, WIDTH, HEIGHT)["big_count"])
        peak = max(tail, key=tail.get)
        clouds[peak] = clouds[205]
        print(f"[heal] big list over frames 200-219 (frame-199 cloud): min "
              f"{min(tail.values())}, max {tail[peak]} at frame {peak}",
              flush=True)

        # Warm frames, stages, a device trace, and the kernel beside its
        # plain version, at frames 120, 205 and the tail's peak (rendered
        # once first, so the pipeline self-heals for its big list).
        torch.cuda.synchronize()
        timed = {}
        for fi in dict.fromkeys((120, 205, peak)):
            if fi == peak:
                before = pipe.raster_config.max_big
                pipe.render_array(clouds[fi], fi)
                cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
                soup = pipeline.build_primitives(
                    preset, cam, clouds[fi][:, :3], clouds[fi][:, 3:], fi)
                ovf = int(csr6.bin_diagnostics6(
                    soup, WIDTH, HEIGHT, pipe.raster_config.max_big))
                check(ovf == 0, f"frame {fi}: big list overflow {ovf}")
                print(f"[heal] frame {fi}: big list {tail[fi]}, max_big "
                      f"{before} -> {pipe.raster_config.max_big}, "
                      "big_overflow 0 after self-heal", flush=True)
            max_big = pipe.raster_config.max_big
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                pipe.render_array(clouds[fi], fi)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            q1, med, q3 = statistics.quantiles(times, n=4)
            print(f"[time] frame {fi} render_array warm: median {med:.2f} "
                  f"ms, quartiles {q1:.2f}-{q3:.2f} ms over 5 frames ({n} "
                  f"points, max_big {max_big}) ({card})", flush=True)
            for stage, ms in stage_times(frame_stages(
                    pipeline, csr6, preset, clouds[fi], fi, dev,
                    max_big)).items():
                print(f"[stage] frame {fi} {stage}: {ms:.2f} ms ({card})",
                      flush=True)
            busy, wall, top, _ = device_profile(
                lambda fi=fi: pipe.render_array(clouds[fi], fi), 3, tmp)
            if top:
                print(f"[trace] frame {fi}, 3 warm frames: device busy "
                      f"{busy / 1e3:.2f} of {wall / 1e3:.2f} ms wall, idle "
                      f"share {1 - busy / wall:.3f} ({card})", flush=True)
                for name, us in top[:8]:
                    print(f"[trace] frame {fi} {us / 3e3:9.2f} ms/frame  "
                          f"{name[:90]}", flush=True)
            else:
                print(f"[trace] frame {fi}: the profiler saw no device "
                      "activity; device busy share not measured", flush=True)
            cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
            soup = pipeline.build_primitives(preset, cam, clouds[fi][:, :3],
                                             clouds[fi][:, 3:], fi)
            res = compare(soup, WIDTH, HEIGHT, csr6, max_big, timing=True)
            max_err["csr6_raster"] = max(max_err["csr6_raster"], res["err"])
            timed[fi] = res
            kernel_ms, plain_ms = res["ms"], res["plain_ms"]
            b = csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big)
            print(f"[time] frame {fi} shape: {n} points, {soup.count} prims, "
                  f"{int(b['starts'][-1])} binned, true_entries "
                  f"{int(b['diag']['true_entries'])}, big list "
                  f"{int(b['big_count'])}", flush=True)
            print(f"[time] csr6_raster kernel {kernel_ms:.3f} ms (median of "
                  f"11), plain {plain_ms:.1f} ms (median of 2), bound "
                  f"{res['bound_ms']:.3f} ms by {res['bound_by']} at the "
                  f"frame-{fi} shape ({card})", flush=True)
        del clouds, soup
        # Phase 8 (b): the traj_vel CLI on the same PLYs.
        droplet_cli(card, inp, os.path.join(tmp, "out_vel"), counters)
    # Phase 7: bench.py's disc lane and the flythrough loop.
    disc = disc_lane(card, dev, max_err)
    # Phase 8 (c): bench.py's droplet lane.
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        droplet = droplet_lane(card, dev, max_err, counters, tmp)
    numbers = dict(csr6_raster=dict(timed[120], launches=launches), **disc,
                   csr6_rows9=droplet)
    return dict(card=card, kernels=[dict(
        name=name, route="cuda", source=KERNEL_SOURCE,
        replaces=REPLACES[name], launches=numbers[name]["launches"],
        max_abs_err=max_err[name], ms=numbers[name]["ms"],
        plain_ms=numbers[name]["plain_ms"],
        bound_ms=numbers[name]["bound_ms"],
        bound_by=numbers[name]["bound_by"], library_ms=None)
        for name in REPLACES])


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        res = run()
    except (SmokeFailure, ImportError, RuntimeError, OSError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    import torch

    print(json.dumps({"kernels": res["kernels"]}))
    print(res["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
