#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pointcloud_render_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--parent DIR]

--parent DIR (a checkout of another commit, e.g. the parent) builds DIR's
csr2_raster.cu beside this tree's and times its csr1_raster (its C
interface before the split walk: one CTA per strip, synchronous staging)
with the exit on and off on the same inputs where this run times
csr1_raster, after holding it against the plain version.

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels (three sources, thirteen kernels) from csrc/ with
     nvcc, one nvcc per source (and per parent source under --parent),
     started together;
  3. hold the csr6 tile kernel against its plain PyTorch version on six
     seeded soups at 1920x1080 and one traj_ball frame (with its z-bucket
     exit off and on, its tiles cut into work items of csr6.SPLIT_ROWS and
     of 64 rows, walked every tile's rows with the exit off), both
     csr6_raster instances and csr6_cap10 on a seeded soup that forces
     splits and on the JAX package's cross-class exit case (the exit
     leaves the far discs' segment and the near disc wins), and the two
     disc-row kernels (csr6_disc8, csr6_disc8_uv) against theirs on the
     seeded soups, a disc scene with exact depth ties and two wide discs
     on the big list, and tests/torch_soups.band_soup (discs tangent to
     the cull's bands, centred on band boundaries, over a ragged bottom
     band, ties across work items) at spans 2, 4 and 8, their tiles cut
     into items of csr6.SPLIT_ROWS_DISC and of 64 rows (walked every
     tile's rows, the band-rows evaluated csr6.band_rows'), csr6_disc8 at
     span 2 also with the exit forced on: depth bits, winner index and
     the (u, v) bits with their +inf markers must be equal;
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
     of warm frames (device busy share and the top device kernels), the
     kernel with its exit on (the default, with the rows walked) and off
     beside its plain version and bounds, the tile rows and work items,
     and the frame with allow_exit=False equal to the default frame; at
     frame 120 bin_csr6 with the int32 exit key and the int16 key, and
     the walk by split_rows;
  7. the disc lane of bench.py (ground + 1M sphere splats of radius 0.002,
     discs_only, uniform_look, max_big 256): both disc kernels equal their
     plain versions on the 1M-point cloud at frames 0, 120 and 219 (as in
     phase 3), with the tile rows, work items and band-rows per frame; at
     frame 120 their times (CUDA events per call, and device_ms: calls
     back to back) beside the all-pairs bound, the bound over the pairs
     evaluated and the bytes' time, the split sweep (SPLIT_SWEEP_DISC),
     csr6_disc8 with the exit forced on (rows walked); the fused shade
     equals
     shade_by_id(uniform_look) bit for bit; then the
     220-frame flythrough through TrajectoryScanRenderer at 1920x1080 in
     chunks of 8: certificate 0 on every chunk, one csr6_disc8_uv launch
     per frame, frames equal to the fused walk's plain version (the scan's
     render swapped for render_shaded_csr6(plain=True)), frames/s, ms/frame,
     the stages of one warm frame and a trace of one warm chunk (device
     idle share, host synchronisations); 8 frames without uniform_look
     (csr6_disc8) and 8 advected traj_ball frames with trails
     (csr6_raster) show the loop drives those kernels too;
  8. the droplet slice: (a) the kind-split kernel csr6_rows9 against its
     plain version at spans 2, 4 and 8, its tiles cut into work items of
     csr6.SPLIT_ROWS and of SPLIT_FORCED rows, one launch a call, on
     seeded 1080p traj_vel soups (head discs, tapered tail capsules, trail
     capsules, exact depth ties, long capsules past each span, invalid
     rows) and on the seeded soups of phase 3; (b) the traj_vel CLI on
     phase 5's PLYs, frames 10, 120 and 205, default config (csr6_raster
     over the droplet soup); (c) the droplet lane of bench.py: 1M
     droplets with 4-segment velocity trails, span and max_big by
     bench.py's probe, the four-tone reps of
     frame 20 with their certificate, rows9: certificate 0 and one
     csr6_rows9 launch on each of the 12 frames, the kernel equal to its
     plain version and rows8 equal to rows9 at frames 20, 120 and 219,
     the four-tone shade beside the generic one, the kernel's time,
     plain time and bound at frame 120 with the tile rows per kind region
     and the work items, the split sweep, the stages of one warm frame, warm
     ms/frame,
     a trace of one warm frame, and 8 frames of the scan on the lane's
     config (one csr6_rows9 launch each);
  9. the mesh-LOD slice: (a) csr6_raster[bin_triangles] (binned triangles
     through the dual evaluation) and csr4_raster (the v4 split walk, with
     its z-bucket early exit on and off, its tiles cut into items of
     csr6.SPLIT_ROWS4 and of SPLIT_FORCED rows), each with and without
     bin_triangles, against
     their plain versions bit for bit on seeded 1080p mesh-LOD soups
     (3,000 droplets, 300 of them twice for exact ties, a dozen near the
     camera whose triangles ride the big list and whose near clip leaves
     invalid rows, the ground, 8-capsule trails) and on phase 3's soups,
     csr4_raster also on entries truncated by an entry_capacity below
     true_entries; (b) seeded 10,000-point PLYs through the traj_vel CLI
     with --droplet-lod mesh (frames 10, 120, 205: records ok, PNGs,
     csr6_raster[bin_triangles] launched), FramePipeline's auto frames
     equal to pallas4 + bin_triangles frames in depth bits, index and rgb
     at those frames, both kernels equal to their plain versions at frame
     120 with their times (csr6_raster[bin_triangles] with its exit on
     and off, the rows walked, the tile rows and work items), plain times
     and bounds, the allow_exit=False frame equal to the default frame at
     frame 120, the stages of one warm
     frame, warm ms/frame, a trace, and 8 scan frames (certificate 0, one
     launch each); (c) the traj_ball CLI with --backend pallas4 on phase
     5's 1M-point PLYs: its PNGs equal phase 5's (pallas6) byte for byte,
     FramePipeline's buffers equal at frames 120 and 205 (205 through the
     max_big self-heal), csr4_raster == plain (items of the default and
     of SPLIT_FORCED rows, exit on and off), its time per call and on the
     device and its bound with the exit on (the bound counts the entries
     its tiles' items walked before their exits, which the kernel
     reports) and off, its plain time, tile rows and work items, at frames
     120 and 205, the split sweep at frame 120, and a mesh-LOD soup of
     13,026 droplets (one past the 2^24-row id limit) must raise
     ValueError;
 10. the history-trail slice: (a) csr6_cap10 (the 10-float cap_rows10
     walk) at spans 2, 4 and 8 and csr6_raster at spans 4 and 8 against
     their plain versions on phase 3's soups, and the cap_rows10
     FramePipeline frames equal to the default walk's (rgb, depth, index)
     at phase 6's traj_ball frames 120 and 205; (b) the traj preset at
     700,000 points (15,400,004 rows): seeded PLYs of frames 0-23
     (positions uniform in [-0.5, 0.5)^3, velocities normal(0, 2), frame
     n = p0 + v * 0.002 * n) through the traj CLI (history preload,
     records ok, PNGs), cap_rows10 frames at spans 2 and 4 equal to the
     default walk's at frames 20, 21 and 23 (csr6_cap10 launched there),
     both kernels == plain and == each other at the frame's shape (span
     2, timed with their bounds, csr6_raster with its exit on and off,
     the tile rows and work items, both walks by split_rows; spans 4 and
     8 timed), the allow_exit=False frame equal to the default frame at
     frame 23, and at spans 2, 4
     and 8 on a 100,000-point traj soup, the warm frame, its stages and a
     trace, a 40-frame scan from frame 0 in chunks of 8 (the rolling
     history buffer fills during it; certificate 0, one csr6_raster
     launch per frame, a traced chunk synchronises once), and 762,601
     points raising the 2^24 ValueError; (c) the v3 disc fast path:
     csr3_raster (a split walk with a warp-band cull) with its exit on
     and off, its tiles cut into items of csr3.SPLIT_ROWS and of 64 rows,
     against its plain version (depth bits, entry image; walked every
     tile's run and bands csr3.band_rows3 with the exit off) on phase 3's
     disc scene with exact ties, its wide-disc soup and its capsule +
     triangle soup (big lists), on entries cut to 2/3 of true_entries,
     on the tests' band soup, dense tile, exact ties and 48 identical
     discs in one tile (items of 1, 7 and 64 rows; the first copy wins),
     and on bench.py's disc lane at frames 0, 120 and 219 (entry_capacity
     by bench.py:407-425's rule), pallas3 frames equal to pallas6 frames
     there; at frame 120 the kernel's time with its exit at five block
     sizes and without it, its device time, its bounds, the cull's kept
     share and the split sweep;
     the 220-frame pallas3 scan (certificate 0, one csr3_raster launch
     per frame, frames equal to the pallas6 scan's), and the example CLI
     with --backend pallas3 (PNGs byte-equal to pallas6's);
 11. the strip-tiled backends, one split walk: (a) csr1_raster (v1) and
     csr2_raster (v2, 16-float rows, each with and without
     no_triangles) and csr2_disc8 (v2's 8-float disc rows), each with
     its saturation exit on and off and its passes cut into work items
     of the default and of SPLIT_FORCED rows, against the plain strip
     walk bit for bit on phase 3's seeded soups
     and the disc scene with ties, on 1,500 wide discs (v1 at max_big
     2048 takes them all, v2 drops those past its 1024), on entries cut
     to 2/3 of true_entries, and on strips of 16x256 and 4x32;
     csr2_disc8 (with a warp cull) also with bands equal to
     csr.segment_rows with the exit off, and on the tests' band, segment
     (discs tangent to the warps' column boundaries), dense-tile and tie
     soups at strips of 8x128, 16x256 and 4x32 with items of 1, 7 and
     64 rows; csr1_raster on the tests' dense-tile, mixed, tie and
     tie_tile soups at strips of 8x128 and 16x256, no_triangles off and
     on, items of 1, 7 and 64 rows (tie_tile: 48 identical discs cut
     across items, id 0 wins); (b) the
     traj_ball CLI with --backend pallas on phase 5's PLYs at frames 10
     and 120 (records ok, PNGs byte-equal to phase 5's pallas6 PNGs, one
     csr2_raster launch per frame), frame 205 decided by v2's big list
     (the frame equals pallas6's, or FramePipeline raises the JAX
     package's RuntimeError after its retries: printed), csr2_raster and
     csr1_raster timed at frame 120 with their exits on and off, their
     plain time and bounds, and equal to each other, csr2_raster also at
     frame 205's shape, each time with its strip rows and work items and
     the split sweep, and under --parent the parent's one-CTA csr1_raster
     on the same inputs; (c) bench.py's disc lane through pallas
     (max_tiles_per_prim 4, no_triangles, discs_only, entry_capacity by
     bench.py:427-445's rule): csr2_disc8 == plain at frames 0, 120 and
     219 (as in (a)), pallas frames == pallas6 frames there; at frame
     120 its time with the exit on and off, device time, bounds, the
     cull's kept share and the split sweep; the 220-frame scan (certificate 0 on every chunk,
     one csr2_disc8 launch per frame, every u8 frame equal to the
     pallas6 scan's without uniform_look) and its frames/s;
 12. the v5 slice: bench.py's disc lane (1M gray splats of radius 0.002
     and the ground) put in Morton order by the port's spatial_sort
     (timed once per cloud), frames 0, 120, 199 and 219 at 1920x1080:
     per frame the chunk entries, singleton spills, big list and
     big_overflow (frame 120 must not overflow); the main path, the four
     frames through render_shaded_csr5(uniform_color=gray), one
     csr5_shaded launch each; every frame without overflow equal to the
     pallas6 frame of the same soup (depth bits, index) and its rgb to
     shade_framebuffer on its buffers bit for bit; rasterize_csr5 once
     (csr5_raster); csr5_raster and csr5_shaded (split walks with a warp
     cull) == their plain version bit for bit with their exits on and off
     and their tiles cut into items of csr6.SPLIT_ROWS5 and of
     SPLIT_FORCED rows (walked every tile's run and bands
     csr5.block_slots5 with the exit off) at frame 120 and on phase 3's
     soups in their own and in Morton order, timed at frame 120 per call
     and on the device with the superrows walked before the exits (the
     bound counts their live slots), the cull's kept share, the tile rows
     and work items and the split sweep; the stages of one warm frame
     and its ms; csr6_disc8 and
     csr6_disc8_uv at spans 4 and 8 == plain and timed on frame 120's
     soup as in phase 7, and their entry point
     render_shaded_csr6(discs_only, uniform_look) at each span: one
     csr6_disc8_uv launch, == its plain walk bit for bit;
 13. the fidelity certificate of the two geometry knobs (trail segments
     and rows9) at the JAX records' scene
     (benchmarks/results/fidelity_trail_segments.json: 6,000 points,
     480x270, frames 120 and 199, a 20-segment reference polyline, seed
     0): utils/fidelity.trail_segments_flip_rate on the card for
     traj_ball and traj_vel at segments 4, 8 and "adaptive" (the JAX
     records' "adaptive" and "adaptive+rows8"), exact (csr6_raster) and
     with the rows9 candidate at span 4 (csr6_rows9; candidate_diff: its
     pixels whose surface differs from the exact candidate's), each
     "[fidelity]" line beside the JAX record; the traj_vel flip
     decomposition at segments 4; both kernels launched in the phase.
     It fails on a trail_rate past max(0.005, rate(8) + 0.002) of its
     preset (benchmarks/pick_tuned.py's rule), or on a segments or rows9
     knob of tuned_defaults.json's trail (traj_ball) or droplet
     (traj_vel) section past that limit.
 14. the look passes (ROADMAP A13) on phase 5's PLYs: (a) the traj_ball
     CLI with --shadows --ground-spec 0.5 --gi 0.25 --supersample 2 at
     frames 10, 120 and 205 (the camera raster at 3840x2160, the shadow
     map at 1024x1024): records ok, PNGs written, csr6_raster launched
     and csr1_raster once per frame; (b) at frame 120 through
     FramePipeline at ss 1 and 2: the look frame's depth and index ==
     the plain frame's (at ss 2 the 3840x2160 render sliced [::2, ::2]),
     csr1_raster over the light view's capped strips
     (tiles.bin_primitives at 1,024 per 8x128 strip, 16 strips per prim,
     64 big prims) == the plain strip walk with its exit on and off at
     the default split and items of SPLIT_FORCED rows, the look rgb ==
     the same frame shaded over the plain walk's shadow map, the entries
     the caps drop (tiles.tile_overflow, mirrored from the JAX package);
     at ss 2, csr6_raster at 3840x2160 and span 4 == its plain version
     (items of csr6.SPLIT_ROWS and SPLIT_FORCED rows), and its depth and
     index == the span-2 3840x2160 frame's, which the look frame walks;
     (c) "[look]" lines: warm ms per look frame at ss 1 and 2 beside the
     plain frame at the same film, the look frame's stages (camera soup
     and raster, light-view soup build, capped binning, csr1_raster,
     shadow_factor, shade_framebuffer, downsample), the ss 2 frame at
     span 4 (== the span-2 frame; its big list and time), csr1_raster on the
     shadow map timed per call and on the device beside its plain version
     and its bound (the rows walked, OPS_* per pixel), and
     raster/alpha.composite_tiled at 1M splats and 1920x1080;
 15. the stream (ROADMAP A14; BASELINE.json config 5 as
     benchmarks/stream_10m.py runs it: camera (2, 2, 2) -> (0, 0, -0.05)
     at 3840x2160, 10M points uniform in [-0.5, 0.5)^3 from
     default_rng(0) in chunks of 1M, splat radius 0.0015) through
     parallel/streaming.StreamingRasterizer: (a) the disc scene
     (pallas6, discs_only, max_big 1024): one csr6_disc8 launch per
     chunk, the stream == the monolithic csr6.rasterize_csr6 render of
     the whole 10M-disc soup bit for bit (ids below 2^24), both disc
     kernels == plain on chunk 0's soup (timed); (b) the trail scene
     (discs + 4-segment velocity trails at frame 120, span 4, cap_rows10,
     max_big 20480): one csr6_cap10 launch per chunk, chunks 0-1 as a
     stream == the monolithic render of their concatenated 10M-row soup,
     csr6_cap10 == plain on chunk 0's soup (timed); (c) the v4 ("pallas")
     and capped "tiled" streams on the disc scene's first 2 chunks: v4 ==
     the pallas6 stream bit for bit, csr4_raster and csr1_raster over
     chunk 0's capped strips == plain, the entries the caps drop
     (mirrored from the JAX package); (d) a traj_vel droplet stream (1M
     points, chunks of 250,000, 1920x1080, default config: csr6_raster
     per chunk): chunk 0 alone == its monolithic render, the ground's
     winners from chunk 0 only; (e) "[stream]" lines for (a) and (b):
     warm ms per chunk end to end with the host generation apart, the
     device-side step on a resident chunk, points/s, the stages of a
     chunk, the device idle share of a traced stream, the host
     synchronisations torch flags (set_sync_debug_mode) in a 3-chunk
     stream (the chunk loop itself may make one: the certificate
     read-back), torch.cuda.max_memory_allocated;
 16. the sharded renders (ROADMAP A15) at traj_ball frame 120 on phase
     5's 1M-point cloud, 1920x1080: (a) a world of one rank in this
     process (NCCL where present, a HashStore): render_scene_point_sharded
     under pallas6, pallas4 and tiled (max_big 16384; tiled at the
     frame's largest strip count), one csr6_raster, csr4_raster and
     csr1_raster launch, each == FramePipeline's frame on its backend bit
     for bit (rgb, depth, index; tiled: where the capped walk's 64-prim
     big list overflows, == the capped single-device render instead);
     (b) two ranks sharing the card (spawned, gloo, the collectives
     copied through the host): the point-sharded pallas6 and pallas4
     frames == (a)'s, render_scene_batch_sharded of 4 frames on a (2, 1)
     and a (1, 2) mesh == each frame's FramePipeline frame; (c) the mesh
     stream on the two ranks: phase 15's disc scene cut to 2 chunks and
     its trail scene's chunk 0 == the one-rank stream bit for bit (depth,
     index, attributes); (d) "[sharded]" lines: warm ms per sharded
     frame beside FramePipeline's for world 1 and 2, the ms of the
     merge's four all-reduces, the mesh stream's ms per chunk;
 17. the adaptive velocity trails (trail_segments="adaptive") and the v6
     row_budget: bench.py's trail lane with --trail-segments adaptive
     (1M traj_ball points, positions uniform from seed 0, velocities
     normal(0, 2) from seed 1, 1920x1080, frames linspace(20, 219, 40),
     its tuned knobs rows9 and three_tone; span and max_big by
     bench.py's probe of 4 frames, row_budget by its rule
     ceil((1.1 x the largest binned prefix + 8,192) / 4,096) x 4,096),
     beside the same lane at segments 4: (a) at frames 120 and 219,
     csr6_raster (span 2, exit on and off; span 4), csr6_cap10 and
     csr6_rows9 (span 4) == plain bit for bit with each span's sized
     budget and with half the binned rows (row_overflow > 0, the cut
     frame differs), the lane's frame == the frame without a budget;
     csr6_disc8 on the disc lane's frame 120 with its binned count and
     half of it; (b) the main path, the 40 frames through
     build_primitives + render: one csr6_rows9 launch each, big_overflow
     and row_overflow 0 on every frame, the soup build without a host
     synchronisation (set_sync_debug_mode); (c) "[adaptive]" lines per
     frame (rows, binned rows, tile rows, big list, the share of trails
     at each k, beside segments 4), each kernel's time, plain time and
     bound at frame 120 at both, the lane loop's warm ms per frame in
     turns, the stages of a frame (the heuristic's projection and argmin
     apart) and the traced idle share; (d) traj_vel's droplet lane
     (1M droplets) at frames 20, 120 and 219 with adaptive trails:
     certificates 0, one csr6_rows9 launch each, csr6_rows9 == plain with
     the sized and the half budget at frame 120.
The last two lines are the card line and {"ok": true, "device": {...}};
before them a {"kernels": [...]} line with each kernel's numbers: launches
on its main path (csr1_raster's: rasterize_csr's, the look CLI's shadow
maps under shadow_launches), time beside its plain version and its
bound (the pairs the walk must evaluate times the float32 operations
per pair, over the card's float32 rate without multiply-add fusion; or its bytes over the
memory rate if that is larger); csr6_raster's (ms: the default walk,
with the exit), csr6_raster[bin_triangles]'s, csr4_raster's,
csr3_raster's and the strip kernels' and the v5 kernels' entries add
ms_exit_off and bound_ms_exit_off, the walk of every entry;
csr4_raster's (traj_ball frame 120) adds device_ms, device_ms_exit_off
and frame 205's walk (ms, device_ms, bound_ms, bound_by, ms_exit_off,
device_ms_exit_off, bound_ms_exit_off, each suffixed _frame205).  The
disc-row walks (csr6_disc8, csr6_disc8_uv, csr3_raster, csr2_disc8, the
v5 kernels) are bounded by the pairs their function needs, whatever the
walk: 32 pixels per (binned row or live slot, pixel row, 32-column
segment) that the exact test can cover (csr6.band_rows and
csr3.band_rows3 with bands of one row, csr.segment_rows with segments
of one row), plus every pixel x every live big row, or their bytes if
larger; with an exit, scaled by the share of rows walked (v5: over the
superrows walked).  Their entries add bound_ms_all_pairs (every pair of
the rows walked, the bound of their history) and bytes_ms; the culled
walks (csr6_disc8, csr6_disc8_uv, csr3_raster, csr2_disc8, the v5
kernels) add bound_ms_evaluated (the pairs their cull evaluates) and
device_ms (device_ms_exit_off for csr3_raster, csr2_disc8 and the v5
kernels); csr6_disc8 adds ms_exit and bound_ms_exit (the exit forced
on); under --parent csr1_raster adds parent_ms and parent_ms_exit_off
(the parent's one-CTA walk); csr1_raster also adds its shadow-map walk
at traj_ball frame 120 (phase 14) as shadow_launches, shadow_ms,
shadow_device_ms, shadow_plain_ms, shadow_bound_ms, shadow_bound_by,
shadow_ms_exit_off, shadow_bound_ms_exit_off, shadow_entries,
shadow_walked and shadow_dropped; the five kernels of phase 15 add
stream_launches (their launches in its streams: csr6_disc8 and
csr6_cap10 10, csr4_raster and csr1_raster 2, csr6_raster 4), and
csr6_disc8 and csr6_cap10 their walk of the stream's chunk 0 as
stream_ms, stream_plain_ms, stream_bound_ms and stream_bound_by
(csr6_disc8 also stream_device_ms).  The three kernels of phase 16 (a)
add sharded_launches (csr6_raster, csr4_raster and csr1_raster: 1
each).  Phase 17 adds adaptive_check_launches (csr6_raster, csr6_cap10,
csr6_rows9, csr6_disc8: the launches of its checks), csr6_rows9's
adaptive_launches (its main path), and for csr6_raster, csr6_cap10 and
csr6_rows9 at the adaptive lane's frame 120 adaptive_ms,
adaptive_plain_ms, adaptive_bound_ms, adaptive_bound_by,
adaptive_fixed4_ms and adaptive_fixed4_bound_ms (the same frame at
segments 4).  "[split]" lines time a split walk by
split_rows (SPLIT_SWEEP, SPLIT_SWEEP_DISC, SPLIT_SWEEP5).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
FRAMES = (10, 120, 205)
KERNEL_SOURCE = "pointcloud_render_tpu_torch/csrc/csr6_raster.cu"
STRIP_SOURCE = "pointcloud_render_tpu_torch/csrc/csr2_raster.cu"
REPLACES = {
    "csr6_raster": "pointcloud_render_tpu/raster/pallas_csr6.py:601",
    "csr6_disc8": "pointcloud_render_tpu/raster/pallas_csr6.py:268",
    "csr6_disc8_uv": "pointcloud_render_tpu/raster/pallas_csr6.py:505",
    "csr6_rows9": "pointcloud_render_tpu/raster/pallas_csr6.py:435",
    "csr6_raster[bin_triangles]":
        "pointcloud_render_tpu/raster/pallas_csr6.py:904",
    "csr4_raster": "pointcloud_render_tpu/raster/pallas_csr4.py:385",
    "csr6_cap10": "pointcloud_render_tpu/raster/pallas_csr6.py:298",
    "csr3_raster": "pointcloud_render_tpu/raster/pallas_csr3.py:254",
    "csr2_raster": "pointcloud_render_tpu/raster/pallas_csr2.py:100",
    "csr2_disc8": "pointcloud_render_tpu/raster/pallas_csr2.py:100",
    "csr1_raster": "pointcloud_render_tpu/raster/pallas_csr.py:88",
    "csr5_raster": "pointcloud_render_tpu/raster/pallas_csr5.py:281",
    "csr5_shaded": "pointcloud_render_tpu/raster/pallas_csr5.py:281",
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
#   v5 slot (csr5): as the disc row: dy, dy * dy, + dx2, <= r2 (dx2 and
#                 r * r are per slot and column; the strict < on depth
#                 only where covered; the row merge is per superrow)    4
OPS_CAPSULE16, OPS_TRIANGLE16, OPS_DISC8 = 17, 18, 4
OPS_DISC9, OPS_CAPSULE9 = 4, 16
OPS_DISC5 = 4
# bench.py's droplet lane (bench.py:624-659, :913, tuned_defaults.json
# "droplet"): 12 frames over linspace(20, 219), 4 capsules per trail.
DROPLET_POINTS = 1_000_000
DROPLET_FRAMES = 12
DROPLET_SEGMENTS = 4
# The mesh-LOD slice: a traj_vel frame holds the ground's 4 rows and 1,288
# per droplet (two near-clip blocks of the 640-face teardrop, 8 trail
# capsules); ids ride the rows as float32, so at most 13,025 droplets.
MESH_DROPLETS = 10_000
MESH_ROWS_PER_DROPLET = 1288
MESH_MAX_DROPLETS = ((1 << 24) - 4 - 1) // MESH_ROWS_PER_DROPLET
# The history-trail slice: a traj frame holds the ground's 4 rows and 22
# per point (head disc, tail capsule, 20 trail capsules), so at most
# 762,600 points; the slice runs 700,000 (15,400,004 rows), its seeded
# PLYs advected by TRAJ_DT per frame (the step of the advected scans
# above; scene/dynamics.py has no step of its own).
# bench.py's disc lane: 1M gray splats of radius 0.002 (bench.py:383-398).
DISC_POINTS = 1_000_000
TRAJ_POINTS = 700_000
TRAJ_ROWS_PER_POINT = 22
TRAJ_MAX_POINTS = ((1 << 24) - 4 - 1) // TRAJ_ROWS_PER_POINT
TRAJ_PLY_FRAMES = 24
TRAJ_DT = 0.002
TRAJ_SCAN_FRAMES = 40
# The v5 slice: bench.py's disc lane in Morton order, at the frames of
# bench.py's probe (:407-425).
V5_FRAMES = (0, 120, 199, 219)
V5_SOURCE = "pointcloud_render_tpu_torch/csrc/csr5_raster.cu"
# Entries the v3 kernel walks between two checks of its early exit: the
# blocks timed, and the one the port ships (csr3.EXIT_BLOCK).
V3_BLOCKS = (64, 128, 256, 512, 1024)
# The 16- and 10-float walks cut a tile into work items of at least
# csr6.SPLIT_ROWS rows; the checks below also cut them at SPLIT_FORCED
# rows (many items per tile, a split inside every range), and the sweep
# times the walk at SPLIT_SWEEP (the last: one item per tile).
SPLIT_FORCED = 64
SPLIT_SWEEP = (512, 1024, 2048, 4096, 8192, 1 << 30)
# --parent DIR: the parent commit's tree, whose csr2_raster.cu is built
# beside this one's and whose csr1_raster is timed on the same inputs.
PARENT = {"tree": None, "libs": {}}
# The fidelity certificate (phase 13): the JAX records' scene, the
# segment counts certified, and the rows9 candidate's span.
FIDELITY_RECORDS = "benchmarks/results/fidelity_trail_segments.json"
FIDELITY_SCENE = dict(n_points=6000, frames=(120, 199), width=480,
                      height=270, reference_segments=20, seed=0)
FIDELITY_SEGMENTS = (4, 8, "adaptive")
FIDELITY_SPAN = 4
# The tuned lanes whose geometry knobs the certificate holds, by preset.
FIDELITY_LANES = {"trail": "traj_ball", "droplet": "traj_vel"}
# The disc walks' split sweep (rows per work item; the last: one item per
# tile).
SPLIT_SWEEP_DISC = (256, 512, 1024, 2048, 4096, 8192, 1 << 30)
# The v5 walks' split sweep (rows, big and superrows of 16 slots, per work
# item; the last: one item per tile).
SPLIT_SWEEP5 = (32, 64, 128, 256, 512, 1024, 1 << 30)


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


def reset_counts(counters):
    """Set every kernel wrapper's launch count to 0."""
    for c in counters:
        c.launches = 0


def launch_counts(counters) -> dict:
    """{kernel wrapper: launches} of the kernels launched since the last
    reset."""
    return {c.__name__: c.launches for c in counters if c.launches}


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


def device_ms(fn, reps):
    """Device time of one call of ``fn``: CUDA events around ``reps``
    calls enqueued back to back behind a spin kernel (torch.cuda._sleep)
    that holds the device until the host has enqueued them all, so that no
    host gap falls between the events (checked: the host must finish
    enqueueing before the spin ends).  time_ms's events also count the
    host's time to enqueue a call while the device waits, which is of the
    order of a walk of a few tenths of a millisecond.  ``fn`` must not
    synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of SM clocks
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    marks[2].record()
    torch.cuda.synchronize()
    check(host_ms < marks[0].elapsed_time(marks[1]),
          f"device_ms: enqueueing {reps} calls took {host_ms:.1f} ms, past "
          "the spin: device time not measured")
    return marks[1].elapsed_time(marks[2]) / reps


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


def walk16_bound(soup, kinds, n_rows, big_ids, big_n, n_starts, width,
                 height, bin_triangles, row_bytes=64, walked=None):
    """(bound ms, "operations" | "bytes") of a 16-float walk (v6 or v4; or
    the 10-float cap_rows10 walk, ``row_bytes`` 40) whose tiles evaluate
    entries of prim kinds ``kinds`` (one per (tile, prim) pair; the v4
    entries, which the v6 class weights count too) at 1024 pixels each,
    18 operations for a triangle under ``bin_triangles`` (the dual) and
    17 otherwise, and every pixel x every live big row; bytes: ``n_rows``
    rows read once with their ids, the big rows, ``n_starts`` range
    bounds, two output images.  ``walked``: the entries the tiles
    evaluated before their exits (the v6 walk reports counts, not which:
    its triangles are taken in the share of all entries)."""
    n_tri = int((kinds == 2).sum()) if bin_triangles else 0
    n_ent = int(kinds.numel())
    if walked is not None:
        n_tri = n_tri * walked // max(n_ent, 1)
        n_ent = walked
    nb = int(big_n[0])
    nb_tri = int((soup.kind[big_ids[:nb].long()] == 2).sum())
    pixels = width * height
    ops = (1024 * (n_tri * OPS_TRIANGLE16 + (n_ent - n_tri) * OPS_CAPSULE16)
           + pixels * (nb_tri * OPS_TRIANGLE16
                       + (nb - nb_tri) * OPS_CAPSULE16))
    nbytes = (n_rows * (row_bytes + 4) + nb * (64 + 4) + n_starts * 4
              + pixels * 4 * 2)
    t_ops, t_bytes = ops / F32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def row_stats(rows, prefix="rows"):
    """{prefix_max, prefix_median, prefix_p99} of per-unit row counts."""
    import torch

    rows = rows.double()
    q = torch.quantile(rows, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                          device=rows.device))
    return {f"{prefix}_max": int(rows.max()), f"{prefix}_median": float(q[0]),
            f"{prefix}_p99": float(q[1])}


def plan_items(rows, big_n, split_rows=None):
    """(work items, rows per item) of the plan of csrc/split_walk.cuh's
    split_plan_kernel over units of ``rows`` binned rows each: a unit's
    big and binned rows in items of w = max(split_rows, ceil(rows / (3 U)))
    rows, at least one item per unit."""
    import torch

    from pointcloud_render_tpu_torch.raster import csr6

    total = rows.double() + big_n
    room = (csr6.ITEMS_PER_TILE - 1) * rows.numel()
    w = max(split_rows or csr6.SPLIT_ROWS, -(-int(total.sum()) // room))
    return int(torch.clamp(torch.ceil(total / w), min=1).sum()), w


def tile_stats(csr6, b, width, height, span, big_n, split_rows=None):
    """(max, median, p99) of the binned rows per tile and the work items
    the plan cuts (a tile's big and binned rows in items of
    max(split_rows, ceil(rows / (3 T))) rows)."""
    rows = csr6.tile_rows(b["starts"], width, height, span)
    items, w = plan_items(rows, big_n, split_rows)
    return dict(row_stats(rows), items=items, item_rows=w)


def stats_text(st, unit="tile"):
    return (f"{unit} rows max {st['rows_max']}, median "
            f"{st['rows_median']:.0f}, p99 {st['rows_p99']:.0f}; "
            f"{st['items']} work items of <= {st['item_rows']} rows")


def nvcc_build(kernels, src, out):
    """Build ``src`` with the port's nvcc flags into ``out`` and load
    it."""
    import ctypes

    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                           out, src], capture_output=True, text=True,
                          check=False)
    check(proc.returncode == 0, f"{src} does not build:\n"
          + proc.stderr[-2000:])
    return ctypes.CDLL(out)


def build_parent(kernels):
    """Under --parent, build the parent tree's csr2_raster.cu
    (PARENT["libs"]) beside this tree's build: its csr1_raster is timed on
    the same inputs as this tree's."""
    if PARENT["tree"] is None:
        return
    PARENT["libs"]["csr2_raster"] = nvcc_build(
        kernels, os.path.join(PARENT["tree"], STRIP_SOURCE),
        os.path.join(REPO, "build", "parent", "libcsr2_raster_parent.so"))


def c_call(lib, symbol, ptrs, ints, what):
    """``symbol`` of the ctypes library ``lib`` on the current stream:
    pointers (None: null), then ints, then the stream."""
    import ctypes

    import torch

    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    err = fn(*(None if t is None else t.data_ptr() for t in ptrs), *ints,
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"{what} failed to launch: {err}")


def parent_walk(ptrs, ints, width, height):
    """One call of the parent's csr1_raster before its split walk (one CTA
    per strip; C interface: rows, starts, big_rows, big_n, depth, index, a
    null walked, ints, stream) -> (depth, index)."""
    import torch

    dev = ptrs[0].device
    outs = [torch.empty((height, width), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32)]
    c_call(PARENT["libs"]["csr2_raster"], "csr1_raster", (*ptrs, *outs, None),
           ints, "the parent's csr1_raster")
    return tuple(outs)


def parent_time(ptrs, ints, width, height, want, what):
    """The parent's csr1_raster == ``want`` bit for bit, then its median
    time of 11 (None without --parent)."""
    import torch

    if not PARENT["libs"]:
        return None
    got = parent_walk(ptrs, ints, width, height)
    torch.cuda.synchronize()
    check_equal_bits(got, want, f"the parent's {what}")
    return time_ms(lambda: parent_walk(ptrs, ints, width, height), 11)


def compare(soup, width, height, csr6, csr4, max_big, bin_triangles=False,
            timing=False, span=2):
    """csr6_raster (with ``bin_triangles`` or without) vs its plain
    version on one soup binned at ``span`` -> (dict(err, ms, plain_ms,
    bound_ms, bound_by, ...), (depth, index)).  The kernel runs with its
    tiles cut at csr6.SPLIT_ROWS and at SPLIT_FORCED rows, at span 2 with
    the z-bucket exit off and on (the binning's exit keys), each equal to
    the plain version bit for bit; ``walked`` must be every tile's row
    count with the exit off and at most that with it on.  With
    ``timing``: ``ms`` and ``bound_ms`` of the exit-on walk (the default
    at span 2; its bound counts the rows the tiles evaluated),
    ``ms_exit_off`` and ``bound_ms_exit_off``, the tile rows and work
    items."""
    import torch

    exit_keys = span == 2
    b = csr6.bin_csr6(soup, width, height, max_big, span=span,
                      bin_triangles=bin_triangles, with_z=exit_keys)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    table = csr6.build_table16(soup, zeros, zeros[:, 0],
                               bin_triangles=bin_triangles)
    args = (table, b["order"], b["starts"], b["big_ids"], b["big_n"],
            width, height, bin_triangles, span)
    want = csr6.raster_tiles_plain(*args)
    torch.cuda.synchronize()
    rows = csr6.tile_rows(b["starts"], width, height, span)
    name = "csr6_raster" + ("[bin_triangles]" if bin_triangles else "") + (
        f" span {span}" if span != 2 else "")
    zmeta = b["zmeta"] if exit_keys else None
    out = dict(err=0.0)
    walked_on = got = None
    for z in (None, zmeta) if exit_keys else (None,):
        for split in (csr6.SPLIT_ROWS, SPLIT_FORCED):
            walked = torch.full_like(rows, -1)
            got = csr6.raster_tiles(*args, zmeta=z, walked=walked,
                                    split_rows=split)
            torch.cuda.synchronize()
            what = (f"{name} exit {'on' if z is not None else 'off'}, items "
                    f"of {split} rows")
            out["err"] = max(out["err"], check_equal_bits(got, want, what))
            if z is None:
                check(torch.equal(walked, rows),
                      f"{what}: walked is not every tile's rows")
            else:
                check(bool(((walked >= 0) & (walked <= rows)).all()),
                      f"{what}: walked outside [0, rows]")
                if split == csr6.SPLIT_ROWS:
                    walked_on = walked
    if timing:
        # The v4 entries are the span-2 tile rows, with their kinds.
        check(exit_keys, "compare times the walk at span 2 only")
        b4 = csr4.bin_csr4(soup, width, height, max_big, bin_triangles)
        n = int(b4["starts"][-1])
        check(n == int(rows.sum()), "v4 entries != v6 tile rows")
        kinds = soup.kind[b4["entries"][:n].long()]
        bound = dict(walked=None if walked_on is None
                     else int(walked_on.sum()))
        bound_off = walk16_bound(soup, kinds, int(b["starts"][-1]),
                                 b["big_ids"], b["big_n"],
                                 b["starts"].numel(), width, height,
                                 bin_triangles)
        bound_on = walk16_bound(soup, kinds, int(b["starts"][-1]),
                                b["big_ids"], b["big_n"],
                                b["starts"].numel(), width, height,
                                bin_triangles, walked=bound["walked"])
        ms_off = time_ms(lambda: csr6.raster_tiles(*args), 11)
        out.update(ms=ms_off, bound_ms=bound_off[0], bound_by=bound_off[1],
                   plain_ms=time_ms(lambda: csr6.raster_tiles_plain(*args),
                                    1),
                   entries=n,
                   **tile_stats(csr6, b, width, height, span,
                                int(b["big_n"][0])))
        if exit_keys:
            out.update(
                ms=time_ms(lambda: csr6.raster_tiles(*args, zmeta=zmeta), 11),
                bound_ms=bound_on[0], bound_by=bound_on[1], ms_exit_off=ms_off,
                bound_ms_exit_off=bound_off[0], walked=bound["walked"])
    return out, got


def print_v6_times(what, r, shape, card):
    """The [time] lines of compare's (or compare_cap10's) numbers."""
    line = (f"[time] {what} kernel {r['ms']:.3f} ms (median of 11), bound "
            f"{r['bound_ms']:.3f} ms by {r['bound_by']}")
    if "ms_exit_off" in r:
        line += (f" ({r['walked']} of {r['entries']} tile rows walked, "
                 f"{100.0 * r['walked'] / max(r['entries'], 1):.1f}%); exit "
                 f"off {r['ms_exit_off']:.3f} ms, bound "
                 f"{r['bound_ms_exit_off']:.3f} ms")
    line += f"; plain {r['plain_ms']:.1f} ms, at the {shape} shape ({card})"
    print(line, flush=True)
    print(f"[time] {what} at the {shape} shape: {stats_text(r)}", flush=True)


def split_sweep(what, fn, card, rows=None, sweep=SPLIT_SWEEP,
                timer=time_ms):
    """Time ``fn(split_rows, walked)`` at each of ``sweep`` (5 calls by
    ``timer``); one [split] line, with the share of ``rows`` (the
    tiles' binned rows) walked when given."""
    import torch

    parts = []
    for w in sweep:
        part = (f"{w if w < 1 << 30 else 'one item per tile'}: "
                f"{timer(lambda w=w: fn(w, None), 5):.3f}")
        if rows is not None:
            walked = torch.zeros_like(rows)
            fn(w, walked)
            part += (f" ({100.0 * int(walked.sum()) / int(rows.sum()):.1f}%"
                     " walked)")
        parts.append(part)
    print(f"[split] {what}, ms by split_rows (5 calls): "
          + ", ".join(parts) + f" ({card})", flush=True)


def compare_v4(soup, width, height, csr6, csr4, max_big, bin_triangles,
               cap=None, timing=False, card="", sweep=False, what=""):
    """csr4_raster vs its plain version on one soup (entries past ``cap``
    dropped), its tiles cut into items of csr6.SPLIT_ROWS4 and of
    SPLIT_FORCED rows, each with its z-bucket exit on and off (the plain
    version has none) -> (dict(err[, timing keys]), (depth, index) of the
    default walk); ``walked`` every tile's entries with the exit off, at
    most those with it on.  With ``timing``: ``ms`` / ``device_ms`` and
    ``bound_ms`` are the exit-on walk's (the bound counts the entries the
    tiles' items evaluated before their exits, as the kernel reports
    them; triangles under ``bin_triangles`` in the share of all entries),
    ``ms_exit_off`` / ``device_ms_exit_off`` and ``bound_ms_exit_off``
    the walk of every entry, the tile rows and work items; with ``sweep``
    the split sweep."""
    import torch

    b = csr4.bin_csr4(soup, width, height, max_big, bin_triangles)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    entries, starts = b["entries"], b["starts"]
    if cap is not None:
        entries, starts = entries[:cap], torch.clamp(starts, max=cap)
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    table = csr6.build_table16(soup, zeros, zeros[:, 0],
                               bin_triangles=bin_triangles)
    args = (table, entries, starts, b["big_ids"], b["big_n"], b["zmeta"],
            width, height, b["zq_bits"], bin_triangles)
    off = args[:8] + (0, bin_triangles)
    if width == WIDTH:
        check(b["zq_bits"] == 4, f"zq_bits {b['zq_bits']} at 1080p, want 4")
    want = csr4.raster_tiles4_plain(*args)
    torch.cuda.synchronize()
    what = ("csr4_raster" + (" bin_triangles" if bin_triangles else "")
            + (f" {what}" if what else "")
            + (f" entry_capacity {cap}" if cap is not None else ""))
    lengths = starts[1:] - starts[:-1]
    errs, got = [], None
    for split in (csr6.SPLIT_ROWS4, SPLIT_FORCED):
        for a, exit_on in ((args, True), (off, False)):
            walked = torch.full_like(lengths, -1)
            out = csr4.raster_tiles4(*a, walked=walked, split_rows=split)
            torch.cuda.synchronize()
            on = (f"{what} exit {'on' if exit_on else 'off'}, items of "
                  f"{split} rows")
            errs.append(check_equal_bits(out, want, on))
            check(bool(((walked >= 0) & (walked <= lengths)).all()) and (
                exit_on or torch.equal(walked, lengths)),
                f"{on}: walked {int(walked.sum())} of {int(lengths.sum())} "
                "entries")
            got = got or out
    out = dict(err=max(errs))
    if timing:
        n = int(starts[-1])
        walked = torch.empty_like(lengths)
        csr4.raster_tiles4(*args, walked=walked)
        n_walked = int(walked.sum())
        kinds = soup.kind[entries[:n].long()]
        bounds = [walk16_bound(soup, kinds, rows, b["big_ids"], b["big_n"],
                               starts.numel(), width, height, bin_triangles,
                               walked=rows)
                  for rows in (n_walked, n)]
        out.update(ms=time_ms(lambda: csr4.raster_tiles4(*args), 11),
                   device_ms=device_ms(lambda: csr4.raster_tiles4(*args), 11),
                   ms_exit_off=time_ms(lambda: csr4.raster_tiles4(*off), 11),
                   device_ms_exit_off=device_ms(
                       lambda: csr4.raster_tiles4(*off), 11),
                   plain_ms=time_ms(lambda: csr4.raster_tiles4_plain(*args),
                                    1),
                   bound_ms=bounds[0][0], bound_by=bounds[0][1],
                   bound_ms_exit_off=bounds[1][0], entries=n,
                   walked=n_walked,
                   **tile_stats_runs(lengths, b["big_n"], csr6.SPLIT_ROWS4))
    if sweep:
        split_sweep(f"{what} exit off", lambda w, wk: csr4.raster_tiles4(
            *off, split_rows=w, walked=wk), card)
        split_sweep(f"{what} exit on", lambda w, wk: csr4.raster_tiles4(
            *args, split_rows=w, walked=wk), card, lengths)
    return out, got


def print_v4_times(what, r, shape, card):
    """The [time] lines of compare_v4's numbers."""
    print(f"[time] {what} kernel {r['ms']:.3f} ms (median of 11; device "
          f"{r['device_ms']:.3f}), bound {r['bound_ms']:.3f} ms by "
          f"{r['bound_by']} ({r['walked']} of {r['entries']} tile entries "
          f"walked before the exits, "
          f"{100.0 * r['walked'] / max(r['entries'], 1):.1f}%); exit off "
          f"{r['ms_exit_off']:.3f} ms (device {r['device_ms_exit_off']:.3f}"
          f"), bound {r['bound_ms_exit_off']:.3f} ms; plain "
          f"{r['plain_ms']:.1f} ms, at the {shape} shape ({card})",
          flush=True)
    print(f"[time] {what} at the {shape} shape: {stats_text(r)}", flush=True)


def disc_bounds(b, soup, width, height, images, span, bands, pixel_rows):
    """(all-pairs ms, needed-pairs ms, evaluated-pairs ms, bytes ms) of a
    disc walk on this soup: the least time for every (binned row, tile
    pixel) pair and every pixel x every live big row (walk_bound's count,
    the bound of the rows' history); for the pairs the function needs
    (``pixel_rows`` (binned row, pixel row) pairs that pass the exact dy
    test, csr6.band_rows with bands of one row, of 32 pixels each at
    OPS_DISC8, plus the big-list pairs, which no test can skip); for the
    pairs the walk evaluates (``bands`` band-rows of 32 x BAND_ROWS
    pixels, plus the same big-list pairs); and for its bytes (every
    binned row read once, 32 B in sorted order, the big rows, the range
    starts, ``images`` images written)."""
    from pointcloud_render_tpu_torch.raster import csr6

    all_pairs = walk_bound(b, soup, width, height, 32, OPS_DISC8, images,
                           span, id_bytes=0)[0]
    nb = int(b["big_n"][0])
    n_tri = int((soup.kind[b["big_ids"][:nb].long()] == 2).sum())
    pixels = width * height
    big_ops = pixels * (n_tri * OPS_TRIANGLE16
                        + (nb - n_tri) * OPS_CAPSULE16)
    needed = pixel_rows * 32 * OPS_DISC8 + big_ops
    evaluated = bands * 32 * csr6.BAND_ROWS * OPS_DISC8 + big_ops
    nbytes = (int(b["starts"][-1]) * 32 + nb * (64 + 4)
              + b["starts"].numel() * 4 + pixels * 4 * images)
    return (all_pairs, needed / F32_OPS_PER_S * 1e3,
            evaluated / F32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3)


# Phase 15: BASELINE.json config 5 as benchmarks/stream_10m.py runs it.
STREAM_FILM = (3840, 2160)  # stream_10m.py:50-52
STREAM_POINTS = 10_000_000
STREAM_CHUNK = 1_000_000
STREAM_RADIUS = 0.0015
STREAM_TRAIL_RADIUS = 0.0007
STREAM_SEGMENTS = 4
STREAM_TRAIL_MAX_BIG = 20480
# (c): the v4 and tiled streams on the disc scene's first chunks.
STREAM_SHORT_CHUNKS = 2
# (d): a traj_vel droplet stream at 1080p.
STREAM_DROPLETS = 1_000_000
STREAM_DROPLET_CHUNK = 250_000
# The stream's kernels: their launches in phase 15 under stream_, and
# csr6_disc8's and csr6_cap10's walk of chunk 0's soup.
STREAM_KEYS = ("launches", "ms", "device_ms", "plain_ms", "bound_ms",
               "bound_by")

# Keys of the kernels line beyond the contract's, where a kernel has them:
# the exit-off walk of the walks with an exit; the disc-row walks' bound
# over every pair (the bound of their history) and over the pairs their
# cull evaluates, bytes' time, device time (exit on and off), forced exit
# and the parent's time (exit on and off).
# csr4_raster also gives frame 205's walk (FRAME205_KEYS, suffixed
# _frame205).
FRAME205_KEYS = ("ms", "device_ms", "bound_ms", "bound_by", "ms_exit_off",
                 "device_ms_exit_off", "bound_ms_exit_off")
# Phase 14: the look passes on the traj_ball CLI.
LOOK_FLAGS = ("--shadows", "--ground-spec", "0.5", "--gi", "0.25",
              "--supersample", "2")
# csr1_raster's shadow-map walk (phase 14), under shadow_ in its entry.
SHADOW_KEYS = ("launches", "ms", "device_ms", "plain_ms", "bound_ms",
               "bound_by", "ms_exit_off", "bound_ms_exit_off", "entries",
               "walked", "dropped")
# Phase 17 (the adaptive trail lane), under adaptive_: the launches of its
# checks (rows 1, 1c, 1e, 1f), csr6_rows9's on its main path, and rows 1,
# 1e and 1f on its frame 120 beside the same frame at segments 4.
ADAPTIVE_KEYS = ("check_launches", "launches", "ms", "plain_ms", "bound_ms",
                 "bound_by", "fixed4_ms", "fixed4_bound_ms")
EXTRA_KEYS = ("ms_exit_off", "bound_ms_exit_off", "bound_ms_all_pairs",
              "bound_ms_evaluated", "bytes_ms", "device_ms",
              "device_ms_exit_off", "ms_exit", "bound_ms_exit", "parent_ms",
              "parent_ms_exit_off",
              *(f"{k}_frame205" for k in FRAME205_KEYS),
              *(f"shadow_{k}" for k in SHADOW_KEYS),
              *(f"stream_{k}" for k in STREAM_KEYS), "sharded_launches",
              *(f"adaptive_{k}" for k in ADAPTIVE_KEYS))

# Phase 16: the sharded renders (ROADMAP A15) at traj_ball frame 120 on
# phase 5's 1M-point cloud, 1920x1080.  Each backend's kernel wrapper, and
# its kernel in the kernels line.
SHARDED_FRAME = 120
SHARDED_BACKENDS = {"pallas6": "raster_tiles", "pallas4": "raster_tiles4",
                    "tiled": "raster_tiles1"}
SHARDED_KERNELS = {"raster_tiles": "csr6_raster",
                   "raster_tiles4": "csr4_raster",
                   "raster_tiles1": "csr1_raster"}
# The big list of every sharded walk: frame 120's v6 list holds 3,769
# prims at span 2, past the default 1024 that FramePipeline heals.
SHARDED_MAX_BIG = 1 << 14
SHARDED_RANKS = 2  # the ranks sharing the one card (gloo)
SHARDED_BATCH = (10, 60, 120, 180)  # the batch's frame indices
SHARDED_REPS = 3
SHARDED_TIMEOUT_S = 300


def compare_disc(soup, flag, width, height, csr6, max_big, timing=False,
                 span=2, card="", sweep=False):
    """csr6_disc8 and csr6_disc8_uv vs their plain versions on one soup
    binned at ``span`` -> ({kernel name: dict(err, ...)}, binning).  Both
    kernels run with their tiles cut at csr6.SPLIT_ROWS_DISC and at
    SPLIT_FORCED rows, each equal to its plain version bit for bit (depth,
    index, (u, v)), ``walked`` every tile's rows and ``bands`` the
    band-rows csr6.band_rows counts; at span 2 csr6_disc8 also with the
    exit forced on (the exit binning's keys), ``walked`` within every
    tile's rows.  ``flag`` is preshade's disc flag (lane 5 of the disc
    rows, lane 13 of the big rows), which the (u, v) walk multiplies by.
    With ``timing``: ms (the default walk), plain_ms, bound_ms (the larger
    of the needed pairs' and the bytes' time, disc_bounds), the bound
    over the pairs the cull evaluates, the all-pairs bound, the tile rows
    and work items, the band-rows and needed pixel rows, the device time
    (device_ms), and at span 2 csr6_disc8 with the exit forced on; with
    ``sweep`` the split sweep of both kernels."""
    import torch

    zeros = torch.zeros((soup.count, 3), device=soup.device)

    def inputs(with_z):
        b = csr6.bin_csr6(soup, width, height, max_big, discs_only=True,
                          span=span, with_z=with_z)
        check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
        return b, (csr6.build_rows8(soup, flag, b["order"]),
                   csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
                   b["starts"], b["big_n"], width, height, span)

    b, args = inputs(False)
    rows = csr6.tile_rows(b["starts"], width, height, span)
    kept = csr6.band_rows(args[0], b["starts"], width, height, span)
    kernels = {"csr6_disc8": (csr6.raster_tiles_disc8,
                              csr6.raster_tiles_disc8_plain, 2),
               "csr6_disc8_uv": (csr6.raster_tiles_disc8_uv,
                                 csr6.raster_tiles_disc8_uv_plain, 4)}
    out = {}
    for name, (kernel, plain, _) in kernels.items():
        want = plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for split in (csr6.SPLIT_ROWS_DISC, SPLIT_FORCED):
            walked = torch.full_like(rows, -1)
            bands = torch.full_like(rows, -1)
            got = kernel(*args, walked=walked, bands=bands, split_rows=split)
            torch.cuda.synchronize()
            what = f"{name} span {span}, items of {split} rows"
            err = max(err, check_equal_bits(got, want, what))
            check(torch.equal(walked, rows),
                  f"{what}: walked is not every tile's rows")
            check(torch.equal(bands, kept),
                  f"{what}: the band-rows evaluated differ from band_rows")
        out[name] = dict(err=err)
    exit_run = None
    if span == 2:
        # The exit forced on: the exit binning's keys and zmeta.
        bz, zargs = inputs(True)
        zwant = csr6.raster_tiles_disc8_plain(*zargs)
        kept_z = csr6.band_rows(zargs[0], bz["starts"], width, height, span)
        for split in (csr6.SPLIT_ROWS_DISC, SPLIT_FORCED):
            walked = torch.full_like(rows, -1)
            bands = torch.full_like(rows, -1)
            got = csr6.raster_tiles_disc8(*zargs, zmeta=bz["zmeta"],
                                          walked=walked, bands=bands,
                                          split_rows=split)
            torch.cuda.synchronize()
            what = f"csr6_disc8 exit on, items of {split} rows"
            out["csr6_disc8"]["err"] = max(out["csr6_disc8"]["err"],
                                           check_equal_bits(got, zwant, what))
            check(bool(((walked >= 0) & (walked <= rows)).all()),
                  f"{what}: walked outside [0, rows]")
            check(bool(((bands >= 0) & (bands <= kept_z)).all()),
                  f"{what}: band-rows outside [0, band_rows]")
            if split == csr6.SPLIT_ROWS_DISC:
                exit_run = (zargs, bz, int(walked.sum()), int(bands.sum()))
    if not timing:
        return out, b
    n_rows = int(rows.sum())
    pixel_rows = int(csr6.band_rows(args[0], b["starts"], width, height,
                                    span, band=1).sum())
    for name, (kernel, plain, images) in kernels.items():
        all_pairs, t_need, t_eval, t_bytes = disc_bounds(
            b, soup, width, height, images, span, int(kept.sum()),
            pixel_rows)
        r = out[name]
        r.update(ms=time_ms(lambda k=kernel: k(*args), 11),
                 plain_ms=time_ms(lambda f=plain: f(*args), 2),
                 bound_ms=max(t_need, t_bytes),
                 bound_by="operations" if t_need >= t_bytes else "bytes",
                 bound_ms_all_pairs=all_pairs, bound_ms_evaluated=t_eval,
                 bytes_ms=t_bytes, entries=n_rows, bands=int(kept.sum()),
                 pixel_rows=pixel_rows,
                 **tile_stats(csr6, b, width, height, span,
                              int(b["big_n"][0]), csr6.SPLIT_ROWS_DISC))
        r["device_ms"] = device_ms(lambda k=kernel: k(*args), 11)
        if sweep:
            split_sweep(f"{name} span {span}, device time",
                        lambda w, wk, k=kernel: k(*args, split_rows=w), card,
                        sweep=SPLIT_SWEEP_DISC, timer=device_ms)
    if exit_run is not None:
        # The pairs the exit walk needs: those of the rows it walked, taken
        # as the walked share of every row's (the exit skips whole rows).
        zargs, bz, walked, bands = exit_run
        z_rows = int(csr6.band_rows(zargs[0], bz["starts"], width, height,
                                    span, band=1).sum())
        _, t_need, _, t_bytes = disc_bounds(
            bz, soup, width, height, 2, span, bands,
            z_rows * walked / max(n_rows, 1))
        out["csr6_disc8"].update(
            ms_exit=time_ms(lambda: csr6.raster_tiles_disc8(
                *zargs, zmeta=bz["zmeta"]), 11),
            device_ms_exit=device_ms(lambda: csr6.raster_tiles_disc8(
                *zargs, zmeta=bz["zmeta"]), 11),
            bound_ms_exit=max(t_need, t_bytes), walked=walked,
            bands_exit=bands)
    return out, b


def print_disc_times(name, r, shape, card):
    """The [time] lines of compare_disc's numbers for one kernel."""
    print(f"[time] {name} kernel {r['ms']:.3f} ms (median of 11), bound "
          f"{r['bound_ms']:.3f} ms by {r['bound_by']} (the pairs needed or "
          f"the bytes {r['bytes_ms']:.3f} ms), bound over the pairs the "
          f"cull evaluates {r['bound_ms_evaluated']:.3f} ms, all-pairs bound "
          f"{r['bound_ms_all_pairs']:.3f} ms; plain "
          f"{r['plain_ms']:.1f} ms (median of 2), at the {shape} shape "
          f"({card})", flush=True)
    print(f"[time] {name} at the {shape} shape: {stats_text(r)}; band-rows "
          f"evaluated {r['bands']} of {8 * r['entries']} "
          f"({100.0 * r['bands'] / max(8 * r['entries'], 1):.1f}% of the "
          f"pairs), pixel rows needed {r['pixel_rows']} of "
          f"{32 * r['entries']} "
          f"({100.0 * r['pixel_rows'] / max(32 * r['entries'], 1):.1f}%); "
          f"device time {r['device_ms']:.3f} ms (11 calls back to "
          f"back) ({card})", flush=True)
    if "ms_exit" in r:
        print(f"[time] {name} exit forced on at the {shape} shape: "
              f"{r['ms_exit']:.3f} ms (device {r['device_ms_exit']:.3f}), "
              f"bound {r['bound_ms_exit']:.3f} ms, "
              f"{r['walked']} of {r['entries']} tile rows walked "
              f"({100.0 * r['walked'] / max(r['entries'], 1):.1f}%), "
              f"band-rows {r['bands_exit']} ({card})", flush=True)


def compare_rows9(soup, width, height, csr6, max_big, span, timing=False,
                  card=""):
    """csr6_rows9 vs its plain version on one soup at ``span``, its tiles
    cut at csr6.SPLIT_ROWS and at SPLIT_FORCED rows, one launch a call ->
    (dict(err, and with ``timing`` ms, plain_ms, bound_ms, bound_by, the
    tile rows per kind region and the work items), binning).  ``timing``
    also sweeps split_rows."""
    import torch

    b = csr6.bin_csr6(soup, width, height, max_big, span=span,
                      kind_split=True)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    args = (csr6.build_table9(soup, b["order"], b["starts"][-1]),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], width, height, span)
    want = csr6.raster_tiles_rows9_plain(*args)
    torch.cuda.synchronize()
    out = dict(err=0.0)
    for split in (csr6.SPLIT_ROWS, SPLIT_FORCED):
        before = csr6.raster_tiles_rows9.launches
        got = csr6.raster_tiles_rows9(*args, split_rows=split)
        torch.cuda.synchronize()
        what = f"csr6_rows9 span {span}, items of {split} rows"
        check(csr6.raster_tiles_rows9.launches == before + 1,
              f"{what}: not one launch")
        out["err"] = max(out["err"], check_equal_bits(got, want, what))
    if timing:
        bound_ms, bound_by = walk_bound(b, soup, width, height, 36,
                                        (OPS_DISC9, OPS_CAPSULE9), 2,
                                        span=span, id_bytes=0)
        # Each kind region's tile rows, and the plan over their sum.
        k2t = span * span * csr6.grid_shape(width, height)[0] * \
            csr6.grid_shape(width, height)[1]
        regions = [csr6.tile_rows(st, width, height, span)
                   for st in (b["starts"][:k2t + 1], b["starts"][k2t:])]
        items, w = plan_items(regions[0] + regions[1], int(b["big_n"][0]))
        out.update(ms=time_ms(lambda: csr6.raster_tiles_rows9(*args), 11),
                   plain_ms=time_ms(
                       lambda: csr6.raster_tiles_rows9_plain(*args), 1),
                   bound_ms=bound_ms, bound_by=bound_by, items=items,
                   item_rows=w, **row_stats(regions[0], "disc_rows"),
                   **row_stats(regions[1], "capsule_rows"),
                   **row_stats(regions[0] + regions[1]))
        split_sweep(f"csr6_rows9 span {span}",
                    lambda w, wk: csr6.raster_tiles_rows9(
                        *args, split_rows=w), card)
    return out, b


def compare_cap10(soup, width, height, csr6, max_big, span, timing=False):
    """csr6_cap10 vs its plain version on one soup at ``span``, its tiles
    cut at csr6.SPLIT_ROWS and at SPLIT_FORCED rows, ``walked`` every
    tile's rows -> (dict(err, binned, big, entries, and with ``timing``
    ms, plain_ms, bound_ms, bound_by, the tile rows and work items),
    (depth, index)); the bound counts 17 operations per capsule pair, as
    row 1's, and 40-byte rows."""
    import torch

    b = csr6.bin_csr6(soup, width, height, max_big, span=span)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    args = (csr6.build_table10(soup),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["order"], b["starts"], b["big_n"], width, height, span)
    want = csr6.raster_tiles_cap10_plain(*args)
    torch.cuda.synchronize()
    rows = csr6.tile_rows(b["starts"], width, height, span)
    out = dict(err=0.0, binned=int(b["starts"][-1]),
               big=int(b["big_count"]),
               entries=int(b["diag"]["true_entries"]))
    for split in (csr6.SPLIT_ROWS, SPLIT_FORCED):
        walked = torch.full_like(rows, -1)
        got = csr6.raster_tiles_cap10(*args, walked=walked, split_rows=split)
        torch.cuda.synchronize()
        what = f"csr6_cap10 span {span}, items of {split} rows"
        out["err"] = max(out["err"], check_equal_bits(got, want, what))
        check(torch.equal(walked, rows), f"{what}: walked is not every "
              "tile's rows")
    if timing:
        bound_ms, bound_by = walk_bound(b, soup, width, height, 40,
                                        OPS_CAPSULE16, 2, span=span)
        out.update(ms=time_ms(lambda: csr6.raster_tiles_cap10(*args), 11),
                   plain_ms=time_ms(
                       lambda: csr6.raster_tiles_cap10_plain(*args), 1),
                   bound_ms=bound_ms, bound_by=bound_by,
                   **tile_stats(csr6, b, width, height, span,
                                int(b["big_n"][0])))
    return out, got


def v3_bound(soup, b, entries_walked, width, height):
    """(bound ms, "operations" | "bytes") of every pair of the v3 walk
    (the bound of its history, bound_ms_all_pairs): 1024 pixels x the
    entries walked at OPS_DISC8 operations, every pixel x every live big
    row (18 operations for a triangle, 17 otherwise); bytes: the 16 bytes
    of each walked entry row the walk reads, the big rows, the starts,
    two output images."""
    nb = int(b["big_n"][0])
    n_tri = int((soup.kind[b["big_ids"][:nb].long()] == 2).sum())
    pixels = width * height
    ops = (1024 * entries_walked * OPS_DISC8
           + pixels * (n_tri * OPS_TRIANGLE16 + (nb - n_tri) * OPS_CAPSULE16))
    nbytes = (entries_walked * 16 + nb * 64 + b["starts"].numel() * 4
              + pixels * 4 * 2)
    t_ops, t_bytes = ops / F32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def big_ops(soup, big_ids, big_n, width, height):
    """float32 operations of every pixel x every live big row (18 for a
    triangle through the dual, 17 otherwise)."""
    nb = int(big_n[0])
    n_tri = int((soup.kind[big_ids[:nb].long()] == 2).sum())
    return width * height * (n_tri * OPS_TRIANGLE16
                             + (nb - n_tri) * OPS_CAPSULE16)


def floor_bound(pixel_rows, big, nbytes):
    """(bound ms, "operations" | "bytes", bytes ms) of a disc-row walk by
    the pairs its function needs: ``pixel_rows`` (binned row, pixel row,
    32-column segment) triples that the exact test can cover, 32 pixels
    each at OPS_DISC8, plus ``big`` big-list operations, which no test
    can skip; or ``nbytes`` over the memory rate where that is larger."""
    t_ops = (pixel_rows * 32 * OPS_DISC8 + big) / F32_OPS_PER_S * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_bytes)


def compare_v3(soup, width, height, csr3, csr6, cap=None, timing=False,
               what="", splits=None, card="", sweep=False):
    """csr3_raster with its exit on and off vs its plain version (which
    never exits) on one soup, entries past ``cap`` dropped, its tiles cut
    into items of csr3.SPLIT_ROWS and of SPLIT_FORCED rows (or of each of
    ``splits``) -> (dict(err, and with ``timing``: ms, ms_exit_off,
    plain_ms, device_ms, device_ms_exit_off, bound_ms, bound_ms_exit_off,
    bound_by, bound_ms_all_pairs, bound_ms_evaluated, bytes_ms, entries,
    walked, bands, pixel_rows, blocks), binning).  ``walked`` is every tile's run and ``bands``
    csr3.band_rows3 with the exit off, at most those with it on.
    ``blocks`` holds (block, device ms, entries walked) of the exit-on
    walk at each of V3_BLOCKS.  The bounds: the pairs the function needs
    (csr3.band_rows3 with bands of one row, 32 pixels each; exit on:
    scaled by the share of entries walked) or the bytes; the (entry, band)
    pairs the cull evaluates; every pair of the walked entries (the old
    bound, v3_bound)."""
    import torch

    b = csr3.bin_csr_2x2(soup, width, height, max_big=1 << 16)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    entries, starts = csr3.cut_entries(b, cap)
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    rows = csr3.pack_rows8(soup, entries, b["big_ids"], zeros, zeros[:, 0],
                           (0.0, 0.0, 0.0))
    args = (rows[:entries.shape[0]],
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            starts, b["big_n"], b["zmeta"], width, height, b["zq_bits"])
    if width == WIDTH:
        check(b["zq_bits"] == 4, f"zq_bits {b['zq_bits']} at 1080p, want 4")
    want = csr3.raster_tiles3_plain(*args)
    lengths = starts[1:] - starts[:-1]
    kept = csr3.band_rows3(args[0], starts, width, height)
    errs = []
    for split in splits or (csr3.SPLIT_ROWS, SPLIT_FORCED):
        for exit_on in (True, False):
            walked = torch.full_like(lengths, -1)
            bands = torch.full_like(lengths, -1)
            got = csr3.raster_tiles3(*args, walked=walked, bands=bands,
                                     allow_exit=exit_on, split_rows=split)
            torch.cuda.synchronize()
            on = (f"csr3_raster {what} exit {'on' if exit_on else 'off'}, "
                  f"items of {split} rows"
                  + (f", entry_capacity {cap}" if cap is not None else ""))
            errs.append(check_equal_bits(got, want, on))
            check(bool(((walked >= 0) & (walked <= lengths)).all()) and (
                exit_on or torch.equal(walked, lengths)),
                f"{on}: walked {int(walked.sum())} of {int(lengths.sum())} "
                "entries")
            check(bool(((bands >= 0) & (bands <= kept)).all()) and (
                exit_on or torch.equal(bands, kept)),
                f"{on}: band-rows {int(bands.sum())}, band_rows3 "
                f"{int(kept.sum())}")
    out = dict(err=max(errs))
    if not timing:
        return out, b
    n = int(starts[-1])
    blocks = []
    walked = torch.empty_like(lengths)
    bands = torch.empty_like(lengths)
    for block in V3_BLOCKS:
        csr3.raster_tiles3(*args, walked=walked, block=block)
        blocks.append((block, device_ms(
            lambda k=block: csr3.raster_tiles3(*args, block=k), 11),
            int(walked.sum())))
    csr3.raster_tiles3(*args, walked=walked, bands=bands)
    n_walked, n_bands = int(walked.sum()), int(bands.sum())
    pixel_rows = int(csr3.band_rows3(args[0], starts, width, height,
                                     band=1).sum())
    big = big_ops(soup, b["big_ids"], b["big_n"], width, height)
    fixed = (int(b["big_n"][0]) * 64 + starts.numel() * 4
             + width * height * 4 * 2)
    on = floor_bound(pixel_rows * n_walked / max(n, 1), big,
                     n_walked * 16 + fixed)
    off = floor_bound(pixel_rows, big, n * 16 + fixed)
    out.update(ms=time_ms(lambda: csr3.raster_tiles3(*args), 11),
               ms_exit_off=time_ms(lambda: csr3.raster_tiles3(
                   *args, allow_exit=False), 11),
               device_ms=device_ms(lambda: csr3.raster_tiles3(*args), 11),
               device_ms_exit_off=device_ms(lambda: csr3.raster_tiles3(
                   *args, allow_exit=False), 11),
               plain_ms=time_ms(lambda: csr3.raster_tiles3_plain(*args), 2),
               bound_ms=on[0], bound_by=on[1], bound_ms_exit_off=off[0],
               bytes_ms=on[2],
               bound_ms_all_pairs=v3_bound(soup, b, n_walked, width,
                                           height)[0],
               bound_ms_evaluated=(n_bands * 32 * csr6.BAND_ROWS * OPS_DISC8
                                   + big) / F32_OPS_PER_S * 1e3,
               entries=n, walked=n_walked, bands=n_bands,
               bands_exit_off=int(kept.sum()), pixel_rows=pixel_rows,
               blocks=blocks, **tile_stats_runs(lengths, b["big_n"],
                                                csr3.SPLIT_ROWS))
    if sweep:
        split_sweep(f"csr3_raster exit off, {what}, device time",
                    lambda w, wk: csr3.raster_tiles3(
                        *args, allow_exit=False, split_rows=w, walked=wk),
                    card, sweep=SPLIT_SWEEP_DISC, timer=device_ms)
        split_sweep(f"csr3_raster exit on, {what}, device time",
                    lambda w, wk: csr3.raster_tiles3(*args, split_rows=w,
                                                     walked=wk), card,
                    lengths, sweep=SPLIT_SWEEP_DISC, timer=device_ms)
    return out, b


def tile_stats_runs(lengths, big_n, split_rows):
    """The rows per unit and work items of a walk whose units are runs of
    ``lengths`` rows (v3's tiles, v2's strip passes)."""
    items, w = plan_items(lengths, int(big_n[0]), split_rows)
    return dict(row_stats(lengths), items=items, item_rows=w)


def print_cull_times(name, r, shape, card, pairs_per_row):
    """The [time] lines of the culled walks' (csr3_raster, csr2_disc8)
    device times, bounds and cull."""
    print(f"[time] {name} at the {shape} shape: device {r['device_ms']:.3f} "
          f"ms (11 calls back to back), exit off {r['device_ms_exit_off']:.3f}"
          f"; bound {r['bound_ms']:.4f} ms by {r['bound_by']} (the pairs "
          f"needed, {r['pixel_rows']} pixel-row segments of 32 pixels with "
          f"every row walked, scaled by the walked share; bytes "
          f"{r['bytes_ms']:.4f}), exit off {r['bound_ms_exit_off']:.4f}; "
          f"over the pairs the cull evaluates {r['bound_ms_evaluated']:.4f};"
          f" every pair {r['bound_ms_all_pairs']:.4f} ({card})", flush=True)
    share = 100.0 * r["bands_exit_off"] / max(pairs_per_row * r["entries"],
                                              1)
    print(f"[time] {name} at the {shape} shape: {stats_text(r, 'unit')}; "
          f"the cull keeps {r['bands_exit_off']} of "
          f"{pairs_per_row * r['entries']} (row, warp) pairs ({share:.1f}%) "
          f"with every row walked, {r['bands']} evaluated with the exit "
          f"({r['walked']} of {r['entries']} rows walked); pixel-row "
          f"segments needed {r['pixel_rows']} ({card})", flush=True)


def exit_split_soups(dev, csr6, csr4, max_err):
    """Phase 3: both csr6_raster instances and csr6_cap10 against their
    plain versions on the seeded soup that forces splits (6,600 capsules
    over the corner of four tiles, ~2,500 rows per tile) and on the JAX
    package's cross-class exit case; the exit must leave the far discs'
    segment of the cross-class tile and still let the near disc win."""
    import torch

    ts = torch_soups()
    split = ts.split_soup().to(dev)
    cross = ts.cross_class_soup().to(dev)
    for name, soup, (w, h) in (("split", split, (ts.W, ts.H)),
                               ("cross_class", cross, ts.CROSS_FILM)):
        for bt in (False, True):
            key = "csr6_raster[bin_triangles]" if bt else "csr6_raster"
            res, got = compare(soup, w, h, csr6, csr4, 1 << 16, bt)
            max_err[key] = max(max_err[key], res["err"])
        res10, _ = compare_cap10(soup, w, h, csr6, 1 << 16, 2)
        max_err["csr6_cap10"] = max(max_err["csr6_cap10"], res10["err"])
        rows = csr6.tile_rows(csr6.bin_csr6(soup, w, h)["starts"], w, h)
        print(f"[kernel==plain] csr6_raster, csr6_raster[bin_triangles] "
              f"(exit off and on), csr6_cap10 on the {name} soup ({w}x{h}): "
              f"{soup.count} prims, tile rows max {int(rows.max())} ok",
              flush=True)
    b = csr6.bin_csr6(cross, *ts.CROSS_FILM, with_z=True)
    zeros = torch.zeros((cross.count, 3), device=dev)
    tiles_x = csr6.grid_shape(*ts.CROSS_FILM)[0]
    walked = torch.zeros(tiles_x * csr6.grid_shape(*ts.CROSS_FILM)[1],
                         dtype=torch.int32, device=dev)
    _, index = csr6.raster_tiles(
        csr6.build_table16(cross, zeros, zeros[:, 0]), b["order"],
        b["starts"], b["big_ids"], b["big_n"], *ts.CROSS_FILM,
        zmeta=b["zmeta"], walked=walked)
    t = 2 * tiles_x + 2
    rows = csr6.tile_rows(b["starts"], *ts.CROSS_FILM)
    check(int(walked[t]) < int(rows[t]),
          "cross-class tile: the exit did not leave the far discs' segment")
    check(int(index[80, 95]) == cross.count - 1,
          "cross-class tile: the near disc does not win its pixels")
    print(f"[exit] cross-class tile (2, 2): {int(walked[t])} of "
          f"{int(rows[t])} rows walked, the near disc wins (the far "
          "discs' segment left, the next class walked)", flush=True)


def torch_soups():
    """The checkout's ``tests/torch_soups.py``, loaded by file name: an
    installed package named ``tests`` may shadow the checkout's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_soups", os.path.join(REPO, "tests", "torch_soups.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def droplet_soups(device):
    """Seeded traj_vel soups at 1920x1080 for csr6_rows9, at frames 120 and
    205: ``tests/torch_soups.droplet_soup`` of 30k droplets (ties, every
    7th row invalid) with 400 long straight capsules, which at this film
    pass 2x2, 4x4 and 8x8 tiles (the big list at each span) and reach 5-8
    tiles on both axes (binned only at span 8)."""
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.run import pipeline

    preset = PRESETS["traj_vel"]
    return {f"droplets_f{fi}": torch_soups().droplet_soup(
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
    from pointcloud_render_tpu_torch.raster import csr6

    reset_counts(counters)
    sink = traj_vel_renderer.main(
        ["--input-folder", inp, "--output-folder", out,
         "--frames", ",".join(map(str, FRAMES)), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = csr6.raster_tiles.launches
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == 3 and all(s == "ok" for _, s, _ in statuses),
          f"traj_vel frame records not all ok: {statuses}")
    for fi in FRAMES:
        check(os.path.getsize(os.path.join(out, f"frame_{fi:04d}_b0.png"))
              > 1000, f"traj_vel frame_{fi:04d}_b0.png missing")
    check(launches >= 3 and set(launch_counts(counters)) == {"raster_tiles"},
          f"traj_vel CLI: csr6_raster launched {launches} times, want >= 3 "
          f"and no other kernel ({launch_counts(counters)})")
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

    span, max_big, _, bigs, probe = lane_probe(csr6, soup_fn, frames)
    print(f"[droplet] {n} droplets, {DROPLET_SEGMENTS}-segment trails, "
          f"{soup_fn(frames[0])[0].count} prims; big list at probe frames "
          f"{probe} by span {bigs}: span {span}, max_big {max_big}",
          flush=True)
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
                               timing=fi == 120, card=card)
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
              f"{int(b['big_count'])}; csr6_rows9 == plain bit for bit "
              f"(items of {csr6.SPLIT_ROWS} and {SPLIT_FORCED} rows), "
              f"rows8 == rows9, four-tone rgb within {gap:.3g} of the "
              f"generic shade, {u8} u8 values differ", flush=True)
        if fi == 120:
            timed = res
            print(f"[time] csr6_rows9 kernel {res['ms']:.3f} ms (median of "
                  f"11), plain {res['plain_ms']:.1f} ms (median of 1), "
                  f"bound {res['bound_ms']:.3f} ms by {res['bound_by']} at "
                  f"the droplet lane's frame-120 shape ({card})", flush=True)
            print(f"[time] csr6_rows9 at the droplet lane's frame-120 shape: "
                  f"disc rows per tile max {res['disc_rows_max']}, median "
                  f"{res['disc_rows_median']:.0f}, p99 "
                  f"{res['disc_rows_p99']:.0f}; capsule rows max "
                  f"{res['capsule_rows_max']}, median "
                  f"{res['capsule_rows_median']:.0f}, p99 "
                  f"{res['capsule_rows_p99']:.0f}; {stats_text(res)}",
                  flush=True)

    # The main path: the lane's 12 frames through build_primitives +
    # render, certificate read once at the end.
    reset_counts(counters)
    ovf, cover = [], []
    for fi in frames:
        soup, cam = soup_fn(fi)
        fb, diag = render(soup, cam, cfg, return_diag=True)
        ovf.append(diag["big_overflow"])
        cover.append((fb.index >= 0).float().mean())
    torch.cuda.synchronize()
    launches = csr6.raster_tiles_rows9.launches
    others = launch_counts(counters)
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
        # The default walk takes the exit: zlb once, the int32 exit keys.
        f["zlb"] = csr6.z_lower_bound(f["soup"])
        f["b"] = csr6.bin_csr6(f["soup"], WIDTH, HEIGHT, max_big,
                               with_z=True, zlb=f["zlb"])

    def table(f):
        f["table"] = csr6.build_table16(f["soup"], f["rgb"], f["flag"],
                                        zlb=f["zlb"])

    def kernel(f):
        b = f["b"]
        f["depth"], f["index"] = csr6.raster_tiles(
            f["table"], b["order"], b["starts"], b["big_ids"], b["big_n"],
            WIDTH, HEIGHT, zmeta=b["zmeta"])

    def shade(f):
        csr6.shade_by_id(f["soup"], f["cam"], shading, f["depth"],
                         f["index"], f["rgb"], f["flag"])

    return [("camera+soup build", build), ("preshade", preshade),
            ("binning (zlb, sort, starts, big list)", binning),
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
        f["rows8"] = csr6.build_rows8(f["soup"], f["flag"], f["b"]["order"])
        f["big"] = csr6.build_table16_rows(f["soup"], f["rgb"], f["flag"],
                                           f["b"]["big_ids"])

    def kernel(f):
        b = f["b"]
        f["depth"], _, f["u"], f["v"] = csr6.raster_tiles_disc8_uv(
            f["rows8"], f["big"], b["starts"], b["big_n"], WIDTH, HEIGHT)

    def shade(f):
        f["lit"] = csr6.shade_uv(f["cam"], shading, f["depth"], f["u"],
                                 f["v"], LOOK)

    return [("camera+soup build", build), ("preshade", preshade),
            ("binning (sort, starts, big list)", binning),
            ("rows8 + big rows", tables), ("csr6_disc8_uv kernel", kernel),
            ("shade_uv", shade),
            ("srgb_encode_u8", lambda f: trajectory.srgb_encode_u8(f["lit"]))]


@contextlib.contextmanager
def plain_v6_scan(trajectory, csr6):
    """Within the block, TrajectoryScanRenderer renders through the plain
    versions of the v6 walks (render_shaded_csr6 with plain=True, every
    knob of the config forwarded): the kernels' own plain reference."""
    from pointcloud_render_tpu_torch.raster.render import FrameBuffers

    def render(prims, camera, config, return_diag=False):
        rgb, depth, index, diag = csr6.render_shaded_csr6(
            prims, camera, config.shading, max_big=config.max_big,
            plain=True, discs_only=config.discs_only,
            uniform_look=config.uniform_look, allow_exit=config.allow_exit,
            span=config.span, rows8=config.rows8, rows9=config.rows9,
            three_tone=config.three_tone,
            bin_triangles=config.bin_triangles,
            cap_rows10=config.cap_rows10)
        fb = FrameBuffers(rgb=rgb, depth=depth, index=index)
        return (fb, diag) if return_diag else fb

    saved = trajectory.render
    trajectory.render = render
    try:
        yield
    finally:
        trajectory.render = saved


def disc_lane(card, dev, max_err, counters) -> dict:
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
    # Both kernels against their plain versions at the lane's own shapes,
    # and the two shade epilogues against each other.
    timed = {}
    for fi in (0, 120, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        soup = pipeline.build_primitives(preset, cam, pos, None, fi)
        rgb_p, flag = csr6.preshade(soup, cam, shading)
        res, b = compare_disc(soup, flag, WIDTH, HEIGHT, csr6, max_big,
                              timing=fi == 120, card=card, sweep=fi == 120)
        for kernel, r in res.items():
            max_err[kernel] = max(max_err[kernel], r["err"])
        rows8 = csr6.build_rows8(soup, flag, b["order"])
        rows = csr6.tile_rows(b["starts"], WIDTH, HEIGHT)
        kept = int(csr6.band_rows(rows8, b["starts"], WIDTH, HEIGHT).sum())
        print(f"[disc] frame {fi}: {soup.count} prims, "
              f"{int(b['starts'][-1])} binned, true_entries "
              f"{int(b['diag']['true_entries'])}, big list "
              f"{int(b['big_count'])} of max_big {max_big}; csr6_disc8 and "
              "csr6_disc8_uv == plain bit for bit (items of "
              f"{csr6.SPLIT_ROWS_DISC} and {SPLIT_FORCED} rows; csr6_disc8 "
              "also with the exit forced on); "
              + stats_text(tile_stats(csr6, b, WIDTH, HEIGHT, 2,
                                      int(b["big_n"][0]),
                                      csr6.SPLIT_ROWS_DISC))
              + f"; band-rows {kept} of {8 * int(rows.sum())} "
              f"({100.0 * kept / max(8 * int(rows.sum()), 1):.1f}%)",
              flush=True)
        if fi == 120:
            timed = res
            for kernel, r in res.items():
                print_disc_times(kernel, r, "disc lane's frame-120", card)
        zeros = torch.zeros((soup.count, 3), device=dev)
        depth, index, u, v = csr6.raster_tiles_disc8_uv(
            rows8, csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["starts"], b["big_n"], WIDTH, HEIGHT)
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
    reset_counts(counters)
    t0 = time.perf_counter()
    frames, final = scan.render_frames(pos, None, range(SCAN_FRAMES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    uv_launches = csr6.raster_tiles_disc8_uv.launches
    check(launch_counts(counters) == {"raster_tiles_disc8_uv": SCAN_FRAMES},
          f"{SCAN_FRAMES}-frame scan: launches {launch_counts(counters)}, "
          "want csr6_disc8_uv once per frame and no other kernel")
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
    # The same three frames through the fused walk's plain version on the
    # card (the scan's render runs render_shaded_csr6 with plain=True).
    check_ids = (0, 120, SCAN_FRAMES - 1)
    with plain_v6_scan(trajectory, csr6):
        plain_frames, _ = trajectory.TrajectoryScanRenderer(
            preset, cfg, **film).render_frames(pos, None, check_ids)
    for fi, want in zip(check_ids, plain_frames):
        check(np.array_equal(frames[fi], want),
              f"scan frame {fi} differs from the plain walk's")
    print("[scan] frames 0, 120, 219 equal the plain fused walk's bit for "
          "bit", flush=True)
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
    reset_counts(counters)
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
    reset_counts(counters)
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


def mesh_soups(device):
    """Seeded mesh-LOD traj_vel soups at 1920x1080, at frames 120 and 205:
    3,000 droplets uniform in [-0.5, 0.5)^3 with velocities normal(0, 2),
    the first 300 of them twice (exact depth ties between ids, trails
    included), and 12 droplets 0.09-0.35 from the eye inside the view
    (triangles past 2x2 tiles ride the big list; the near clip splits some
    and leaves invalid rows), with 8-capsule trails and the ground; and
    "mesh_small_f120", 40 droplets (4 twice, 3 near) at frame 120, small
    enough for the walks without bin_triangles, whose big list takes
    every droplet triangle."""
    import numpy as np

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.run import pipeline

    preset = PRESETS["traj_vel"]
    rng = np.random.default_rng(2029)
    out = {}
    for name, fi, n, ties, n_near in (("mesh_f120", 120, 3000, 300, 12),
                                      ("mesh_f205", 205, 3000, 300, 12),
                                      ("mesh_small_f120", 120, 40, 4, 3)):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, device)
        eye = cam.origin.cpu().numpy().astype(np.float64)
        fwd = cam.target.cpu().numpy() - eye
        fwd /= np.linalg.norm(fwd)
        side = np.cross(fwd, [0.0, 0.0, 1.0])
        side /= np.linalg.norm(side)
        up = np.cross(side, fwd)
        pos, vel = flagship_cloud(n, seed=2029 + fi + n)
        d = rng.uniform(0.09, 0.35, (n_near, 1))
        near = (eye + fwd * d
                + side * d * rng.uniform(-0.25, 0.25, (n_near, 1))
                + up * d * rng.uniform(-0.12, 0.12, (n_near, 1)))
        pos = np.concatenate([pos, pos[:ties], near.astype(np.float32)])
        vel = np.concatenate([vel, vel[:ties], rng.normal(
            0.0, 2.0, (n_near, 3)).astype(np.float32)])
        out[name] = pipeline.build_primitives(preset, cam, pos, vel, fi,
                                              droplet_lod="mesh")
    return out


def mesh_kernels_vs_plain(dev, csr6, csr4, max_err):
    """Phase 9 (a): both kernels against their plain versions, with and
    without bin_triangles, on the seeded mesh-LOD soups and phase 3's
    soups, and csr4_raster on truncated entries."""
    seeded = mesh_soups(dev)
    seeded.update(soups(dev))
    for name, soup in seeded.items():
        # Without bin_triangles every droplet triangle rides the big list:
        # the 3,000-droplet soups take the binned walks only.
        large_mesh = name in ("mesh_f120", "mesh_f205")
        for bt in (True,) if large_mesh else (False, True):
            res6, got6 = compare(soup, WIDTH, HEIGHT, csr6, csr4,
                                       1 << 16, bt)
            key = "csr6_raster[bin_triangles]" if bt else "csr6_raster"
            max_err[key] = max(max_err[key], res6["err"])
            res4, got4 = compare_v4(soup, WIDTH, HEIGHT, csr6, csr4, 1 << 16,
                                    bt)
            max_err["csr4_raster"] = max(max_err["csr4_raster"], res4["err"])
            check_equal_bits(got4, got6, f"csr4_raster == {key} on {name}")
            b = csr4.bin_csr4(soup, WIDTH, HEIGHT, 1 << 16, bt)
            print(f"[kernel==plain] {key}, csr4_raster (bin_triangles={bt}) "
                  f"{name}: {soup.count} prims, "
                  f"{int(b['diag']['true_entries'])} tile entries, big list "
                  f"{int(b['big_count'])} ok; v4 == v6", flush=True)
    soup = seeded["mesh_f120"]
    true = int(csr4.true_entry_count4(soup, WIDTH, HEIGHT, True))
    cap = true * 2 // 3
    res, _ = compare_v4(soup, WIDTH, HEIGHT, csr6, csr4, 1 << 16, True,
                        cap=cap)
    max_err["csr4_raster"] = max(max_err["csr4_raster"], res["err"])
    print(f"[kernel==plain] csr4_raster mesh_f120 entry_capacity {cap} of "
          f"{true} true entries ok", flush=True)


def mesh_stages(csr6, pipeline, preset, pcl, fi, dev, max_big):
    """The stages of one mesh-LOD frame, in the order render_shaded_csr6
    runs them under bin_triangles."""
    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    shading = ShadingConfig()

    def build(f):
        f["cam"] = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        f["soup"] = pipeline.build_primitives(
            preset, f["cam"], pcl[:, :3], pcl[:, 3:], fi, droplet_lod="mesh")

    def preshade(f):
        f["rgb"], f["flag"] = csr6.preshade(f["soup"], f["cam"], shading)

    def binning(f):
        f["zlb"] = csr6.z_lower_bound(f["soup"], with_triangles=True)
        f["b"] = csr6.bin_csr6(f["soup"], WIDTH, HEIGHT, max_big,
                               bin_triangles=True, with_z=True, zlb=f["zlb"])

    def table(f):
        f["table"] = csr6.build_table16(f["soup"], f["rgb"], f["flag"],
                                        bin_triangles=True, zlb=f["zlb"])

    def kernel(f):
        b = f["b"]
        f["depth"], f["index"] = csr6.raster_tiles(
            f["table"], b["order"], b["starts"], b["big_ids"], b["big_n"],
            WIDTH, HEIGHT, True, zmeta=b["zmeta"])

    def shade(f):
        csr6.shade_by_id(f["soup"], f["cam"], shading, f["depth"],
                         f["index"], f["rgb"], f["flag"])

    return [("camera+soup build (mesh LOD)", build), ("preshade", preshade),
            ("binning (bin_triangles)", binning), ("table16 (zlb)", table),
            ("csr6_raster[bin_triangles] kernel", kernel),
            ("shade_by_id", shade),
            ("overflow read-back",
             lambda f: int(f["b"]["diag"]["big_overflow"]))]


def equal_buffers(a, b, what):
    """Two FrameBuffers equal bit for bit (depth, index, rgb)."""
    import torch

    for field in ("index", "depth", "rgb"):
        x, y = getattr(a, field), getattr(b, field)
        check(torch.equal(x.contiguous().view(torch.int32),
                          y.contiguous().view(torch.int32)),
              f"{what}: {field} differs")


def mesh_lane(card, dev, max_err, counters, tmp) -> dict:
    """Phase 9 (b): 10,000 mesh-LOD droplets at 1080p -> dict(launches, ms,
    plain_ms, bound_ms, bound_by) of csr6_raster[bin_triangles]."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.cli import traj_vel_renderer
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.io import ply
    from pointcloud_render_tpu_torch.raster import csr4, csr6
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline, trajectory

    preset = PRESETS["traj_vel"]
    pos, vel = flagship_cloud(MESH_DROPLETS, seed=13)
    inp, out = os.path.join(tmp, "in_mesh"), os.path.join(tmp, "out_mesh")
    os.makedirs(inp)
    for k, fi in enumerate((10, 120, 199)):
        drift = (0.01 * k * vel).astype(np.float32)
        ply.write_ply(os.path.join(inp, f"frame_{fi:04d}_b0.ply"),
                      pos + drift, velocities=vel)
    reset_counts(counters)
    sink = traj_vel_renderer.main(
        ["--input-folder", inp, "--output-folder", out, "--frames",
         ",".join(map(str, FRAMES)), "--device", "cuda", "--droplet-lod",
         "mesh"])
    torch.cuda.synchronize()
    launches = csr6.raster_tiles_tri.launches
    counts = launch_counts(counters)
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == 3 and all(s == "ok" for _, s, _ in statuses),
          f"mesh-LOD frame records not all ok: {statuses}")
    for fi in FRAMES:
        check(os.path.getsize(os.path.join(out, f"frame_{fi:04d}_b0.png"))
              > 1000, f"mesh-LOD frame_{fi:04d}_b0.png missing")
    check(launches >= 3 and set(counts) == {"raster_tiles_tri"},
          f"mesh-LOD CLI: launches {counts}, want csr6_raster[bin_triangles] "
          ">= 3 and no other kernel")
    for r in sink.records:
        t = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in r.timings_s.items())
        print(f"[mesh cli] frame {r.frame_index}: {r.points} points {t} "
              f"({card})", flush=True)
    print(f"[mesh cli] traj_vel --droplet-lod mesh frames 10, 120, 205 ok, "
          f"PNGs written; csr6_raster[bin_triangles] launches {launches}",
          flush=True)

    auto = pipeline.FramePipeline(preset, droplet_lod="mesh", device=dev)
    v4 = pipeline.FramePipeline(
        preset, RasterConfig(backend="pallas4", bin_triangles=True),
        droplet_lod="mesh", device=dev)
    clouds = {}
    for fi, name in ((10, 10), (120, 120), (205, 199)):
        pcl = auto.load_and_prepare(
            os.path.join(inp, f"frame_{name:04d}_b0.ply"))
        clouds[fi] = pcl
        fa = auto.render_array(pcl, fi)
        f4 = v4.render_array(pcl, fi)
        equal_buffers(fa, f4, f"mesh-LOD frame {fi}: auto vs pallas4")
        check(bool(torch.isfinite(fa.rgb).all())
              and bool((fa.index >= 0).any()), f"frame {fi} malformed")
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        soup = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:],
                                         fi, droplet_lod="mesh")
        b = csr6.bin_csr6(soup, WIDTH, HEIGHT, bin_triangles=True)
        tri_px = int((soup.kind[fa.index.clamp(min=0).long()] == 2).sum()
                     - (fa.index.clamp(min=0) < 4).sum())
        print(f"[mesh] frame {fi}: {soup.count} prims "
              f"({int(soup.valid.sum())} valid), big list "
              f"{int(b['big_count'])}, {int(b['starts'][-1])} binned, tile "
              f"entries {int(b['diag']['true_entries'])}, droplet-triangle "
              f"pixels {tri_px}; auto == pallas4 (depth bits, index, rgb)",
              flush=True)
        if fi == 120:
            res6, got6 = compare(soup, WIDTH, HEIGHT, csr6, csr4,
                                       auto.raster_config.max_big, True,
                                       timing=True)
            res4, got4 = compare_v4(soup, WIDTH, HEIGHT, csr6, csr4,
                                    v4.raster_config.max_big, True,
                                    timing=True)
            check_equal_bits(got4, got6, "mesh frame 120: csr4 == csr6")
            max_err["csr6_raster[bin_triangles]"] = max(
                max_err["csr6_raster[bin_triangles]"], res6["err"])
            max_err["csr4_raster"] = max(max_err["csr4_raster"], res4["err"])
            timed = res6
            print_v6_times("csr6_raster[bin_triangles]", res6,
                           "mesh frame-120", card)
            print_v4_times("csr4_raster bin_triangles", res4,
                           "mesh frame-120", card)
            bz = csr6.bin_csr6(soup, WIDTH, HEIGHT,
                               auto.raster_config.max_big,
                               bin_triangles=True, with_z=True)
            zeros = torch.zeros((soup.count, 3), device=dev)
            sweep = (csr6.build_table16(soup, zeros, zeros[:, 0],
                                        bin_triangles=True), bz["order"],
                     bz["starts"], bz["big_ids"], bz["big_n"], WIDTH, HEIGHT,
                     True)
            split_sweep("csr6_raster[bin_triangles] exit on, mesh frame 120",
                        lambda w, wk: csr6.raster_tiles(
                            *sweep, zmeta=bz["zmeta"], split_rows=w,
                            walked=wk), card,
                        csr6.tile_rows(bz["starts"], WIDTH, HEIGHT))
            del sweep, zeros, bz
            off = pipeline.FramePipeline(
                preset, RasterConfig(allow_exit=False), droplet_lod="mesh",
                device=dev)
            equal_buffers(off.render_array(pcl, fi), fa,
                          "mesh frame 120: exit off vs the default")
            print("[exit] mesh frame 120: the default frame (exit on) == "
                  "allow_exit=False bit for bit (rgb, depth, index)",
                  flush=True)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        auto.render_array(clouds[120], 120)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    print(f"[time] mesh frame 120 render_array warm: median {med:.2f} ms, "
          f"quartiles {q1:.2f}-{q3:.2f} ms over 5 frames ({MESH_DROPLETS} "
          f"droplets) ({card})", flush=True)
    for stage, ms in stage_times(mesh_stages(
            csr6, pipeline, preset, clouds[120], 120, dev,
            auto.raster_config.max_big)).items():
        print(f"[stage] mesh frame 120 {stage}: {ms:.3f} ms ({card})",
              flush=True)
    busy, wall, top, _ = device_profile(
        lambda: auto.render_array(clouds[120], 120), 1, tmp)
    if top:
        print(f"[trace] mesh frame 120: device busy {busy / 1e3:.2f} of "
              f"{wall / 1e3:.2f} ms wall, idle share {1 - busy / wall:.3f} "
              f"({card})", flush=True)
        for name, us in top[:6]:
            print(f"[trace] mesh {us / 1e3:9.3f} ms  {name[:90]}", flush=True)
    else:
        print("[trace] mesh frame: the profiler saw no device activity; "
              "device busy share not measured", flush=True)
    before = csr6.raster_tiles_tri.launches
    scan = trajectory.TrajectoryScanRenderer(
        preset, droplet_lod="mesh", frames_per_chunk=8, device=dev)
    pcl = clouds[120]
    frames, _ = scan.render_frames(pcl[:, :3], pcl[:, 3:], range(116, 124))
    torch.cuda.synchronize()
    scan_launches = csr6.raster_tiles_tri.launches - before
    check(scan_launches == 8, f"mesh scan: csr6_raster[bin_triangles] "
          f"launched {scan_launches} times, want 8")
    check(len(frames) == 8 and all(f.shape == (HEIGHT, WIDTH, 3)
                                   for f in frames), "mesh scan frames")
    print(f"[mesh] scan of traj_vel frames 116-123, mesh LOD: certificate 0, "
          f"csr6_raster[bin_triangles] launches {scan_launches}, max_big "
          f"{scan.raster_config.max_big}", flush=True)
    return dict(timed, launches=launches)


def v4_flagship(card, dev, inp, out_default, out_v4, counters, max_err):
    """Phase 9 (c): the traj_ball CLI with --backend pallas4 on phase 5's
    PLYs -> dict(launches, ms, plain_ms, bound_ms, bound_by) of
    csr4_raster; then the 2^24 guard at 13,026 mesh-LOD droplets."""
    import torch

    from pointcloud_render_tpu_torch.cli import traj_ball_renderer
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import csr4, csr6
    from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
    from pointcloud_render_tpu_torch.run import pipeline

    reset_counts(counters)
    sink = traj_ball_renderer.main(
        ["--input-folder", inp, "--output-folder", out_v4, "--frames",
         ",".join(map(str, FRAMES)), "--device", "cuda", "--backend",
         "pallas4"])
    torch.cuda.synchronize()
    launches = csr4.raster_tiles4.launches
    counts = launch_counts(counters)
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == 3 and all(s == "ok" for _, s, _ in statuses),
          f"pallas4 frame records not all ok: {statuses}")
    check(launches >= 3 and set(counts) == {"raster_tiles4"},
          f"pallas4 CLI: launches {counts}, want csr4_raster >= 3 and no "
          "other kernel")
    for fi in FRAMES:
        name = f"frame_{fi:04d}_b0.png"
        with open(os.path.join(out_default, name), "rb") as f, \
                open(os.path.join(out_v4, name), "rb") as g:
            check(f.read() == g.read(),
                  f"pallas4 {name} differs from the pallas6 frame")
    for r in sink.records:
        t = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in r.timings_s.items())
        print(f"[v4 cli] frame {r.frame_index}: {r.points} points {t} "
              f"({card})", flush=True)
    print(f"[v4 cli] traj_ball --backend pallas4 frames 10, 120, 205: PNGs "
          f"equal the pallas6 run's byte for byte; csr4_raster launches "
          f"{launches}", flush=True)
    preset = PRESETS["traj_ball"]
    p6 = pipeline.FramePipeline(preset, device=dev)
    p4 = pipeline.FramePipeline(preset, RasterConfig(backend="pallas4"),
                                device=dev)
    timed4 = {}
    for fi, name in ((120, 120), (205, 199)):
        pcl = p6.load_and_prepare(os.path.join(inp,
                                               f"frame_{name:04d}_b0.ply"))
        equal_buffers(p6.render_array(pcl, fi), p4.render_array(pcl, fi),
                      f"traj_ball frame {fi}: pallas6 vs pallas4")
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        soup = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:],
                                         fi)
        r, _ = compare_v4(soup, WIDTH, HEIGHT, csr6, csr4,
                          p4.raster_config.max_big, False, timing=True,
                          card=card, sweep=fi == 120,
                          what=f"traj_ball frame {fi}")
        max_err["csr4_raster"] = max(max_err["csr4_raster"], r["err"])
        timed4[fi] = r
        print_v4_times("csr4_raster", r, f"traj_ball frame-{fi}", card)
    print(f"[v4] traj_ball frames 120, 205: pallas4 == pallas6 (depth bits, "
          f"index, rgb); max_big after self-heal "
          f"{p4.raster_config.max_big}", flush=True)
    # One droplet past the id limit must raise, as in the JAX package.
    n = MESH_MAX_DROPLETS + 1
    pos, vel = flagship_cloud(n, seed=17)
    vel_preset = PRESETS["traj_vel"]
    cam = pipeline.frame_camera(vel_preset, 120, WIDTH, HEIGHT, dev)
    soup = pipeline.build_primitives(vel_preset, cam, pos, vel, 120,
                                     droplet_lod="mesh")
    check(soup.count == 4 + n * MESH_ROWS_PER_DROPLET >= 1 << 24,
          f"{n} mesh droplets gave {soup.count} rows")
    for cfg in (RasterConfig(bin_triangles=True),
                RasterConfig(backend="pallas4", bin_triangles=True)):
        try:
            render(soup, cam, cfg)
        except ValueError as e:
            check("2^24" in str(e), f"unexpected ValueError: {e}")
        else:
            raise SmokeFailure(f"{n} mesh droplets ({soup.count} rows) "
                               f"rendered through {cfg.backend}")
    print(f"[limit] {n} mesh droplets = {soup.count} rows raise the 2^24 "
          f"ValueError (auto and pallas4); {MESH_MAX_DROPLETS} is the most "
          f"a frame holds", flush=True)
    del soup
    # Frame 205 (the self-healed big list) beside frame 120's numbers.
    f205 = {f"{k}_frame205": timed4[205][k] for k in FRAME205_KEYS}
    return dict(timed4[120], launches=launches, **f205)


def traj_stages(csr6, pipeline, trails_mod, prims_mod, preset, pcl, hist,
                fi, dev, max_big):
    """The stages of one traj frame (default config): the soup build split
    into its droplet part, the history trails (Catmull-Rom fit, then their
    capsules) and the concatenation, then the order render_shaded_csr6
    runs.  ``hist`` is the (20, N, 3) history on the device."""
    import numpy as np

    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    shading = ShadingConfig()

    def droplets(f):
        f["cam"] = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        f["pos"] = pcl[:, :3]
        f["soup"] = pipeline.build_primitives(preset, f["cam"], f["pos"],
                                              pcl[:, 3:], fi)

    def fit(f):
        f["pts"], f["valid"], f["keep"] = trails_mod.catmull_rom_trails(
            hist, f["pos"])

    def capsules(f):
        f["trail"] = prims_mod.capsules_from_polylines(
            f["pts"], f["keep"] & f["valid"][:, None], f["cam"],
            preset.trail_radius, np.asarray(preset.trail_color, np.float32))

    def concat(f):
        f["soup"] = prims_mod.ScreenPrimitives.concatenate(
            [f["soup"], f["trail"]])

    def preshade(f):
        f["rgb"], f["flag"] = csr6.preshade(f["soup"], f["cam"], shading)

    def binning(f):
        # The default walk takes the exit: zlb once, the int32 exit keys.
        f["zlb"] = csr6.z_lower_bound(f["soup"])
        f["b"] = csr6.bin_csr6(f["soup"], WIDTH, HEIGHT, max_big,
                               with_z=True, zlb=f["zlb"])

    def table(f):
        f["table"] = csr6.build_table16(f["soup"], f["rgb"], f["flag"],
                                        zlb=f["zlb"])

    def kernel(f):
        b = f["b"]
        f["depth"], f["index"] = csr6.raster_tiles(
            f["table"], b["order"], b["starts"], b["big_ids"], b["big_n"],
            WIDTH, HEIGHT, zmeta=b["zmeta"])

    def shade(f):
        csr6.shade_by_id(f["soup"], f["cam"], shading, f["depth"],
                         f["index"], f["rgb"], f["flag"])

    return [("camera + ground + droplets", droplets),
            ("catmull_rom_trails", fit),
            ("trail capsules_from_polylines", capsules),
            ("soup concatenate", concat), ("preshade", preshade),
            ("binning (zlb, sort, starts, big list)", binning),
            ("table16", table), ("csr6_raster kernel", kernel),
            ("shade_by_id", shade),
            ("overflow read-back",
             lambda f: int(f["b"]["diag"]["big_overflow"]))]


def traj_slice(card, dev, max_err, counters, tmp) -> dict:
    """Phase 10 (b): the traj preset at 700,000 points -> dict(launches,
    ms, plain_ms, bound_ms, bound_by) of csr6_cap10 (see the module
    docstring)."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.cli import traj_renderer
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.geometry import trails as trails_mod
    from pointcloud_render_tpu_torch.io import ply
    from pointcloud_render_tpu_torch.raster import csr4, csr6
    from pointcloud_render_tpu_torch.raster import primitives as prims_mod
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline, trajectory
    from pointcloud_render_tpu_torch.scene import dynamics

    preset = PRESETS["traj"]
    pos, vel = flagship_cloud(TRAJ_POINTS, seed=17)
    inp, out = os.path.join(tmp, "in_traj"), os.path.join(tmp, "out_traj")
    os.makedirs(inp)
    for n in range(TRAJ_PLY_FRAMES):
        ply.write_ply(os.path.join(inp, f"frame_{n:04d}_b0.ply"),
                      pos + vel * np.float32(TRAJ_DT * n), velocities=vel)
    last = TRAJ_PLY_FRAMES - 1
    reset_counts(counters)
    t0 = time.perf_counter()
    sink = traj_renderer.main(
        ["--input-folder", inp, "--output-folder", out, "--frames",
         f"0:{TRAJ_PLY_FRAMES}", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(counters)
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == TRAJ_PLY_FRAMES
          and all(st == "ok" for _, st, _ in statuses),
          f"traj frame records not all ok: {statuses}")
    for fi in (20, 21, last):
        check(os.path.getsize(os.path.join(out, f"frame_{fi:04d}_b0.png"))
              > 1000, f"traj frame_{fi:04d}_b0.png missing")
    check(set(counts) == {"raster_tiles"}
          and counts["raster_tiles"] >= TRAJ_PLY_FRAMES,
          f"traj CLI: launches {counts}, want csr6_raster once per frame "
          "or more (self-heals) and no other kernel")
    for r in sink.records:
        if r.frame_index in (0, 20, 21, last):
            t = " ".join(f"{k}={v * 1e3:.1f}ms"
                         for k, v in r.timings_s.items())
            print(f"[traj cli] frame {r.frame_index}: {r.points} points {t} "
                  f"({card})", flush=True)
    print(f"[traj cli] traj frames 0-{last} ok (history preload, 20-frame "
          f"windows from frame 20), PNGs written; csr6_raster launches "
          f"{counts['raster_tiles']}; {wall:.1f} s wall", flush=True)

    pipe = pipeline.FramePipeline(preset, device=dev)
    clouds = [pipe.load_and_prepare(os.path.join(inp,
                                                 f"frame_{n:04d}_b0.ply"))
              for n in range(TRAJ_PLY_FRAMES)]

    def history(fi, n=None):
        return np.stack([c[:n, :3] for c in clouds[max(0, fi - 20):fi]])

    # The cap_rows10 walk on its main path: FramePipeline frames at spans
    # 2 and 4, each equal to the default walk's at the same span.
    span4 = pipeline.FramePipeline(preset, RasterConfig(span=4), device=dev)
    cap10 = {span: pipeline.FramePipeline(
        preset, RasterConfig(cap_rows10=True, span=span), device=dev)
        for span in (2, 4)}
    reset_counts(counters)
    for fi in (20, 21, last):
        h = history(fi)
        want = pipe.render_array(clouds[fi], fi, h)
        equal_buffers(cap10[2].render_array(clouds[fi], fi, h), want,
                      f"traj frame {fi}: cap_rows10 vs the default walk")
        check(bool((want.index >= 0).any())
              and bool(torch.isfinite(want.rgb).all()), "traj frame empty")
    h = history(last)
    equal_buffers(cap10[4].render_array(clouds[last], last, h),
                  span4.render_array(clouds[last], last, h),
                  f"traj frame {last}: cap_rows10 span 4 vs span 4")
    torch.cuda.synchronize()
    counts = launch_counts(counters)
    launches = counts.get("raster_tiles_cap10", 0)
    check(launches >= 4, f"cap_rows10 frames: launches {counts}, want "
          "csr6_cap10 at least 4 times")
    print(f"[traj] frames 20, 21, {last} (span 2) and {last} (span 4): "
          f"cap_rows10 == the default walk bit for bit (rgb, depth, index);"
          f" launches {counts}", flush=True)

    # The frame's shape, and the kernels against their plain versions.
    hist = torch.tensor(h, device=dev)
    pcl = clouds[last]
    cam = pipeline.frame_camera(preset, last, WIDTH, HEIGHT, dev)
    soup = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:],
                                     last, hist)
    check(soup.count == 4 + TRAJ_ROWS_PER_POINT * TRAJ_POINTS,
          f"traj soup holds {soup.count} rows")
    max_big = pipe.raster_config.max_big
    res10, got10 = compare_cap10(soup, WIDTH, HEIGHT, csr6, max_big, 2,
                                 timing=True)
    res16, got16 = compare(soup, WIDTH, HEIGHT, csr6, csr4, max_big,
                           timing=True)
    check_equal_bits(got10, got16, "traj frame: csr6_cap10 == csr6_raster")
    max_err["csr6_cap10"] = max(max_err["csr6_cap10"], res10["err"])
    max_err["csr6_raster"] = max(max_err["csr6_raster"], res16["err"])
    print(f"[traj] frame {last}: {soup.count} prims "
          f"({int(soup.valid.sum())} valid), {res10['binned']} binned, big "
          f"list {res10['big']}, tile entries {res10['entries']} at span 2",
          flush=True)
    print_v6_times("csr6_cap10", res10, f"traj frame-{last}, span 2", card)
    print_v6_times("csr6_raster", res16, f"traj frame-{last}, span 2", card)
    zeros = torch.zeros((soup.count, 3), device=dev)
    bz = csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big, with_z=True)
    sweep = (csr6.build_table16(soup, zeros, zeros[:, 0]), bz["order"],
             bz["starts"], bz["big_ids"], bz["big_n"], WIDTH, HEIGHT)
    split_sweep(f"csr6_raster exit off, traj frame {last}",
                lambda w, wk: csr6.raster_tiles(*sweep, split_rows=w,
                                                walked=wk), card)
    split_sweep(f"csr6_raster exit on, traj frame {last}",
                lambda w, wk: csr6.raster_tiles(*sweep, zmeta=bz["zmeta"],
                                                split_rows=w, walked=wk),
                card, csr6.tile_rows(bz["starts"], WIDTH, HEIGHT))
    r10 = (csr6.build_table10(soup), csr6.build_table16_rows(
        soup, zeros, zeros[:, 0], bz["big_ids"]), bz["order"], bz["starts"],
        bz["big_n"], WIDTH, HEIGHT)
    split_sweep(f"csr6_cap10, traj frame {last}",
                lambda w, wk: csr6.raster_tiles_cap10(*r10, split_rows=w,
                                                      walked=wk), card)
    del sweep, r10, bz
    off = pipeline.FramePipeline(preset, RasterConfig(allow_exit=False),
                                 device=dev)
    equal_buffers(off.render_array(clouds[last], last, h),
                  pipe.render_array(clouds[last], last, h),
                  f"traj frame {last}: exit off vs the default")
    print(f"[exit] traj frame {last}: the default frame (exit on) == "
          "allow_exit=False bit for bit (rgb, depth, index)", flush=True)
    for span in (4, 8):
        b = csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big, span=span)
        r10 = (csr6.build_table10(soup), csr6.build_table16_rows(
            soup, zeros, zeros[:, 0], b["big_ids"]), b["order"],
            b["starts"], b["big_n"], WIDTH, HEIGHT, span)
        r16 = (csr6.build_table16(soup, zeros, zeros[:, 0]), b["order"],
               b["starts"], b["big_ids"], b["big_n"], WIDTH, HEIGHT, False,
               span)
        check_equal_bits(csr6.raster_tiles_cap10(*r10),
                         csr6.raster_tiles(*r16),
                         f"traj frame span {span}: cap10 == csr6_raster")
        print(f"[time] traj frame {last} span {span}: csr6_cap10 "
              f"{time_ms(lambda a=r10: csr6.raster_tiles_cap10(*a), 11):.3f}"
              f" ms, csr6_raster "
              f"{time_ms(lambda a=r16: csr6.raster_tiles(*a), 11):.3f} ms "
              f"(medians of 11; {int(b['starts'][-1])} binned, big list "
              f"{int(b['big_count'])}, tile entries "
              f"{int(b['diag']['true_entries'])}) ({card})", flush=True)
    del r10, r16, zeros
    # Both kernels == plain at spans 2, 4, 8 on a 100,000-point traj soup.
    n_small = 100_000
    small = pipeline.build_primitives(
        preset, cam, pcl[:n_small, :3], pcl[:n_small, 3:], last,
        torch.tensor(history(last, n_small), device=dev))
    for span in csr6.SPANS:
        r10, _ = compare_cap10(small, WIDTH, HEIGHT, csr6, 1 << 16, span)
        r16, _ = compare(small, WIDTH, HEIGHT, csr6, csr4, 1 << 16,
                         span=span)
        max_err["csr6_cap10"] = max(max_err["csr6_cap10"], r10["err"])
        max_err["csr6_raster"] = max(max_err["csr6_raster"], r16["err"])
        print(f"[kernel==plain] csr6_cap10, csr6_raster span {span} traj "
              f"{n_small} points: {small.count} prims, {r10['binned']} "
              f"binned, big list {r10['big']} ok", flush=True)

    # The warm frame, its stages and a trace.
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.render_array(pcl, last, h)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    print(f"[time] traj frame {last} render_array warm: median {med:.2f} ms, "
          f"quartiles {q1:.2f}-{q3:.2f} ms over 5 frames ({TRAJ_POINTS} "
          f"points, 20 frames of history) ({card})", flush=True)
    for stage, ms in stage_times(traj_stages(
            csr6, pipeline, trails_mod, prims_mod, preset,
            torch.tensor(pcl, device=dev), hist, last, dev,
            max_big)).items():
        print(f"[stage] traj frame {last} {stage}: {ms:.3f} ms ({card})",
              flush=True)
    busy, wall_us, top, _ = device_profile(
        lambda: pipe.render_array(pcl, last, h), 1, tmp)
    if top:
        print(f"[trace] traj frame {last}: device busy {busy / 1e3:.2f} of "
              f"{wall_us / 1e3:.2f} ms wall, idle share "
              f"{1 - busy / wall_us:.3f} ({card})", flush=True)
        for name, us in top[:8]:
            print(f"[trace] traj {us / 1e3:9.3f} ms  {name[:90]}", flush=True)
    else:
        print("[trace] traj frame: the profiler saw no device activity; "
              "device busy share not measured", flush=True)
    del soup, small, got10, got16

    # The scan: the rolling buffer fills during 40 frames from frame 0.
    film = dict(frames_per_chunk=SCAN_CHUNK, width=WIDTH, height=HEIGHT,
                device="cuda")
    scan = trajectory.TrajectoryScanRenderer(preset, dt=TRAJ_DT, **film)
    p0, v0 = clouds[0][:, :3], clouds[0][:, 3:]
    scan.render_frames(p0, v0, range(SCAN_CHUNK))
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    frames, final = scan.render_frames(p0, v0, range(TRAJ_SCAN_FRAMES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(counters)
    check(counts == {"raster_tiles": TRAJ_SCAN_FRAMES},
          f"traj scan: launches {counts}, want csr6_raster once per frame")
    moved = torch.tensor(p0, device=dev)
    vdev = torch.tensor(v0, device=dev)
    for _ in range(TRAJ_SCAN_FRAMES):
        moved = dynamics.advect(moved, vdev, TRAJ_DT)
    check(torch.equal(final, moved), "traj scan: final positions differ")
    check(all((f.min(axis=2) < 250).mean() > 0.01 for f in frames),
          "traj scan frames look empty")
    print(f"[scan] traj {TRAJ_SCAN_FRAMES} frames from frame 0, "
          f"{TRAJ_POINTS} points, chunks of {SCAN_CHUNK}, dt {TRAJ_DT}: "
          f"certificate 0 on every chunk, launches {counts}, max_big "
          f"{scan.raster_config.max_big}, {wall:.3f} s wall, "
          f"{TRAJ_SCAN_FRAMES / wall:.2f} frames/s warm ({card})", flush=True)
    p0_dev = torch.tensor(p0, device=dev)
    busy, wall_us, top, calls = device_profile(
        lambda: scan.render_frames(p0_dev, vdev, range(32, 40)), 1, tmp)
    if top:
        waits = sum(v for k, v in calls.items() if "Synchronize" in k)
        print(f"[trace] traj scan chunk (frames 32-39): device busy "
              f"{busy / 1e3:.2f} of {wall_us / 1e3:.2f} ms wall, idle share "
              f"{1 - busy / wall_us:.3f}; host calls {calls} ({card})",
              flush=True)
        check(waits < SCAN_CHUNK, f"the traj chunk synchronised {waits} "
              "times: the frame loop waits for the device inside a chunk")
    else:
        print("[trace] traj scan: the profiler saw no device activity; "
              "device busy share not measured", flush=True)
    del frames

    # One point past the 2^24-row limit raises the JAX package's error.
    over = TRAJ_MAX_POINTS + 1
    rng = np.random.default_rng(19)
    big = np.concatenate([rng.uniform(-0.5, 0.5, (over, 3)),
                          rng.normal(0.0, 2.0, (over, 3))],
                         axis=1).astype(np.float32)
    try:
        pipe.render_array(big, last, np.stack([big[:, :3]] * 20))
    except ValueError as e:
        check("2^24" in str(e), f"{over} points: {e}")
        print(f"[traj] {over} points ({4 + TRAJ_ROWS_PER_POINT * over} rows) "
              f"raise ValueError: {e}", flush=True)
    else:
        raise SmokeFailure(f"{over} traj points rendered past the 2^24-row "
                           "id limit")
    return dict(res10, launches=launches)


def v3_lane(card, dev, max_err, counters, tmp, seeded) -> dict:
    """Phase 10 (c): the v3 disc fast path -> dict(launches, ms,
    ms_exit_off, plain_ms, bound_ms, bound_ms_exit_off, bound_by) of
    csr3_raster (see the module docstring).  ``seeded`` holds phase 3's
    soups by name."""
    import dataclasses

    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.cli import example_renderer
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.io import ply
    from pointcloud_render_tpu_torch.raster import csr3, csr6
    from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
    from pointcloud_render_tpu_torch.run import pipeline, trajectory

    # The kernel against its plain version, exit on and off: exact ties
    # and two wide discs; wide discs on the big list; capsules and
    # triangles on the big list (with invalid rows); entries cut to 2/3.
    for name in ("disc_ties_wide", "big_list", "invalid_nearclip"):
        res, b = compare_v3(seeded[name], WIDTH, HEIGHT, csr3, csr6,
                            what=name)
        max_err["csr3_raster"] = max(max_err["csr3_raster"], res["err"])
        print(f"[kernel==plain] csr3_raster exit on and off {name}: "
              f"{seeded[name].count} prims, {int(b['starts'][-1])} entries, "
              f"big list {int(b['big_count'])} ok", flush=True)
    soup = seeded["disc_ties_wide"]
    cap = 2 * int(csr3.true_entry_count3(soup, WIDTH, HEIGHT)) // 3
    compare_v3(soup, WIDTH, HEIGHT, csr3, csr6, cap=cap, what="ties")
    print(f"[kernel==plain] csr3_raster exit on and off disc_ties_wide, "
          f"entries cut to {cap} (2/3 of true_entries) ok", flush=True)
    # Forced splits on the tests' film: the cull's band soup, a dense
    # tile, exact ties, and 48 identical discs cut across work items in
    # front of a cover that lets the exit leave the tile (the first copy,
    # id 0, must win their pixels).
    ts = torch_soups()
    forced = {"band": ts.band_soup(), "dense_tile": ts.make_soup("dense_tile"),
              "disc_ties": ts.disc_soup(ts.tcam()),
              "tie_tile": ts.tie_tile_soup()}
    for name, small in forced.items():
        small = small.to(dev)
        res, b = compare_v3(small, ts.W, ts.H, csr3, csr6,
                            splits=(1, 7, SPLIT_FORCED), what=name)
        max_err["csr3_raster"] = max(max_err["csr3_raster"], res["err"])
        if name == "tie_tile":
            zeros = torch.zeros((small.count, 3), device=dev)
            rows = csr3.pack_rows8(small, b["entries"], b["big_ids"], zeros,
                                   zeros[:, 0], (0.0, 0.0, 0.0))
            depth, ent = csr3.raster_tiles3(
                rows[:b["entries"].shape[0]], csr6.build_table16_rows(
                    small, zeros, zeros[:, 0], b["big_ids"]), b["starts"],
                b["big_n"], b["zmeta"], ts.W, ts.H, b["zq_bits"],
                split_rows=1)
            ids = csr3.resolve_ids(ent, depth, b["entries"], b["big_ids"])
            check(int(ids[41, 40]) == 0, "csr3_raster tie_tile: the first "
                  f"copy does not win its pixel ({int(ids[41, 40])})")
        print(f"[kernel==plain] csr3_raster exit on and off {name} "
              f"({ts.W}x{ts.H}): {small.count} prims, "
              f"{int(b['starts'][-1])} entries, items of 1, 7 and "
              f"{SPLIT_FORCED} rows ok", flush=True)

    # bench.py's disc lane, as phase 7.
    n = DISC_POINTS
    pos_host = np.random.default_rng(0).uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32)
    pos = torch.tensor(pos_host, device=dev)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.002,
                                 point_color=LOOK[0])
    cfg6 = RasterConfig(discs_only=True, max_big=256, uniform_look=LOOK)
    # bench.py:407-425: 1.15 x the largest true entry count over frames
    # 0, 120, 199 and 219, rounded up to 128; no big-list overflow.
    true = {}
    for fi in (0, 120, 199, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        s = pipeline.build_primitives(preset, cam, pos, None, fi)
        true[fi] = int(csr3.true_entry_count3(s, WIDTH, HEIGHT))
        check(int(csr3.bin_diagnostics3(s, WIDTH, HEIGHT)) == 0,
              f"disc lane frame {fi}: v3 big list overflows")
    capacity = ((int(max(true.values()) * 1.15) + 127) // 128) * 128
    cfg3 = dataclasses.replace(cfg6, backend="pallas3",
                               entry_capacity=capacity)
    print(f"[v3] disc lane true entries {true}: entry_capacity {capacity}",
          flush=True)
    timed = {}
    for fi in (0, 120, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        s = pipeline.build_primitives(preset, cam, pos, None, fi)
        res, b = compare_v3(s, WIDTH, HEIGHT, csr3, csr6, cap=capacity,
                            timing=fi == 120, what=f"disc lane frame {fi}",
                            card=card, sweep=True)
        max_err["csr3_raster"] = max(max_err["csr3_raster"], res["err"])
        fb3, diag = render(s, cam, cfg3, return_diag=True)
        fb6 = render(s, cam, cfg6)
        equal_buffers(fb3, fb6, f"disc lane frame {fi}: pallas3 vs pallas6 "
                      "(uniform_look)")
        check(int(diag["true_entries"]) <= capacity, "capacity violated")
        print(f"[v3] disc lane frame {fi}: {s.count} prims, "
              f"{int(b['starts'][-1])} entries, big list "
              f"{int(b['big_count'])}; csr3_raster == plain exit on and off; "
              "pallas3 frame == pallas6 frame bit for bit (index, depth, "
              "rgb)", flush=True)
        if fi == 120:
            timed = res
            for block, ms, walked in res["blocks"]:
                print(f"[time] csr3_raster exit block {block}: device "
                      f"{ms:.3f} ms (11 calls back to back), {walked} of "
                      f"{res['entries']} entries walked ({card})", flush=True)
            print(f"[time] csr3_raster kernel {res['ms']:.3f} ms (block "
                  f"{csr3.EXIT_BLOCK}), bound {res['bound_ms']:.4f} ms by "
                  f"{res['bound_by']} ({res['walked']} of {res['entries']} "
                  f"entries walked); exit off {res['ms_exit_off']:.3f} ms, "
                  f"bound {res['bound_ms_exit_off']:.4f} ms; plain "
                  f"{res['plain_ms']:.1f} ms, at the disc lane's frame-120 "
                  f"shape ({card})", flush=True)
            print_cull_times("csr3_raster", res, "disc lane frame-120", card,
                             csr6.TILE // csr6.BAND_ROWS)

    # The flythrough through pallas3: warm-up chunk, then 220 frames.
    film = dict(frames_per_chunk=SCAN_CHUNK, width=WIDTH, height=HEIGHT,
                device="cuda")
    scan = trajectory.TrajectoryScanRenderer(preset, cfg3, **film)
    scan.render_frames(pos, None, range(SCAN_CHUNK))
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    frames, _ = scan.render_frames(pos, None, range(SCAN_FRAMES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(counters)
    check(counts == {"raster_tiles3": SCAN_FRAMES},
          f"pallas3 scan: launches {counts}, want csr3_raster once per frame")
    launches = counts["raster_tiles3"]
    check(len(frames) == SCAN_FRAMES, "pallas3 scan frames missing")
    check_ids = (0, SCAN_FRAMES // 2, SCAN_FRAMES - 1)
    want, _ = trajectory.TrajectoryScanRenderer(preset, cfg6, **film) \
        .render_frames(pos, None, check_ids)
    for fi, w in zip(check_ids, want):
        check(np.array_equal(frames[fi], w),
              f"pallas3 scan frame {fi} differs from the pallas6 scan's")
    print(f"[scan] pallas3 {SCAN_FRAMES} frames, {n} points, chunks of "
          f"{SCAN_CHUNK}: certificate 0 on every chunk (entry_capacity "
          f"{capacity}), launches {counts}, {wall:.3f} s wall, "
          f"{SCAN_FRAMES / wall:.2f} frames/s warm; frames {check_ids} == "
          f"the pallas6 scan's ({card})", flush=True)
    del frames

    # The example CLI with --backend pallas3 on two positions-only PLYs:
    # PNGs byte-equal to the default (pallas6) run's.
    inp = os.path.join(tmp, "in_example")
    os.makedirs(inp)
    for k in range(2):
        ply.write_ply(os.path.join(inp, f"pts_{k}.ply"),
                      pos_host * (1.0 + 0.1 * k))
    outs = {}
    for backend in ("pallas3", "pallas6"):
        outs[backend] = os.path.join(tmp, f"out_example_{backend}")
        reset_counts(counters)
        sink = example_renderer.main(
            ["--input-folder", inp, "--output-folder", outs[backend],
             "--frames", "0,1", "--device", "cuda", "--backend", backend])
        torch.cuda.synchronize()
        counts = launch_counts(counters)
        statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
        check(len(statuses) == 2 and all(st == "ok" for _, st, _ in statuses),
              f"example CLI {backend}: {statuses}")
        want_kernel = "raster_tiles3" if backend == "pallas3" \
            else "raster_tiles"
        check(set(counts) == {want_kernel},
              f"example CLI {backend}: launches {counts}")
        for r in sink.records:
            t = " ".join(f"{k}={v * 1e3:.1f}ms"
                         for k, v in r.timings_s.items())
            print(f"[v3 cli] example --backend {backend} frame "
                  f"{r.frame_index}: {r.points} points {t} ({card})",
                  flush=True)
    for k in range(2):
        with open(os.path.join(outs["pallas3"], f"pts_{k}.png"), "rb") as a, \
                open(os.path.join(outs["pallas6"], f"pts_{k}.png"), "rb") as b:
            check(a.read() == b.read(),
                  f"example pts_{k}.png: pallas3 differs from pallas6")
    print("[v3 cli] example preset --backend pallas3 frames 0, 1 ok; PNGs "
          "byte-equal to pallas6's", flush=True)
    return dict(timed, launches=launches)


def strip_bound(soup, entries, rows_f, pixels_per_tile, big_ids, big_n,
                n_starts, width, height, no_triangles):
    """(bound ms, "operations" | "bytes") of a v1/v2 strip walk that
    evaluated the binned entries of prim ids ``entries`` (each at every
    pixel of its tile: 4 operations per pair for a disc row, 17 for a
    capsule, 18 for a triangle through the dual unless ``no_triangles``)
    and every live big row at every pixel; bytes: those rows read once
    (``rows_f`` floats each), the big rows, the starts, two images."""
    kinds = soup.kind[entries.long()]
    n = int(kinds.numel())
    n_tri = 0 if no_triangles or rows_f == 8 else int((kinds == 2).sum())
    per_entry = (n * OPS_DISC8 if rows_f == 8
                 else n_tri * OPS_TRIANGLE16 + (n - n_tri) * OPS_CAPSULE16)
    nb = int(big_n[0])
    nb_tri = int((soup.kind[big_ids[:nb].long()] == 2).sum())
    pixels = width * height
    ops = (pixels_per_tile * per_entry
           + pixels * (nb_tri * OPS_TRIANGLE16
                       + (nb - nb_tri) * OPS_CAPSULE16))
    nbytes = n * rows_f * 4 + nb * 64 + n_starts * 4 + pixels * 4 * 2
    t_ops, t_bytes = ops / F32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_strips(soup, kernel, width=WIDTH, height=HEIGHT, cap=None,
                   max_big=1024, tile=(8, 128), mtp=None, no_triangles=False,
                   timing=False, card="", splits=None):
    """``kernel`` (csr1_raster, csr2_raster or csr2_disc8) with its exit on
    and off vs the plain strip walk (which never exits) on one soup,
    entries past ``cap`` and big prims past ``max_big`` dropped ->
    (dict(err, big_count, entries, and with ``timing``: ms, ms_exit_off,
    plain_ms, bound_ms, bound_ms_exit_off, bound_by, walked, the strip
    rows and work items; for csr2_disc8 also device_ms,
    device_ms_exit_off, bound_ms_all_pairs, bound_ms_evaluated, bytes_ms,
    bands and pixel_rows; for csr1_raster under --parent parent_ms and
    parent_ms_exit_off), (depth, index)).  Each runs at its default split
    and with its passes cut into work items of SPLIT_FORCED rows (or of
    each of ``splits``); csr2_disc8's ``bands`` must be csr.segment_rows
    with the exit off and at most that with it on.  ``mtp`` defaults to
    the kernel's JAX default (v1 8, v2 4).  csr2_disc8's bound is the pairs
    its function needs (csr.segment_rows with segments of one pixel row,
    32 pixels each; exit on: scaled by the share of rows walked) or the
    bytes; bound_ms_all_pairs every pair of the rows walked (the old
    bound), bound_ms_evaluated the (row, warp) pairs of its cull."""
    import torch

    from pointcloud_render_tpu_torch.raster import csr, csr2, csr6

    disc = kernel == "csr2_disc8"
    mtp = mtp or (8 if kernel == "csr1_raster" else 4)
    th, tw = tile
    b = csr.bin_csr(soup, width, height, th, tw, mtp, max_big,
                    force_tri_big=no_triangles or disc,
                    force_capsule_big=disc)
    starts = b["starts"]
    n_rows = int(starts[-1]) if cap is None else min(b["prims"].shape[0],
                                                     cap)
    starts = torch.clamp(starts, max=n_rows)
    pack = csr2.pack_rows_disc if disc else csr.pack_rows_generic
    rows = pack(soup, b["prims"][:n_rows], b["keys"][:n_rows], b["zmin"],
                b["span"])
    wrapper = {"csr1_raster": csr.raster_tiles1,
               "csr2_raster": csr2.raster_tiles2,
               "csr2_disc8": csr2.raster_tiles2_disc8}[kernel]
    args = (rows, starts, csr.pack_big_rows(soup, b["big_ids"]), b["big_n"],
            width, height, th, tw)
    kw = {} if disc else dict(no_triangles=no_triangles)
    want = csr.raster_strips_plain(*args, no_triangles=no_triangles)
    # A tile of more than 1024 pixels walks its rows once per 1024.
    passes = -(-th * tw // 1024)
    lengths = (starts[1:] - starts[:-1]) * passes
    kept = (csr.segment_rows(rows, starts, width, height, th, tw) if disc
            else None)
    walked = torch.empty_like(lengths)
    what = (f"{kernel} {th}x{tw} max_tiles_per_prim {mtp}"
            + (f" entry_capacity {cap}" if cap is not None else ""))
    errs = []
    for exit_on in (False, True):
        for items in (None, *(splits or (SPLIT_FORCED,))):
            extra = {} if items is None else dict(split_rows=items)
            bands = torch.full_like(lengths, -1)
            if disc:
                extra["bands"] = bands
            got = wrapper(*args, walked=walked, allow_exit=exit_on, **kw,
                          **extra)
            torch.cuda.synchronize()
            on = (f"{what} exit {'on' if exit_on else 'off'}"
                  + (f", items of {items} rows" if items else ""))
            errs.append(check_equal_bits(got, want, on))
            check(bool((walked <= lengths).all()) and (
                exit_on or torch.equal(walked, lengths)),
                f"{on}: walked {int(walked.sum())} of {int(lengths.sum())} "
                f"rows")
            if disc:
                check(bool(((bands >= 0) & (bands <= kept)).all()) and (
                    exit_on or torch.equal(bands, kept)),
                    f"{on}: (row, warp) pairs {int(bands.sum())}, "
                    f"segment_rows {int(kept.sum())}")
    out = dict(err=max(errs), big_count=int(b["big_count"]),
               entries=int(starts[-1]))
    if timing:
        check(th * tw == 1024, "timed strips must hold 1024 pixels")
        wrapper(*args, walked=walked, **kw)  # the default walk's counts
        n = int(starts[-1])
        s64 = starts.long()
        pos = torch.arange(n, device=soup.device)
        tile_of = torch.searchsorted(s64, pos, right=True) - 1
        # The bound's kinds: the first walked[t] rows of each strip (a
        # split strip's items each walk a slice: the count is exact, the
        # kinds of the rows are taken from the front of the strip).
        keep = (pos - s64[tile_of]) < walked.long()[tile_of]
        rows_f = 8 if disc else 16
        on, off = (strip_bound(soup, ids, rows_f, th * tw, b["big_ids"],
                               b["big_n"], starts.numel(), width, height,
                               no_triangles)
                   for ids in (b["prims"][:n][keep], b["prims"][:n]))
        out.update(ms=time_ms(lambda: wrapper(*args, **kw), 11),
                   ms_exit_off=time_ms(lambda: wrapper(
                       *args, allow_exit=False, **kw), 11),
                   plain_ms=time_ms(lambda: csr.raster_strips_plain(
                       *args, no_triangles=no_triangles), 2),
                   bound_ms=on[0], bound_by=on[1], bound_ms_exit_off=off[0],
                   walked=int(keep.sum()))
        if kernel == "csr1_raster" and PARENT["libs"]:
            tiles_x, tiles_y = csr.strip_grid(width, height, th, tw)
            for exit_on, key in ((1, "parent_ms"), (0, "parent_ms_exit_off")):
                out[key] = parent_time(
                    args[:4], (width, height, tiles_x, tiles_y, th, tw,
                               int(no_triangles), exit_on), width, height,
                    want, f"{what} exit {'on' if exit_on else 'off'}")
        if disc:
            n_walked = int(keep.sum())
            bands = torch.empty_like(lengths)
            wrapper(*args, bands=bands, **kw)
            pixel_rows = int(csr.segment_rows(rows, starts, width, height,
                                              th, tw, seg_rows=1).sum())
            big = big_ops(soup, b["big_ids"], b["big_n"], width, height)
            fixed = (int(b["big_n"][0]) * 64 + starts.numel() * 4
                     + width * height * 4 * 2)
            f_on = floor_bound(pixel_rows * n_walked / max(n, 1), big,
                               n_walked * 32 + fixed)
            f_off = floor_bound(pixel_rows, big, n * 32 + fixed)
            out.update(
                bound_ms=f_on[0], bound_by=f_on[1], bound_ms_exit_off=f_off[0],
                bytes_ms=f_on[2], bound_ms_all_pairs=on[0],
                bound_ms_evaluated=(int(bands.sum()) * 128 * OPS_DISC8 + big)
                / F32_OPS_PER_S * 1e3,
                device_ms=device_ms(lambda: wrapper(*args, **kw), 11),
                device_ms_exit_off=device_ms(lambda: wrapper(
                    *args, allow_exit=False, **kw), 11),
                bands=int(bands.sum()), bands_exit_off=int(kept.sum()),
                pixel_rows=pixel_rows)
    if timing:
        out.update(tile_stats_runs(starts[1:] - starts[:-1], b["big_n"],
                                   csr2.SPLIT_ROWS_DISC if disc
                                   else csr6.SPLIT_ROWS))
        sweep_rows = lengths.clone()
        timer = device_ms if disc else time_ms
        sweep = SPLIT_SWEEP_DISC if disc else SPLIT_SWEEP
        split_sweep(f"{kernel} exit off, {what}",
                    lambda w, wk: wrapper(*args, allow_exit=False,
                                          split_rows=w, walked=wk, **kw),
                    card, sweep=sweep, timer=timer)
        split_sweep(f"{kernel} exit on, {what}",
                    lambda w, wk: wrapper(*args, split_rows=w, walked=wk,
                                          **kw), card, sweep_rows,
                    sweep=sweep, timer=timer)
    return out, got


def print_strip_times(kernel, r, shape, card):
    """The [time] lines of compare_strips' numbers."""
    print(f"[time] {kernel} kernel {r['ms']:.3f} ms (median of 11), bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['walked']} of "
          f"{r['entries']} rows walked); exit off {r['ms_exit_off']:.3f} ms, "
          f"bound {r['bound_ms_exit_off']:.4f} ms; plain {r['plain_ms']:.1f} "
          f"ms (median of 2), at the {shape} shape ({card})", flush=True)
    print(f"[time] {kernel} at the {shape} shape: {stats_text(r, 'strip')} "
          f"({card})", flush=True)
    if r.get("parent_ms") is not None:
        print(f"[time] {kernel} at the {shape} shape: parent (one CTA per "
              f"strip) {r['parent_ms']:.3f} ms, exit off "
              f"{r['parent_ms_exit_off']:.3f}; change {r['ms']:.3f} ms, exit "
              f"off {r['ms_exit_off']:.3f} (medians of 11) ({card})",
              flush=True)


STRIP_KERNELS = ("csr1_raster", "csr2_raster", "csr2_disc8")


def strip_kernels_vs_plain(dev, max_err):
    """Phase 11 (a): the three strip kernels against the plain strip walk
    (see the module docstring)."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.raster import csr2, csr6
    from pointcloud_render_tpu_torch.raster.primitives import (
        ScreenPrimitives,
        discs_from_points,
    )
    from pointcloud_render_tpu_torch.raster.render import ground_plane

    seeded = soups(dev)
    seeded["disc_ties_wide"] = disc_lane_soup(dev)
    for name, soup in seeded.items():
        for kernel in STRIP_KERNELS:
            for no_tri in ((False,) if kernel == "csr2_disc8"
                           else (False, True)):
                r, _ = compare_strips(soup, kernel, no_triangles=no_tri)
                max_err[kernel] = max(max_err[kernel], r["err"])
        print(f"[kernel==plain] csr1_raster, csr2_raster (no_triangles off "
              f"and on), csr2_disc8 exit on and off {name}: {soup.count} "
              f"prims ok (items of the default and of {SPLIT_FORCED} rows)",
              flush=True)
    # 1,500 wide discs: v1 takes them all (max_big 2048); v2's fixed big
    # list drops those past 1024, as does its plain version.
    cam = soup_camera(dev)
    rng = np.random.default_rng(2029)
    wide = torch.tensor(rng.uniform(-0.4, 0.4, (1500, 3)).astype(np.float32),
                        device=dev)
    small = torch.tensor(rng.uniform(-0.5, 0.5, (20000, 3)).astype(
        np.float32), device=dev)
    gray = np.asarray(LOOK[0], np.float32)
    soup = ScreenPrimitives.concatenate([
        ground_plane(cam, 10.0, (0.0, 0.0, -0.5)),
        discs_from_points(wide, cam, torch.full((1500,), 0.15, device=dev),
                          gray),
        discs_from_points(small, cam, torch.full((20000,), 0.01, device=dev),
                          gray)])
    r1, got1 = compare_strips(soup, "csr1_raster", max_big=2048)
    r2, got2 = compare_strips(soup, "csr2_raster")
    check(r1["big_count"] > 1024, f"only {r1['big_count']} wide prims")
    check(not torch.equal(got1[1], got2[1]),
          "v2's cut at 1024 big prims changed no pixel")
    max_err["csr1_raster"] = max(max_err["csr1_raster"], r1["err"])
    max_err["csr2_raster"] = max(max_err["csr2_raster"], r2["err"])
    print(f"[kernel==plain] {r1['big_count']} big prims: csr1_raster at "
          "max_big 2048 and csr2_raster cut at 1024 ok; the cut changes "
          f"{int((got1[1] != got2[1]).sum())} pixels", flush=True)
    # Entries cut below true_entries, and strips of other shapes (16x256:
    # four passes of 1024 pixels per tile; 4x32).
    for name in ("mixed", "disc_ties_wide"):
        soup = seeded[name]
        for kernel in STRIP_KERNELS[1:]:
            true = int(csr2.true_entry_count(
                soup, WIDTH, HEIGHT, no_triangles=kernel == "csr2_disc8"))
            r, _ = compare_strips(soup, kernel, cap=2 * true // 3)
            max_err[kernel] = max(max_err[kernel], r["err"])
            for tile in ((16, 256), (4, 32)):
                r, _ = compare_strips(soup, kernel, tile=tile, mtp=8)
                max_err[kernel] = max(max_err[kernel], r["err"])
        print(f"[kernel==plain] csr2_raster, csr2_disc8 {name}: entries cut "
              "to 2/3 of true_entries, strips of 16x256 and 4x32 ok",
              flush=True)
    # csr2_disc8's forced splits and cull on the tests' film: discs tangent
    # to the warps' row bands and column segments, a dense tile, exact
    # ties, at strips of 8x128, 16x256 and 4x32.
    ts = torch_soups()
    forced = {"band": ts.band_soup(), "segment": ts.segment_soup(),
              "dense_tile": ts.make_soup("dense_tile"),
              "disc_ties": ts.disc_soup(ts.tcam())}
    for name, small in forced.items():
        small = small.to(dev)
        for tile, mtp in (((8, 128), 4), ((16, 256), 8), ((4, 32), 8)):
            r, _ = compare_strips(small, "csr2_disc8", ts.W, ts.H, tile=tile,
                                  mtp=mtp, splits=(1, 7, SPLIT_FORCED))
            max_err["csr2_disc8"] = max(max_err["csr2_disc8"], r["err"])
        print(f"[kernel==plain] csr2_disc8 exit on and off {name} "
              f"({ts.W}x{ts.H}): {small.count} prims, strips of 8x128, "
              f"16x256 and 4x32, items of 1, 7 and {SPLIT_FORCED} rows ok",
              flush=True)
    # csr1_raster's forced splits on the tests' film, with binned triangles
    # and without: a dense tile, exact ties, and 48 identical discs in one
    # strip's run, cut across items in front of a cover that lets the exit
    # leave the deep rows (the first copy, id 0, must win their pixels).
    forced = {"dense_tile": ts.make_soup("dense_tile"),
              "mixed": ts.make_soup("mixed"),
              "disc_ties": ts.disc_soup(ts.tcam()),
              "tie_tile": ts.tie_tile_soup()}
    for name, small in forced.items():
        small = small.to(dev)
        for tile in ((8, 128), (16, 256)):
            for no_tri in (False, True):
                r, got = compare_strips(small, "csr1_raster", ts.W, ts.H,
                                        tile=tile, no_triangles=no_tri,
                                        splits=(1, 7, SPLIT_FORCED))
                max_err["csr1_raster"] = max(max_err["csr1_raster"],
                                             r["err"])
                if name == "tie_tile":
                    check(int(got[1][41, 40]) == 0
                          and float(got[0][41, 40]) == 0.5,
                          f"csr1_raster tie_tile {tile}: id "
                          f"{int(got[1][41, 40])} wins the tied pixel")
        print(f"[kernel==plain] csr1_raster exit on and off {name} "
              f"({ts.W}x{ts.H}): {small.count} prims, strips of 8x128 and "
              f"16x256, no_triangles off and on, items of 1, 7 and "
              f"{SPLIT_FORCED} rows ok", flush=True)


def v2_flagship(card, dev, inp, out_default, out_v2, counters, max_err):
    """Phase 11 (b): the traj_ball CLI with --backend pallas on phase 5's
    PLYs -> {kernel: numbers} of csr2_raster and csr1_raster."""
    import torch

    from pointcloud_render_tpu_torch.cli import traj_ball_renderer
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import csr, csr2
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline

    frames = (10, 120)
    reset_counts(counters)
    sink = traj_ball_renderer.main(
        ["--input-folder", inp, "--output-folder", out_v2, "--frames",
         ",".join(map(str, frames)), "--device", "cuda", "--backend",
         "pallas"])
    torch.cuda.synchronize()
    counts = launch_counts(counters)
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == 2 and all(s == "ok" for _, s, _ in statuses),
          f"pallas frame records not all ok: {statuses}")
    check(counts == {"raster_tiles2": 2},
          f"pallas CLI: launches {counts}, want csr2_raster once per frame")
    for fi in frames:
        name = f"frame_{fi:04d}_b0.png"
        with open(os.path.join(out_default, name), "rb") as f, \
                open(os.path.join(out_v2, name), "rb") as g:
            check(f.read() == g.read(),
                  f"pallas {name} differs from the pallas6 frame")
    for r in sink.records:
        t = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in r.timings_s.items())
        print(f"[v2 cli] frame {r.frame_index}: {r.points} points {t} "
              f"({card})", flush=True)
    print(f"[v2 cli] traj_ball --backend pallas frames 10, 120: PNGs equal "
          f"the pallas6 run's byte for byte; launches {counts}", flush=True)
    preset = PRESETS["traj_ball"]
    # Frame 205 (the frame-199 cloud): v2's big list decides.
    p6 = pipeline.FramePipeline(preset, device=dev)
    p2 = pipeline.FramePipeline(preset, RasterConfig(backend="pallas"),
                                device=dev)
    pcl = p6.load_and_prepare(os.path.join(inp, "frame_0199_b0.ply"))
    cam = pipeline.frame_camera(preset, 205, WIDTH, HEIGHT, dev)
    soup = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:], 205)
    ovf = int(csr.bin_diagnostics(soup, WIDTH, HEIGHT, max_big=1024,
                                  no_triangles=True))
    big = ovf + 1024 if ovf else int(csr.bin_csr(
        soup, WIDTH, HEIGHT, force_tri_big=True)["big_count"])
    if ovf == 0:
        equal_buffers(p2.render_array(pcl, 205), p6.render_array(pcl, 205),
                      "traj_ball frame 205: pallas vs pallas6")
        print(f"[v2] traj_ball frame 205: v2 big list {big} <= 1024; the "
              "pallas frame equals the pallas6 frame (depth bits, index, "
              "rgb)", flush=True)
    else:
        try:
            p2.render_array(pcl, 205)
        except RuntimeError as e:
            check("after capacity retries" in str(e),
                  f"unexpected RuntimeError: {e}")
            print(f"[v2] traj_ball frame 205: v2 big list {big} > 1024 (the "
                  "JAX package never forwards max_big to v2): FramePipeline "
                  f"raised the JAX package's RuntimeError after its retries "
                  f"(max_big -> {p2.raster_config.max_big}, no effect)",
                  flush=True)
        else:
            raise SmokeFailure(f"frame 205: {big} v2 big prims rendered")
    # csr2_raster at frame 205's shape (its big list cut at 1024, as the
    # plain walk's).
    r, _ = compare_strips(soup, "csr2_raster", mtp=8, no_triangles=True,
                          timing=True, card=card)
    max_err["csr2_raster"] = max(max_err["csr2_raster"], r["err"])
    print_strip_times("csr2_raster", r, "traj_ball frame-205", card)
    # The kernels beside their plain versions at frame 120's shape.
    pcl = p6.load_and_prepare(os.path.join(inp, "frame_0120_b0.ply"))
    cam = pipeline.frame_camera(preset, 120, WIDTH, HEIGHT, dev)
    soup = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:], 120)
    timed = {}
    for kernel in ("csr2_raster", "csr1_raster"):
        r, got = compare_strips(soup, kernel, mtp=8, no_triangles=True,
                                timing=True, card=card)
        max_err[kernel] = max(max_err[kernel], r["err"])
        timed[kernel] = (r, got)
        print_strip_times(kernel, r, "traj_ball frame-120", card)
    for a, b in zip(timed["csr1_raster"][1], timed["csr2_raster"][1]):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              "csr1_raster and csr2_raster differ at traj_ball frame 120")
    # v1's path: rasterize_csr, once, counted.
    reset_counts(counters)
    d1, i1, diag = csr.rasterize_csr(soup, WIDTH, HEIGHT, no_triangles=True)
    torch.cuda.synchronize()
    v1_counts = launch_counts(counters)
    check(v1_counts == {"raster_tiles1": 1}, f"rasterize_csr: {v1_counts}")
    check(int(diag["big_overflow"]) == 0 and torch.equal(
        i1, timed["csr2_raster"][1][1]), "rasterize_csr's frame differs")
    print("[v2] traj_ball frame 120: csr1_raster == csr2_raster (depth bits, "
          f"index); rasterize_csr launches {v1_counts}", flush=True)
    return dict(csr2_raster=dict(timed["csr2_raster"][0],
                                 launches=counts["raster_tiles2"]),
                csr1_raster=dict(timed["csr1_raster"][0],
                                 launches=v1_counts["raster_tiles1"]))


def v2_disc_lane(card, dev, max_err, counters) -> dict:
    """Phase 11 (c): bench.py's disc lane through backend pallas -> the
    numbers of csr2_disc8 (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import csr2
    from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
    from pointcloud_render_tpu_torch.run import pipeline, trajectory

    n = DISC_POINTS
    pos = torch.tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32), device=dev)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.002,
                                 point_color=LOOK[0])
    # bench.py:427-445: 1.15 x the largest true entry count over frames
    # 0, 120, 199 and 219 (max_tiles_per_prim 4, no_triangles), rounded
    # up to 128; :468-481: discs_only, no_triangles, no uniform_look.
    true = {}
    for fi in (0, 120, 199, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        s = pipeline.build_primitives(preset, cam, pos, None, fi)
        true[fi] = int(csr2.true_entry_count(s, WIDTH, HEIGHT,
                                             max_tiles_per_prim=4,
                                             no_triangles=True))
    capacity = ((int(max(true.values()) * 1.15) + 127) // 128) * 128
    cfg2 = RasterConfig(backend="pallas", max_tiles_per_prim=4,
                        no_triangles=True, discs_only=True,
                        entry_capacity=capacity)
    cfg6 = RasterConfig(discs_only=True, max_big=256)
    print(f"[v2] disc lane true entries {true}: entry_capacity {capacity}",
          flush=True)
    timed = {}
    for fi in (0, 120, SCAN_FRAMES - 1):
        cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        s = pipeline.build_primitives(preset, cam, pos, None, fi)
        r, _ = compare_strips(s, "csr2_disc8", cap=capacity,
                              timing=fi == 120, card=card)
        max_err["csr2_disc8"] = max(max_err["csr2_disc8"], r["err"])
        fb2, diag = render(s, cam, cfg2, return_diag=True)
        equal_buffers(fb2, render(s, cam, cfg6),
                      f"disc lane frame {fi}: pallas vs pallas6")
        check(int(diag["true_entries"]) <= capacity
              and int(diag["big_overflow"]) == 0, "certificate not 0")
        print(f"[v2] disc lane frame {fi}: {s.count} prims, {r['entries']} "
              f"entries, big list {r['big_count']}; csr2_disc8 == plain exit "
              "on and off; pallas frame == pallas6 frame bit for bit",
              flush=True)
        if fi == 120:
            timed = r
            print_strip_times("csr2_disc8", r, "disc lane frame-120", card)
            print_cull_times("csr2_disc8", r, "disc lane frame-120", card, 8)
    film = dict(frames_per_chunk=SCAN_CHUNK, width=WIDTH, height=HEIGHT,
                device="cuda")
    scan = trajectory.TrajectoryScanRenderer(preset, cfg2, **film)
    scan.render_frames(pos, None, range(SCAN_CHUNK))
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    frames, _ = scan.render_frames(pos, None, range(SCAN_FRAMES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(counters)
    check(counts == {"raster_tiles2_disc8": SCAN_FRAMES},
          f"pallas scan: launches {counts}, want csr2_disc8 once per frame")
    want, _ = trajectory.TrajectoryScanRenderer(preset, cfg6, **film) \
        .render_frames(pos, None, range(SCAN_FRAMES))
    for fi, (a, w) in enumerate(zip(frames, want)):
        check(np.array_equal(a, w),
              f"pallas scan frame {fi} differs from the pallas6 scan's")
    print(f"[scan] pallas {SCAN_FRAMES} frames, {n} points, chunks of "
          f"{SCAN_CHUNK}: certificate 0 on every chunk (entry_capacity "
          f"{capacity}), launches {counts}, {wall:.3f} s wall, "
          f"{SCAN_FRAMES / wall:.2f} frames/s warm; all frames == the "
          f"pallas6 scan's without uniform_look ({card})", flush=True)
    return dict(timed, launches=counts["raster_tiles2_disc8"])


def v5_bound(soup, b, tab, walked, width, height, n_images):
    """The bounds of one v5 walk in which tile t evaluates the first
    ``walked[t]`` superrows of its run -> dict(bound_ms, bound_by,
    bound_ms_all_pairs, bytes_ms, live_slots, pixel_rows).  bound_ms: the
    pairs the function needs, each live slot of those superrows (a finite
    depth: not a pad slot of a singleton row or a chunk's tail, nor an
    inert slot of a non-binnable prim, which the plain walk drops) at the
    pixel rows of its 32 x 32 tile whose exact dy test it passes
    (csr6.band_keeps with bands of one row), 32 pixels each at OPS_DISC5,
    and every pixel x every live big row at its body's operations; or the
    bytes where larger: the live slots (32 B each) and chunk id of each
    walked superrow, the big rows (17 floats and a kind), the range
    starts, ``n_images`` output floats per pixel.  bound_ms_all_pairs:
    1024 pixels x each live slot instead (the bound of its history)."""
    import torch

    from pointcloud_render_tpu_torch.raster import csr5, csr6

    starts = b["starts"].long()
    lengths = starts[1:] - starts[:-1]
    n = int(starts[-1])
    tile = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=starts.device), lengths)
    offset = torch.arange(n, device=starts.device) - starts[:-1][tile]
    sel = offset < walked.long()[tile]
    rows = b["chunks"][:n][sel].long()
    live_per_row = (tab[:, 2::8] < float("inf")).sum(dim=1)
    slots = int(live_per_row[rows].sum())
    nb = int(b["big_n"][0])
    n_tri = int((soup.kind[b["big_list"][:nb].long()] == 2).sum())
    pixels = width * height
    big = pixels * (n_tri * OPS_TRIANGLE16 + (nb - n_tri) * OPS_CAPSULE16)
    nbytes = (slots * 32 + rows.numel() * 4 + nb * (17 * 4 + 4)
              + b["starts"].numel() * 4 + pixels * 4 * n_images)
    all_pairs = max((1024 * slots * OPS_DISC5 + big) / F32_OPS_PER_S * 1e3,
                    nbytes / BYTES_PER_S * 1e3)
    # The live slots' pixel rows: their tile's 32 rows inside the image.
    tiles_x = csr5.grid5(width, height, csr6.TILE, csr6.TILE)[0]
    sl = tab[rows].reshape(rows.numel(), -1, 8)
    py, r, live = sl[..., 1], sl[..., 3], sl[..., 2] < float("inf")
    r2 = r * r
    ty = (tile[sel] // tiles_x)[:, None]
    pixel_rows = 0
    for k in range(csr6.TILE):
        y = ty * csr6.TILE + k
        keep = csr6.band_keeps(py, r2, y.to(torch.float32) + 0.5, band=1)
        pixel_rows += int((keep & live & (y < height)).sum())
    bound, by, t_bytes = floor_bound(pixel_rows, big, nbytes)
    return dict(bound_ms=bound, bound_by=by, bound_ms_all_pairs=all_pairs,
                bytes_ms=t_bytes, live_slots=slots, pixel_rows=pixel_rows)


def compare_v5(soup, cam, width, height, max_big, uniform=None,
               timing=False, card="", sweep=False):
    """csr5_raster and csr5_shaded (``uniform`` the uniform color, or None)
    vs their plain version, each with its tiles cut into items of
    csr6.SPLIT_ROWS5 and of SPLIT_FORCED rows and its exit on and off ->
    ({kernel name: dict(err[, timing keys])}, binning); ``walked`` never
    passes a tile's run and is the whole run with the exit off, ``bands``
    csr5.block_slots5 with the exit off and at most that with it on.
    With ``timing``: ms and device_ms (exit on and off), plain_ms, the
    bounds of v5_bound over the superrows walked (exit on) and over all
    (exit off), bound_ms_evaluated (the (slot, warp block) pairs the cull
    kept with the exit on, 128 pixels each), the cull's kept share with
    the exit off and the tile rows and work items; with ``sweep`` the
    split sweep."""
    import torch

    from pointcloud_render_tpu_torch.raster import csr5, csr6
    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    shading = ShadingConfig()
    b = csr5.bin_chunks5(soup, width, height, max_big=max_big)
    check(int(b["diag"]["big_overflow"]) == 0, "v5 big list overflowed")
    rgb_p, _ = csr6.preshade(soup, cam, shading)
    tab, bp, kinds, meta = csr5.tables5(
        soup, b, rgb_p, csr5.look5(soup, cam, shading, uniform))
    args = (tab, b["chunks"], b["starts"], bp, kinds, b["big_n"], meta,
            width, height)
    lengths = b["starts"][1:] - b["starts"][:-1]
    kept = csr5.block_slots5(tab, b["chunks"], b["starts"], width, height)
    n = int(b["starts"][-1])
    out = {}
    for name, kernel, fused, kw in (
            ("csr5_raster", csr5.raster_tiles5, False, {}),
            ("csr5_shaded", csr5.raster_tiles5_shaded, True,
             {"uniform": uniform is not None})):
        want = csr5.raster_tiles5_plain(*args, fused=fused, **kw)
        errs = []
        for split in (csr6.SPLIT_ROWS5, SPLIT_FORCED):
            for exit_on in (True, False):
                walked = torch.full_like(lengths, -1)
                bands = torch.full_like(lengths, -1)
                got = kernel(*args, allow_exit=exit_on, walked=walked,
                             bands=bands, split_rows=split, **kw)
                torch.cuda.synchronize()
                on = (f"{name} exit {'on' if exit_on else 'off'}, items of "
                      f"{split} rows")
                errs.append(check_equal_bits(got, want, on))
                check(bool(((walked >= 0) & (walked <= lengths)).all())
                      and (exit_on or torch.equal(walked, lengths)),
                      f"{on}: walked {int(walked.sum())} of {n} superrows")
                check(bool(((bands >= 0) & (bands <= kept)).all())
                      and (exit_on or torch.equal(bands, kept)),
                      f"{on}: kept pairs {int(bands.sum())}, block_slots5 "
                      f"{int(kept.sum())}")
        out[name] = dict(err=max(errs))
        if timing:
            walked = torch.empty_like(lengths)
            bands = torch.empty_like(lengths)
            kernel(*args, walked=walked, bands=bands, **kw)
            rows = int(walked.sum())
            on = v5_bound(soup, b, tab, walked, width, height,
                          5 if fused else 2)
            off = v5_bound(soup, b, tab, lengths, width, height,
                           5 if fused else 2)
            big = big_ops(soup, b["big_list"], b["big_n"], width, height)
            out[name].update(
                ms=time_ms(lambda k=kernel: k(*args, **kw), 11),
                device_ms=device_ms(lambda k=kernel: k(*args, **kw), 11),
                ms_exit_off=time_ms(
                    lambda k=kernel: k(*args, allow_exit=False, **kw), 11),
                device_ms_exit_off=device_ms(
                    lambda k=kernel: k(*args, allow_exit=False, **kw), 11),
                plain_ms=time_ms(lambda: csr5.raster_tiles5_plain(
                    *args, fused=fused, **kw), 1),
                bound_ms=on["bound_ms"], bound_by=on["bound_by"],
                bound_ms_exit_off=off["bound_ms"],
                bound_ms_all_pairs=on["bound_ms_all_pairs"],
                bound_ms_evaluated=(int(bands.sum()) * 128 * OPS_DISC5 + big)
                / F32_OPS_PER_S * 1e3,
                bytes_ms=on["bytes_ms"], entries=n, walked=rows,
                live_slots=on["live_slots"],
                live_slots_exit_off=off["live_slots"],
                pixel_rows=on["pixel_rows"], bands=int(bands.sum()),
                bands_exit_off=int(kept.sum()),
                **tile_stats_runs(lengths, b["big_n"], csr6.SPLIT_ROWS5))
        if sweep:
            split_sweep(f"{name} exit on, disc lane frame 120 in Morton "
                        "order, device time",
                        lambda w, wk, k=kernel: k(*args, split_rows=w,
                                                  walked=wk, **kw),
                        card, lengths, sweep=SPLIT_SWEEP5, timer=device_ms)
            split_sweep(f"{name} exit off, disc lane frame 120 in Morton "
                        "order, device time",
                        lambda w, wk, k=kernel: k(*args, allow_exit=False,
                                                  split_rows=w, walked=wk,
                                                  **kw),
                        card, sweep=SPLIT_SWEEP5, timer=device_ms)
    return out, b


def print_v5_times(name, r, card):
    """The [time] lines of compare_v5's numbers at the disc lane's frame
    120 in Morton order."""
    shape = "the disc lane's frame-120 shape in Morton order"
    print(f"[time] {name} kernel {r['ms']:.3f} ms (median of 11; device "
          f"{r['device_ms']:.3f}), bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']} (the pairs needed: {r['pixel_rows']} slot pixel "
          f"rows of 32 pixels; bytes {r['bytes_ms']:.4f}; the pairs the cull "
          f"kept {r['bound_ms_evaluated']:.4f}; every pair of the live slots "
          f"{r['bound_ms_all_pairs']:.4f}) ({r['walked']} of {r['entries']} "
          f"superrows walked before the exits, "
          f"{r['walked'] / r['entries']:.3f}, holding {r['live_slots']} live "
          f"slots); exit off {r['ms_exit_off']:.3f} ms (device "
          f"{r['device_ms_exit_off']:.3f}), bound "
          f"{r['bound_ms_exit_off']:.4f} ms ({r['live_slots_exit_off']} live "
          f"slots); plain {r['plain_ms']:.1f} ms, at {shape} ({card})",
          flush=True)
    share = 100.0 * r["bands_exit_off"] / max(8 * r["live_slots_exit_off"],
                                              1)
    print(f"[time] {name} at {shape}: {stats_text(r)}; the cull keeps "
          f"{r['bands_exit_off']} of {8 * r['live_slots_exit_off']} (live "
          f"slot, warp block) pairs ({share:.1f}%) with every superrow "
          f"walked, {r['bands']} with the exit ({card})", flush=True)


def v5_stages(csr5, csr6, pipeline, preset, pos, fi, dev):
    """The stages of one v5 frame from the Morton-sorted cloud, in the
    order render_shaded_csr5 runs them (uniform_color)."""
    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    shading = ShadingConfig()

    def build(f):
        f["cam"] = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        f["soup"] = pipeline.build_primitives(preset, f["cam"], pos, None,
                                              fi)

    def preshade(f):
        f["rgb"], _ = csr6.preshade(f["soup"], f["cam"], shading)

    def binning(f):
        f["b"] = csr5.bin_chunks5(f["soup"], WIDTH, HEIGHT)

    def tables(f):
        f["tab"], f["bp"], f["kinds"], f["meta"] = csr5.tables5(
            f["soup"], f["b"], f["rgb"],
            csr5.look5(f["soup"], f["cam"], shading, LOOK[0]))

    def kernel(f):
        b = f["b"]
        f["out"] = csr5.raster_tiles5_shaded(
            f["tab"], b["chunks"], b["starts"], f["bp"], f["kinds"],
            b["big_n"], f["meta"], WIDTH, HEIGHT, uniform=True)

    return [("camera+soup build", build), ("preshade", preshade),
            ("bin_chunks5 (reduces, sort, starts, big list)", binning),
            ("chunk table + big rows + meta", tables),
            ("csr5_shaded kernel", kernel),
            ("overflow read-back",
             lambda f: int(f["b"]["diag"]["big_overflow"]))]


def v5_lane(card, dev, max_err, counters, seeded) -> dict:
    """Phase 12, the v5 slice -> {kernel name: dict(launches, ms, plain_ms,
    bound_ms, bound_by, ms_exit_off, bound_ms_exit_off)} for csr5_raster
    and csr5_shaded.  bench.py's disc lane (1M gray splats of radius
    0.002 and the ground, positions uniform from seed 0) put in Morton
    order by the port's spatial_sort, frames 0, 120, 199 and 219 through
    render_shaded_csr5(uniform_color=gray) at default knobs; ``seeded``
    are phase 3's soups."""
    import dataclasses

    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import csr5, csr6
    from pointcloud_render_tpu_torch.run import pipeline
    from pointcloud_render_tpu_torch.scene import spatial
    from pointcloud_render_tpu_torch.shading.shade import (
        ShadingConfig,
        shade_framebuffer,
    )

    pos = torch.tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (DISC_POINTS, 3)).astype(np.float32), device=dev)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.002,
                                 point_color=LOOK[0])
    shading = ShadingConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos, _ = spatial.spatial_sort(pos)
    torch.cuda.synchronize()
    morton_ms = (time.perf_counter() - t0) * 1e3
    print(f"[v5] Morton order of {DISC_POINTS} points (host codes, the "
          f"permutation on the card): {morton_ms:.1f} ms, once per cloud "
          f"({card})", flush=True)
    cams, soups, stats = {}, {}, {}
    for fi in V5_FRAMES:
        cams[fi] = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
        soups[fi] = pipeline.build_primitives(preset, cams[fi], pos, None, fi)
        b = csr5.bin_chunks5(soups[fi], WIDTH, HEIGHT)
        stats[fi] = dict(entries=int(b["starts"][-1]),
                         spills=int(b["sok"].sum()),
                         wide=int(b["srank"][-1]) + 1,
                         big=int(b["big_count"]),
                         big_overflow=int(b["diag"]["big_overflow"]))
        s = stats[fi]
        print(f"[v5] frame {fi}: {soups[fi].count} prims, chunk entries "
              f"{s['entries']}, singleton spills {s['spills']} (discs of "
              f"wide chunks {s['wide']}), big list {s['big']}, big_overflow "
              f"{s['big_overflow']} (max_big {csr5.DEFAULT_MAX_BIG})",
              flush=True)
    check(stats[120]["big_overflow"] == 0,
          f"v5 frame 120 overflows its big list: {stats[120]}")

    # The main path: the four frames through render_shaded_csr5.
    torch.cuda.synchronize()
    reset_counts(counters)
    frames = {fi: csr5.render_shaded_csr5(
        soups[fi], cams[fi], shading, uniform_color=LOOK[0],
        return_diag=True) for fi in V5_FRAMES}
    torch.cuda.synchronize()
    counts = launch_counts(counters)
    check(counts == {"raster_tiles5_shaded": len(V5_FRAMES)},
          f"v5 frames: launches {counts}, want csr5_shaded once per frame")
    for fi, (rgb, depth, index, diag) in frames.items():
        check(rgb.shape == (HEIGHT, WIDTH, 3)
              and bool(torch.isfinite(rgb).all())
              and bool((index >= 0).any()), f"v5 frame {fi} malformed")
        check(int(diag["big_overflow"]) == stats[fi]["big_overflow"],
              f"v5 frame {fi}: the render's certificate differs")
        if stats[fi]["big_overflow"]:
            print(f"[v5] frame {fi}: big list overflows (the JAX package's "
                  "truncated render): not compared with pallas6", flush=True)
            continue
        d6, i6, diag6 = csr6.rasterize_csr6(soups[fi], WIDTH, HEIGHT,
                                            max_big=1 << 14, discs_only=True)
        check(int(diag6["big_overflow"]) == 0, "pallas6 big list overflowed")
        check(torch.equal(depth.view(torch.int32), d6.view(torch.int32))
              and torch.equal(index, i6),
              f"v5 frame {fi} differs from the pallas6 frame")
        ref = shade_framebuffer(soups[fi], cams[fi], depth, index, shading)
        check(torch.equal(rgb.view(torch.int32), ref.view(torch.int32)),
              f"v5 frame {fi}: rgb differs from shade_framebuffer")
        print(f"[v5] frame {fi}: depth bits and index == the pallas6 frame, "
              "rgb == shade_framebuffer bit for bit", flush=True)
    del frames

    # csr5_raster's entry point once.
    reset_counts(counters)
    depth, index = csr5.rasterize_csr5(soups[120], WIDTH, HEIGHT)
    torch.cuda.synchronize()
    raster_counts = launch_counts(counters)
    check(raster_counts == {"raster_tiles5": 1},
          f"rasterize_csr5: launches {raster_counts}, want csr5_raster once")
    d6, i6, _ = csr6.rasterize_csr6(soups[120], WIDTH, HEIGHT,
                                    max_big=1 << 14, discs_only=True)
    check(torch.equal(depth.view(torch.int32), d6.view(torch.int32))
          and torch.equal(index, i6),
          "rasterize_csr5 at frame 120 differs from the pallas6 frame")

    # Kernel == plain at frame 120, timed; and on phase 3's soups in their
    # order and in Morton order.
    timed, b = compare_v5(soups[120], cams[120], WIDTH, HEIGHT,
                          csr5.DEFAULT_MAX_BIG, LOOK[0], timing=True,
                          card=card, sweep=True)
    for name, r in timed.items():
        max_err[name] = max(max_err[name], r["err"])
        print_v5_times(name, r, card)
    cam = soup_camera(dev)
    morton_soup = torch_soups().morton_soup
    for name, soup in seeded.items():
        for order, s in (("original", soup), ("Morton", morton_soup(soup))):
            res, b = compare_v5(s, cam, WIDTH, HEIGHT, 1 << 16)
            for kernel, r in res.items():
                max_err[kernel] = max(max_err[kernel], r["err"])
            print(f"[kernel==plain] csr5_raster, csr5_shaded {name} "
                  f"({order} order): {s.count} prims, "
                  f"{int(b['starts'][-1])} entries, {int(b['sok'].sum())} "
                  f"spills, big list {int(b['big_count'])}; exit on and off "
                  "ok", flush=True)

    # One warm frame: stages and ms/frame.
    for stage, ms in stage_times(v5_stages(csr5, csr6, pipeline, preset,
                                           pos, 120, dev)).items():
        print(f"[stage] v5 frame 120 {stage}: {ms:.3f} ms ({card})",
              flush=True)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        cam = pipeline.frame_camera(preset, 120, WIDTH, HEIGHT, dev)
        csr5.render_shaded_csr5(
            pipeline.build_primitives(preset, cam, pos, None, 120), cam,
            shading, uniform_color=LOOK[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times[1:], n=4)
    print(f"[time] v5 frame 120 (soup build + render_shaded_csr5) warm: "
          f"median {med:.2f} ms, quartiles {q1:.2f}-{q3:.2f} ms over 5 "
          f"frames ({card})", flush=True)

    # B4: the disc-row kernels at spans 4 and 8 on the same frame, and
    # their entry point: render_shaded_csr6(discs_only, span) fused under
    # uniform_look, one csr6_disc8_uv launch, == its plain walk.
    _, flag = csr6.preshade(soups[120], cams[120], shading)
    for span in (4, 8):
        res, b = compare_disc(soups[120], flag, WIDTH, HEIGHT, csr6, 256,
                              timing=True, span=span, card=card)
        for kernel, r in res.items():
            max_err[kernel] = max(max_err[kernel], r["err"])
            print_disc_times(f"{kernel} span {span}", r,
                             f"disc lane's frame-120 (big list "
                             f"{int(b['big_count'])})", card)
        torch.cuda.synchronize()
        reset_counts(counters)
        got = csr6.render_shaded_csr6(soups[120], cams[120], shading,
                                      max_big=256, discs_only=True,
                                      uniform_look=LOOK, span=span)
        torch.cuda.synchronize()
        span_counts = launch_counts(counters)
        check(span_counts == {"raster_tiles_disc8_uv": 1},
              f"render_shaded_csr6 at span {span}: launches {span_counts}, "
              "want csr6_disc8_uv once")
        want = csr6.render_shaded_csr6(soups[120], cams[120], shading,
                                       max_big=256, discs_only=True,
                                       uniform_look=LOOK, span=span,
                                       plain=True)
        check(int(got[3]["big_overflow"]) == 0,
              f"span {span}: the big list overflowed")
        check_equal_bits((got[1], got[2], got[0]), (want[1], want[2], want[0]),
                         f"render_shaded_csr6 discs_only span {span}")
        print(f"[B4] render_shaded_csr6(discs_only, uniform_look, span "
              f"{span}) at the disc lane's frame 120: one csr6_disc8_uv "
              "launch; rgb, depth and index == the plain walk bit for bit",
              flush=True)
    return dict(csr5_raster=dict(timed["csr5_raster"], launches=raster_counts[
                    "raster_tiles5"]),
                csr5_shaded=dict(timed["csr5_shaded"],
                                 launches=counts["raster_tiles5_shaded"]))


def fidelity_phase(card, dev, counters):
    """Phase 13: the fidelity certificate of trail segments and rows9 on
    the card (see the module docstring)."""
    import torch

    from pointcloud_render_tpu_torch.utils import fidelity, tuned

    with open(os.path.join(REPO, FIDELITY_RECORDS)) as f:
        records = json.load(f)
    t0 = time.perf_counter()
    reset_counts(counters)
    rates = {}
    for preset in FIDELITY_LANES.values():
        for segs in FIDELITY_SEGMENTS:
            for rows9 in (False, True):
                rates[preset, segs, rows9] = fidelity.trail_segments_flip_rate(
                    segs, preset_name=preset,
                    capsule_eval="cap8" if rows9 else "cap10",
                    capsule_span=FIDELITY_SPAN, device=dev, **FIDELITY_SCENE)
    decomp = fidelity.trail_flip_decomposition(
        4, preset_name="traj_vel", device=dev, **FIDELITY_SCENE)
    torch.cuda.synchronize()
    counts = launch_counts(counters)
    check(set(counts) == {"raster_tiles", "raster_tiles_rows9"},
          f"fidelity certificate: launches {counts}, want csr6_raster and "
          "csr6_rows9")
    print(f"[fidelity] {len(rates)} certificate runs and a decomposition at "
          f"{FIDELITY_SCENE['n_points']} points, "
          f"{FIDELITY_SCENE['width']}x{FIDELITY_SCENE['height']}, frames "
          f"{FIDELITY_SCENE['frames']} in {time.perf_counter() - t0:.1f} s; "
          f"launches {counts} ({card})", flush=True)
    limits = {}
    for preset in FIDELITY_LANES.values():
        limits[preset] = fidelity.flip_limit(
            rates[preset, fidelity.DEFAULT_SEGMENTS, False]["trail_rate"])
        jax_rates = records["scenes"][preset]["rates"]
        for (p, segs, rows9), r in rates.items():
            if p != preset:
                continue
            key = f"{segs}+rows8" if rows9 else str(segs)
            jr = jax_rates[key]
            mode = f"rows9 span {FIDELITY_SPAN}" if rows9 else "exact"
            print(f"[fidelity] {preset} segments {segs} {mode}: frame_rate "
                  f"{r['frame_rate']:.6g} trail_rate {r['trail_rate']:.6g} "
                  f"kind_rate {r['kind_rate']:.6g} candidate_diff "
                  f"{r['candidate_diff']} (limit {limits[preset]:.6g}); JAX "
                  f"record '{key}': frame_rate {jr['frame_rate']:.6g} "
                  f"trail_rate {jr['trail_rate']:.6g} kind_rate "
                  f"{jr['kind_rate']:.6g}", flush=True)
            check(r["trail_rate"] <= limits[preset],
                  f"{preset} segments {segs} {mode}: trail_rate "
                  f"{r['trail_rate']} past {limits[preset]}")
    moves = ", ".join(f"{k} {v:.6g}" for k, v in decomp["transitions"].items())
    print(f"[fidelity] traj_vel decomposition, segments 4, frame "
          f"{decomp.get('frame')}: trail_rate {decomp['trail_rate']:.6g} of "
          f"{decomp['denom']} trail pixels; owner swaps "
          f"{decomp['trail_owner_swap']:.6g}; transitions {moves or 'none'}",
          flush=True)
    # The tuned knobs: a lane's segments (exact) and rows9 (at its
    # segments) must stay within its preset's limit.
    knobs = tuned.load_tuned()
    for lane, preset in FIDELITY_LANES.items():
        section = knobs.get(lane, {})
        segs = tuned.fill(None, section, "segments",
                          fidelity.DEFAULT_SEGMENTS)
        for rows9 in (False, True) if section.get("rows9") else (False,):
            if (preset, segs, rows9) not in rates:
                rates[preset, segs, rows9] = fidelity.trail_segments_flip_rate(
                    segs, preset_name=preset,
                    capsule_eval="cap8" if rows9 else "cap10",
                    capsule_span=FIDELITY_SPAN, device=dev, **FIDELITY_SCENE)
            rate = rates[preset, segs, rows9]["trail_rate"]
            what = (f"tuned {lane}: segments {segs}"
                    + (f" with rows9 (span {FIDELITY_SPAN})" if rows9 else ""))
            check(rate <= limits[preset],
                  f"{what} is not certified on {preset}: trail_rate {rate} "
                  f"past {limits[preset]}")
            print(f"[fidelity] {what} certified on {preset}: trail_rate "
                  f"{rate:.6g} <= {limits[preset]:.6g}", flush=True)


def compare_capped(soup, width, height, card, timing=False,
                   max_per_tile=None, what="shadow map"):
    """csr1_raster over capped strips (``tiles.bin_primitives`` at
    ``max_per_tile`` per 8x128 strip, by default the shadow map's 1,024;
    16 strips per prim, 64 big prims; ``tiles.strip_rows``) with its exit
    on and off, at its default split and at items of SPLIT_FORCED rows,
    == the plain strip walk bit for bit -> dict(err, entries, dropped,
    depth (the plain walk's depth), and with
    ``timing``: ms, device_ms, ms_exit_off, plain_ms, bound_ms, bound_by,
    bound_ms_exit_off, walked).  The bound counts the rows walked (the
    first walked[t] rows of each strip) at 16 or 18 operations per pixel
    and every live big row at every pixel, or the bytes."""
    import torch

    from pointcloud_render_tpu_torch.raster import csr, tiles
    from pointcloud_render_tpu_torch.shading import shadow

    if max_per_tile is None:
        max_per_tile = shadow.SHADOW_MAX_PER_TILE
    bins = tiles.bin_primitives(soup, width, height,
                                max_per_tile=max_per_tile)
    args = (*tiles.strip_rows(soup, bins), width, height)
    rows, starts = args[0], args[1]
    want = csr.raster_strips_plain(*args)
    lengths = starts[1:] - starts[:-1]
    walked = torch.empty_like(lengths)
    errs = []
    for exit_on in (False, True):
        for items in (None, SPLIT_FORCED):
            extra = {} if items is None else dict(split_rows=items)
            got = csr.raster_tiles1(*args, walked=walked, allow_exit=exit_on,
                                    **extra)
            torch.cuda.synchronize()
            on = (f"csr1_raster {what} {width}x{height} exit "
                  f"{'on' if exit_on else 'off'}"
                  + (f", items of {items} rows" if items else ""))
            errs.append(check_equal_bits(got, want, on))
            check(bool((walked <= lengths).all()) and (
                exit_on or torch.equal(walked, lengths)),
                f"{on}: walked {int(walked.sum())} of {int(lengths.sum())}")
    n = int(starts[-1])
    out = dict(err=max(errs), entries=n, dropped=int(bins.overflowed),
               depth=want[0])
    if timing:
        csr.raster_tiles1(*args, walked=walked)  # the default walk's counts
        s64 = starts.long()
        pos = torch.arange(n, device=soup.device)
        tile = torch.searchsorted(s64, pos, right=True) - 1
        keep = (pos - s64[tile]) < walked.long()[tile]
        ids = rows[:n, 12].long()
        big_ids, big_n = bins.big_list, args[3]
        on, off = (strip_bound(soup, e, 16, 1024, big_ids, big_n,
                               starts.numel(), width, height, False)
                   for e in (ids[keep], ids))
        out.update(
            ms=time_ms(lambda: csr.raster_tiles1(*args), 11),
            device_ms=device_ms(lambda: csr.raster_tiles1(*args), 11),
            ms_exit_off=time_ms(lambda: csr.raster_tiles1(
                *args, allow_exit=False), 11),
            plain_ms=time_ms(lambda: csr.raster_strips_plain(*args), 2),
            bound_ms=on[0], bound_by=on[1], bound_ms_exit_off=off[0],
            walked=int(keep.sum()))
    return out


def look_stages(pipe, preset, pcl, fi, dev, ss):
    """The stages of one look frame at supersample ``ss``, in the order
    FramePipeline.render_array runs them."""
    from pointcloud_render_tpu_torch.raster import csr, tiles
    from pointcloud_render_tpu_torch.run import pipeline
    from pointcloud_render_tpu_torch.shading import aa, shadow
    from pointcloud_render_tpu_torch.shading.shade import shade_framebuffer

    shading = pipe.raster_config.shading
    size = shading.shadow_size

    def build(f):
        f["cam"] = pipeline.frame_camera(preset, fi, WIDTH * ss,
                                         HEIGHT * ss, dev)
        f["soup"] = pipeline.build_primitives(preset, f["cam"], pcl[:, :3],
                                              pcl[:, 3:], fi)

    def camera_raster(f):
        f["fb"] = pipe._render_certified(f["soup"], f["cam"], fi)

    def light_build(f):
        f["light"] = shadow.light_camera(size=size, device=dev)
        f["lsoup"] = pipeline.build_primitives(preset, f["light"],
                                               pcl[:, :3], pcl[:, 3:], fi)

    def binning(f):
        bins = tiles.bin_primitives(f["lsoup"], size, size,
                                    max_per_tile=shadow.SHADOW_MAX_PER_TILE)
        f["strips"] = tiles.strip_rows(f["lsoup"], bins)

    def kernel(f):
        f["sdepth"], _ = csr.raster_tiles1(*f["strips"], size, size)

    def factor(f):
        f["sf"] = shadow.shadow_factor(f["cam"], f["fb"].depth,
                                       f["fb"].index, f["light"],
                                       f["sdepth"])

    def shade(f):
        f["rgb"] = shade_framebuffer(f["soup"], f["cam"], f["fb"].depth,
                                     f["fb"].index, shading, shadow=f["sf"])

    stages = [("camera+soup build", build),
              ("camera raster (render, certificate read-back)",
               camera_raster),
              ("light-view soup build", light_build),
              ("capped binning (bin_primitives, strip_rows)", binning),
              ("csr1_raster shadow map", kernel),
              ("shadow_factor", factor), ("shade_framebuffer", shade)]
    if ss > 1:
        stages.append(("downsample", lambda f: aa.downsample(f["rgb"], ss)))
    return stages


def look_phase(card, dev, inp, out, counters, max_err) -> dict:
    """Phase 14: the look passes (see the module docstring) -> csr1_raster's
    shadow-map numbers, each key prefixed shadow_."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.cli import traj_ball_renderer
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.raster import alpha, csr4, csr6, tiles
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline
    from pointcloud_render_tpu_torch.shading import aa, shadow
    from pointcloud_render_tpu_torch.shading.shade import (
        ShadingConfig,
        shade_framebuffer,
    )

    # (a) The traj_ball CLI with the four look flags.
    reset_counts(counters)
    sink = traj_ball_renderer.main(
        ["--input-folder", inp, "--output-folder", out, "--frames",
         ",".join(map(str, FRAMES)), "--device", "cuda", *LOOK_FLAGS])
    torch.cuda.synchronize()
    counts = launch_counts(counters)
    statuses = [(r.frame_index, r.status, r.error) for r in sink.records]
    check(len(statuses) == 3 and all(s == "ok" for _, s, _ in statuses),
          f"look frame records not all ok: {statuses}")
    for fi in FRAMES:
        check(os.path.getsize(os.path.join(out, f"frame_{fi:04d}_b0.png"))
              > 1000, f"look frame {fi}: PNG missing")
    check(counts.get("raster_tiles", 0) >= 3
          and counts.get("raster_tiles1") == 3,
          f"look CLI: launches {counts}, want csr6_raster per frame and "
          "csr1_raster once per frame (the shadow map)")
    for r in sink.records:
        t = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in r.timings_s.items())
        print(f"[look cli] frame {r.frame_index}: {r.points} points {t} "
              f"({card})", flush=True)
    print(f"[look cli] traj_ball {' '.join(LOOK_FLAGS)} frames 10, 120, "
          f"205: records ok, PNGs written; launches {counts}", flush=True)

    # (b) Frame 120 through FramePipeline at ss 1 and 2.
    preset = PRESETS["traj_ball"]
    look = ShadingConfig(shadows=True, ground_spec=0.5, gi=0.25)
    size = look.shadow_size
    fi = 120
    pcl = pipeline.FramePipeline(preset, device=dev).load_and_prepare(
        os.path.join(inp, "frame_0120_b0.ply"))
    light = shadow.light_camera(size=size, device=dev)
    lsoup = pipeline.build_primitives(preset, light, pcl[:, :3], pcl[:, 3:],
                                      fi)
    dropped = int(tiles.tile_overflow(
        lsoup, size, size, max_per_tile=shadow.SHADOW_MAX_PER_TILE))
    print(f"[look] traj_ball frame {fi} light view ({size}x{size}, "
          f"{lsoup.count} prims): the capped strips drop {dropped} entries "
          "(tile_overflow at 1,024 per 8x128 strip, 16 strips per prim, 64 "
          "big prims; mirrored from the JAX package's tiled backend)",
          flush=True)
    shadow_nums = compare_capped(lsoup, size, size, card, timing=True)
    max_err["csr1_raster"] = max(max_err["csr1_raster"], shadow_nums["err"])
    check(shadow_nums["dropped"] == dropped,
          f"TileBins.overflowed {shadow_nums['dropped']} != tile_overflow "
          f"{dropped}")
    print(f"[kernel==plain] csr1_raster shadow map traj_ball frame {fi}: "
          f"{shadow_nums['entries']} kept entries ok (exit off and on, "
          f"items of the default and of {SPLIT_FORCED} rows)", flush=True)
    print(f"[time] csr1_raster shadow map kernel {shadow_nums['ms']:.3f} ms "
          f"(median of 11), device {shadow_nums['device_ms']:.3f} ms, bound "
          f"{shadow_nums['bound_ms']:.4f} ms by {shadow_nums['bound_by']} "
          f"({shadow_nums['walked']} of {shadow_nums['entries']} rows "
          f"walked); exit off {shadow_nums['ms_exit_off']:.3f} ms, bound "
          f"{shadow_nums['bound_ms_exit_off']:.4f} ms; plain "
          f"{shadow_nums['plain_ms']:.1f} ms (median of 2), at the traj_ball "
          f"frame-{fi} light view ({card})", flush=True)
    sd_plain = shadow_nums.pop("depth")
    timed = {}
    for ss in (1, 2):
        w, h = WIDTH * ss, HEIGHT * ss
        plain_pipe = pipeline.FramePipeline(preset, width=w, height=h,
                                            device=dev)
        look_pipe = pipeline.FramePipeline(
            preset, RasterConfig(supersample=ss, shading=look), width=WIDTH,
            height=HEIGHT, device=dev)
        base = plain_pipe.render_array(pcl, fi)
        fb = look_pipe.render_array(pcl, fi)
        for field in ("depth", "index"):
            a = getattr(base, field)[::ss, ::ss].contiguous()
            check(torch.equal(a.view(torch.int32),
                              getattr(fb, field).view(torch.int32)),
                  f"ss {ss}: the look frame's {field} differs from the "
                  f"plain {w}x{h} frame's")
        check(fb.rgb.shape == (HEIGHT, WIDTH, 3)
              and bool(((fb.rgb >= 0) & (fb.rgb <= 1)).all()),
              f"ss {ss}: look rgb malformed")
        # The same frame with the shadow map from the plain walk.
        cam = pipeline.frame_camera(preset, fi, w, h, dev)
        soup = pipeline.build_primitives(preset, cam, pcl[:, :3],
                                         pcl[:, 3:], fi)
        max_big = look_pipe.raster_config.max_big
        b = csr6.bin_csr6(soup, w, h, max_big, with_z=True)
        check(soup.count < (1 << 24) and int(b["diag"]["big_overflow"]) == 0,
              f"ss {ss}: {soup.count} prims, big list {int(b['big_count'])}"
              f" past max_big {max_big}")
        print(f"[look] traj_ball frame {fi} camera film {w}x{h}: "
              f"{soup.count} prims (< 2^24), {int(b['starts'][-1])} "
              f"binned rows, true_entries {int(b['diag']['true_entries'])}, "
              f"big list {int(b['big_count'])} (max_big {max_big}), "
              f"{b['keys'].dtype} exit keys", flush=True)
        del b
        sf = shadow.shadow_factor(cam, base.depth, base.index, light,
                                  sd_plain)
        rgb = aa.downsample(shade_framebuffer(
            soup, cam, base.depth, base.index, look, shadow=sf), ss)
        check(torch.equal(rgb.view(torch.int32), fb.rgb.view(torch.int32)),
              f"ss {ss}: the look rgb differs from the plain shadow map's")
        dark = float((sf < 1).float().mean())
        print(f"[look] traj_ball frame {fi} ss {ss} ({w}x{h} camera film): "
              "depth and index == the plain frame's"
              f"{' sliced [::2, ::2]' if ss == 2 else ''}, rgb == the same "
              "frame shaded over the plain walk's shadow map (bit for bit); "
              f"{dark:.4f} of the camera's pixels shadowed", flush=True)
        times = {}
        for name, p in (("look", look_pipe), ("plain", plain_pipe)):
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                p.render_array(pcl, fi)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            q1, med, q3 = statistics.quantiles(runs, n=4)
            times[name] = (med, q1, q3)
        timed[ss] = times
        print(f"[look] frame {fi} ss {ss} render_array warm: look "
              f"{times['look'][0]:.2f} ms (quartiles {times['look'][1]:.2f}-"
              f"{times['look'][2]:.2f}), plain frame at the same film "
              f"{times['plain'][0]:.2f} ms ({times['plain'][1]:.2f}-"
              f"{times['plain'][2]:.2f}), medians of 5 ({card})", flush=True)
        for stage, ms in stage_times(look_stages(
                look_pipe, preset, pcl, fi, dev, ss)).items():
            print(f"[look] stage ss {ss} {stage}: {ms:.2f} ms ({card})",
                  flush=True)
        if ss == 2:
            # At span 2 the 3840x2160 film sends the long trail capsules
            # to the big list; span 4 bins them (the same winners).
            wide = pipeline.FramePipeline(
                preset, RasterConfig(supersample=2, span=4, shading=look),
                width=WIDTH, height=HEIGHT, device=dev)
            equal_buffers(wide.render_array(pcl, fi), fb,
                          "ss 2: the span-4 look frame vs span 2")
            # csr6_raster at this film against its plain version: at span
            # 4 (a big list of a few rows, so the plain walk is cheap),
            # and through it the span-2 film that the look frame walks.
            r4, got = compare(soup, w, h, csr6, csr4,
                              wide.raster_config.max_big, span=4)
            max_err["csr6_raster"] = max(max_err["csr6_raster"], r4["err"])
            for k, field in enumerate(("depth", "index")):
                check(torch.equal(got[k].view(torch.int32),
                                  getattr(base, field).view(torch.int32)),
                      f"ss 2: the span-4 walk's {field} differs from the "
                      f"span-2 {w}x{h} frame's")
            print(f"[kernel==plain] csr6_raster span 4 traj_ball frame {fi} "
                  f"{w}x{h}: {soup.count} prims ok (items of "
                  f"{csr6.SPLIT_ROWS} and {SPLIT_FORCED} rows), and == the "
                  "span-2 frame's depth and index", flush=True)
            del got
            b4 = csr6.bin_csr6(soup, w, h, wide.raster_config.max_big,
                               span=4)
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                wide.render_array(pcl, fi)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            print(f"[look] frame {fi} ss 2 with span 4: the same frame (rgb, "
                  f"depth, index), big list {int(b4['big_count'])}, "
                  f"render_array warm {statistics.median(runs):.2f} ms "
                  f"(median of 3; {min(runs):.2f}-{max(runs):.2f}) "
                  f"({card})", flush=True)
            del wide, b4
        del base, fb, soup, sf, rgb
    # composite_tiled at 1M splats (BASELINE config 3), traj_ball frame 120.
    cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
    n = pcl.shape[0]
    rng = np.random.default_rng(31)
    splats = alpha.splat_gaussians(
        torch.as_tensor(pcl[:, :3], device=dev), cam,
        torch.full((n,), preset.point_radius, device=dev),
        torch.as_tensor(rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                        device=dev), torch.full((n,), 0.5, device=dev))
    img = alpha.composite_tiled(splats, WIDTH, HEIGHT)
    check(img.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(img).all())
          and bool((img < 1).any()), "composite_tiled output malformed")
    ms = time_ms(lambda: alpha.composite_tiled(splats, WIDTH, HEIGHT), 5)
    cut = int(tiles.tile_overflow(alpha.splat_prims(splats), WIDTH, HEIGHT,
                                  max_per_tile=1024))
    print(f"[look] composite_tiled {n} splats at {WIDTH}x{HEIGHT}: {ms:.2f} "
          f"ms (median of 5), {int(splats['valid'].sum())} valid, {cut} "
          f"entries dropped at 1,024 per strip ({card})", flush=True)
    return {"launches": counts.get("raster_tiles1", 0), **{
        k: shadow_nums[k] for k in SHADOW_KEYS if k in shadow_nums}}


def stream_camera(device):
    """stream_10m.py's camera: origin (2, 2, 2), target (0, 0, -0.05), 4K."""
    import torch

    from pointcloud_render_tpu_torch.scene.camera import Camera

    w, h = STREAM_FILM
    return Camera(origin=torch.tensor([2.0, 2.0, 2.0], device=device),
                  target=torch.tensor([0.0, 0.0, -0.05], device=device),
                  width=w, height=h)


def stream_chunks(scene, n_chunks, seed, log=None):
    """stream_10m.py's host feed: chunks of STREAM_CHUNK points uniform in
    [-0.5, 0.5)^3; the trail scene adds gray colours and velocities
    normal(0, 2).  ``log`` sums the generation time under "gen_s" and
    keeps the chunks under "chunks"."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gray = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32),
                           (STREAM_CHUNK, 3))
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        pts = rng.uniform(-0.5, 0.5, (STREAM_CHUNK, 3)).astype(np.float32)
        chunk = pts if scene == "disc" else (
            pts, gray, rng.normal(0, 2, pts.shape).astype(np.float32))
        if log is not None:
            log["gen_s"] += time.perf_counter() - t0
            log["chunks"].append(chunk)
        yield chunk


def device_chunk(chunk, device):
    """A host chunk as the stream's device arguments (positions, colours,
    extras); bare positions take the gray default colour."""
    import numpy as np
    import torch

    if not isinstance(chunk, tuple):
        chunk = (chunk, np.broadcast_to(np.float32(0.3), chunk.shape))
    pos, colors, *extras = (torch.tensor(np.ascontiguousarray(a),
                                         device=device) for a in chunk)
    return pos, colors, tuple(extras)


def host_syncs(fn):
    """(fn's result, {file:line: count}) of the synchronising CUDA calls
    torch flags while ``fn`` runs (torch.cuda.set_sync_debug_mode)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return out, where


def stream_stages(sr, chunk):
    """The stages of one chunk's step: soup build, raster (binning, rows,
    kernel), the attribute gather and merge."""
    import torch

    h, w = sr.camera.height, sr.camera.width
    dev = sr.device
    state = (torch.full((h, w), float("inf"), device=dev),
             torch.full((h, w), 2147483647, dtype=torch.int32, device=dev),
             torch.zeros((h, w, 6), device=dev))

    def build(f):
        f["prims"] = sr.build_soup(*chunk)[0]

    def raster(f):
        f["d"], f["i"], _, _ = sr.raster_soup(f["prims"])

    return [("soup build", build), ("binning, rows and kernel", raster),
            ("attribute gather and merge",
             lambda f: sr.fold(f["prims"], f["d"], f["i"], 0, *state))]


def stream_scene(card, dev, counters, sr, scene, want, tmp):
    """Phase 15 (e) on one full-width scene: the STREAM_POINTS stream
    (launches checked against ``want``), warm, timed end to end with the
    host generation apart, the resident step, a trace, the host syncs
    and the peak memory -> (depth, index, attrs, launches, chunks)."""
    import torch

    n_chunks = STREAM_POINTS // STREAM_CHUNK
    sr.rasterize(stream_chunks(scene, 1, seed=1))  # first use
    torch.cuda.synchronize()
    log = dict(gen_s=0.0, chunks=[])
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    depth, index, attrs = sr.rasterize(stream_chunks(scene, n_chunks, 0, log),
                                       return_attrs=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    check(counts == {want: n_chunks},
          f"{scene} stream: launches {counts}, want {want} {n_chunks}")
    hit = index >= 0
    check(bool(torch.isfinite(depth[hit]).all()) and bool(hit.any())
          and int(index.max()) < n_chunks * sr.prims_per_chunk,
          f"{scene} stream: malformed output")
    gen = log["gen_s"]
    print(f"[stream] {scene} scene: {STREAM_POINTS} points in {n_chunks} "
          f"chunks at {STREAM_FILM[0]}x{STREAM_FILM[1]}, warm: "
          f"{wall / n_chunks * 1e3:.2f} ms per chunk end to end, of which "
          f"host generation {gen / n_chunks * 1e3:.2f} ms; "
          f"{STREAM_POINTS / wall / 1e6:.2f}M points/s end to end, "
          f"{STREAM_POINTS / (wall - gen) / 1e6:.2f}M points/s without the "
          f"generation; hit share {float(hit.float().mean()):.4f}, max id "
          f"{int(index.max())}; peak memory allocated {peak / 2**30:.3f} GiB "
          f"({card})", flush=True)
    chunk = device_chunk(log["chunks"][0], dev)
    h, w = sr.camera.height, sr.camera.width
    d0 = torch.full((h, w), float("inf"), device=dev)
    i0 = torch.full((h, w), 2147483647, dtype=torch.int32, device=dev)
    a0 = torch.zeros((h, w, 6), device=dev)
    step_ms = time_ms(lambda: sr.step(*chunk, 0, d0, i0, a0), 10)
    print(f"[stream] {scene} scene: device-side step on a resident chunk "
          f"{step_ms:.3f} ms (median of 10) = "
          f"{STREAM_CHUNK / step_ms / 1e3:.2f}M points/s ({card})",
          flush=True)
    for stage, ms in stage_times(stream_stages(sr, chunk)).items():
        print(f"[stage] stream {scene} chunk {stage}: {ms:.2f} ms ({card})",
              flush=True)
    busy, twall, top, calls = device_profile(
        lambda: sr.rasterize(stream_chunks(scene, n_chunks, 0)), 1, tmp)
    if top:
        print(f"[stream] {scene} scene: traced stream of {n_chunks} chunks: "
              f"device busy {busy / 1e3:.2f} of {twall / 1e3:.2f} ms wall, "
              f"idle share {1 - busy / twall:.3f} ({card})", flush=True)
        for name, us in top[:6]:
            print(f"[trace] stream {scene} {us / n_chunks / 1e3:9.3f} "
                  f"ms/chunk  {name[:90]}", flush=True)
    else:
        print(f"[stream] {scene} scene: the profiler saw no device activity; "
              "idle share not measured", flush=True)
    _, where = host_syncs(lambda: sr.rasterize(stream_chunks(scene, 3, 0)))
    total = sum(where.values())
    print(f"[stream] {scene} scene: host synchronisations in a 3-chunk "
          f"stream: {total} ({(total - 1) / 3:.2f} per chunk besides the "
          f"one certificate read-back), by place {where}; staging waits "
          f"{sr.staging_waits} ({card})", flush=True)
    own = sum(c for k, c in where.items() if "parallel/streaming.py" in k)
    check(own <= 1, f"{scene} stream: the chunk loop synchronises {own} "
          "times, want only the certificate read-back")
    return depth, index, attrs, counts.get(want, 0), log["chunks"]


def stream_phase(card, dev, counters, max_err, tmp) -> dict:
    """Phase 15: the stream (see the module docstring) -> the stream_
    numbers of the five kernels it launches."""
    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.parallel.streaming import (
        StreamingRasterizer,
    )
    from pointcloud_render_tpu_torch.raster import csr4, csr6, tiles
    from pointcloud_render_tpu_torch.raster.primitives import (
        ScreenPrimitives,
        discs_from_points,
    )
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline
    from pointcloud_render_tpu_torch.scene import normalize
    from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

    w, h = STREAM_FILM
    cam = stream_camera(dev)
    nums = {}

    # (a) The disc scene: csr6_disc8 once per chunk; == the monolithic
    # render of the whole 10M-disc soup.
    disc_cfg = RasterConfig(backend="pallas6", discs_only=True)
    sr = StreamingRasterizer(cam, STREAM_CHUNK, STREAM_RADIUS,
                             backend="pallas6", config=disc_cfg,
                             max_big=1024, device=dev)
    depth, index, _, launches, chunks = stream_scene(
        card, dev, counters, sr, "disc", "raster_tiles_disc8", tmp)
    pos = torch.tensor(np.concatenate(chunks), device=dev)
    n = pos.shape[0]
    soup = discs_from_points(pos, cam, torch.full((n,), STREAM_RADIUS,
                                                  device=dev),
                             np.array([0.3, 0.3, 0.3], np.float32))
    d1, i1, diag = csr6.rasterize_csr6(soup, w, h, max_big=1024,
                                       discs_only=True)
    check(int(diag["big_overflow"]) == 0, "monolithic disc render overflowed")
    check_equal_bits((depth, index), (d1, i1),
                     "the 10M-disc stream vs the monolithic render")
    check(int(index.max()) < 1 << 24, "disc stream ids past 2^24")
    print(f"[stream] disc scene: the {STREAM_POINTS // STREAM_CHUNK}-chunk "
          f"stream == the monolithic csr6.rasterize_csr6(discs_only) render "
          f"of the {n}-disc soup bit for bit (depth, index); csr6_disc8 "
          f"launches {launches} ({card})", flush=True)
    del pos, soup, d1, i1, depth, index
    soup0 = sr.build_soup(*device_chunk(chunks[0], dev))[0]
    _, flag = csr6.preshade(soup0, cam, ShadingConfig())
    res, b = compare_disc(soup0, flag, w, h, csr6, 1024, timing=True)
    for name, r in res.items():
        max_err[name] = max(max_err[name], r["err"])
    print_disc_times("csr6_disc8", res["csr6_disc8"], "stream chunk-0 (4K)",
                     card)
    nums["csr6_disc8"] = dict(res["csr6_disc8"], launches=launches)
    print(f"[kernel==plain] csr6_disc8, csr6_disc8_uv stream chunk 0 "
          f"({w}x{h}): {soup0.count} prims, big list {int(b['big_count'])} "
          "ok", flush=True)
    short = chunks[:STREAM_SHORT_CHUNKS]
    del chunks

    # (b) The trail scene: csr6_cap10 once per chunk; chunks 0-1 == the
    # monolithic render of their concatenated soups.
    trail_cfg = RasterConfig(backend="pallas6", span=4, cap_rows10=True)
    sr_t = StreamingRasterizer(cam, STREAM_CHUNK, STREAM_RADIUS,
                               backend="pallas6", config=trail_cfg,
                               soup_fn=torch_soups().trail_soup_fn(
                                   cam, STREAM_RADIUS, STREAM_SEGMENTS,
                                   STREAM_TRAIL_RADIUS),
                               max_big=STREAM_TRAIL_MAX_BIG, device=dev)
    _, _, attrs, launches, chunks = stream_scene(
        card, dev, counters, sr_t, "trail", "raster_tiles_cap10", tmp)
    check(bool((attrs[..., 2] < 0).any()), "trail stream: no capsule winner")
    del attrs
    two = chunks[:2]
    del chunks
    d2, i2 = sr_t.rasterize(two)
    soups = [sr_t.build_soup(*device_chunk(c, dev))[0] for c in two]
    soup = ScreenPrimitives.concatenate(soups)
    d1, i1, diag = csr6.rasterize_csr6(soup, w, h, max_big=1 << 16, span=4,
                                       cap_rows10=True)
    check(int(diag["big_overflow"]) == 0, "monolithic trail render overflowed")
    check_equal_bits((d2, i2), (d1, i1),
                     "the 2-chunk trail stream vs the monolithic render")
    print(f"[stream] trail scene: chunks 0-1 as a stream == the monolithic "
          f"cap_rows10 span-4 render of their {soup.count}-row soup bit for "
          f"bit (depth, index) ({card})", flush=True)
    del soup, d1, i1, d2, i2
    res, _ = compare_cap10(soups[0], w, h, csr6, STREAM_TRAIL_MAX_BIG, 4,
                           timing=True)
    max_err["csr6_cap10"] = max(max_err["csr6_cap10"], res["err"])
    nums["csr6_cap10"] = dict(res, launches=launches)
    print(f"[kernel==plain] csr6_cap10 span 4 stream chunk 0 ({w}x{h}): "
          f"{soups[0].count} prims, {res['binned']} binned, big list "
          f"{res['big']} ok", flush=True)
    print(f"[time] csr6_cap10 span 4 at the stream chunk-0 (4K) shape: "
          f"kernel {res['ms']:.3f} ms (median of 11), plain "
          f"{res['plain_ms']:.1f} ms, bound {res['bound_ms']:.3f} ms by "
          f"{res['bound_by']}; {stats_text(res)} ({card})", flush=True)
    del soups

    # (c) The v4 and tiled streams on the disc scene's first chunks.
    want = StreamingRasterizer(cam, STREAM_CHUNK, STREAM_RADIUS,
                               backend="pallas6", config=disc_cfg,
                               device=dev).rasterize(short)
    got = {}
    for backend, kernel in (("pallas", "raster_tiles4"),
                            ("tiled", "raster_tiles1")):
        reset_counts(counters)
        got[backend] = StreamingRasterizer(
            cam, STREAM_CHUNK, STREAM_RADIUS, backend=backend, max_big=1024,
            device=dev).rasterize(short)
        torch.cuda.synchronize()
        counts = launch_counts(counters)
        check(counts == {kernel: len(short)},
              f"{backend} stream: launches {counts}")
        nums[{"raster_tiles4": "csr4_raster",
              "raster_tiles1": "csr1_raster"}[kernel]] = dict(
                  launches=len(short))
    check_equal_bits(got["pallas"], want, "the v4 stream vs pallas6")
    soup0 = sr.build_soup(*device_chunk(short[0], dev))[0]
    dropped = int(tiles.tile_overflow(soup0, w, h))
    differ = int((got["tiled"][1] != want[1]).sum())
    print(f"[stream] v4 stream of {len(short)} chunks == the pallas6 stream "
          f"bit for bit; the tiled stream's caps (512 per 8x128 strip, 64 "
          f"big prims; mirrored from the JAX package) drop {dropped} entries "
          f"of chunk 0 and change {differ} winners of the "
          f"{len(short)}-chunk stream ({card})", flush=True)
    r4, _ = compare_v4(soup0, w, h, csr6, csr4, 1024, False,
                       what="stream chunk 0")
    max_err["csr4_raster"] = max(max_err["csr4_raster"], r4["err"])
    r1 = compare_capped(soup0, w, h, card, max_per_tile=tiles.MAX_PER_TILE,
                        what="stream chunk 0")
    max_err["csr1_raster"] = max(max_err["csr1_raster"], r1["err"])
    check(r1["dropped"] == dropped, "TileBins.overflowed != tile_overflow")
    print(f"[kernel==plain] csr4_raster (exit on and off) and csr1_raster "
          f"over the capped strips ({r1['entries']} kept entries, exit off "
          f"and on) on stream chunk 0 ({w}x{h}) ok", flush=True)
    del want, got, soup0, short

    # (d) A traj_vel droplet stream at 1080p (the default config).
    preset = PRESETS["traj_vel"]
    pos, vel = flagship_cloud(STREAM_DROPLETS, seed=29)
    pcl = normalize.transform_coordinates(normalize.standardize_point_cloud(
        np.concatenate([pos, vel], axis=1)), flip_x=preset.flip_x)
    pcl = pcl.astype(np.float32)
    cam_d = pipeline.frame_camera(preset, 120, WIDTH, HEIGHT, dev)

    def droplet_soup(p, colors, v):
        return pipeline.build_primitives(preset, cam_d, p, v, 120,
                                         return_layout=True)
    c = STREAM_DROPLET_CHUNK
    gray = np.full((c, 3), 0.3, np.float32)
    chunks = [(pcl[k:k + c, :3], gray, pcl[k:k + c, 3:])
              for k in range(0, STREAM_DROPLETS, c)]
    sr_d = StreamingRasterizer(cam_d, c, preset.point_radius,
                               soup_fn=droplet_soup, max_big=1 << 14,
                               device=dev)
    d0, i0 = sr_d.rasterize(chunks[:1])
    soup0, layout = sr_d.build_soup(*device_chunk(chunks[0], dev))
    d1, i1, diag = csr6.rasterize_csr6(soup0, WIDTH, HEIGHT, max_big=1 << 14)
    check(int(diag["big_overflow"]) == 0, "droplet chunk 0 overflowed")
    check_equal_bits((d0, i0), (d1, i1),
                     "the droplet stream's chunk 0 vs its monolithic render")
    reset_counts(counters)
    t0 = time.perf_counter()
    d, i = sr_d.rasterize(chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(counters)
    check(counts == {"raster_tiles": len(chunks)},
          f"droplet stream: launches {counts}")
    ground_rows = layout[0][0]
    check(layout[0][1] == 0, "the droplet soup's first part is not the ground")
    hit = i >= 0
    ground = hit & (torch.remainder(i, sr_d.prims_per_chunk) < ground_rows)
    check(bool(ground.any()) and bool((i[ground] < ground_rows).all()),
          "droplet stream: ground winners from a chunk after the first")
    nums["csr6_raster"] = dict(launches=len(chunks))
    _, where = host_syncs(lambda: sr_d.rasterize(chunks))
    print(f"[stream] droplet scene: host synchronisations in the "
          f"{len(chunks)}-chunk stream: {sum(where.values())}, by place "
          f"{where} ({card})", flush=True)
    print(f"[stream] droplet scene (traj_vel, frame 120, {STREAM_DROPLETS} "
          f"points in {len(chunks)} chunks, {WIDTH}x{HEIGHT}, default "
          f"config): chunk 0 alone == its monolithic render bit for bit; the "
          f"ground's {int(ground.sum())} winners from chunk 0 only; "
          f"{wall / len(chunks) * 1e3:.2f} ms per chunk warm "
          f"({sr_d.prims_per_chunk} prims per chunk); csr6_raster launches "
          f"{counts.get('raster_tiles', 0)} ({card})", flush=True)
    return {name: {f"stream_{k}": v for k, v in r.items() if k in STREAM_KEYS}
            for name, r in nums.items()}


def kernel_counters():
    """Every kernel wrapper, in the kernels line's order of their counts."""
    from pointcloud_render_tpu_torch.raster import (
        csr,
        csr2,
        csr3,
        csr4,
        csr5,
        csr6,
    )

    return (csr6.raster_tiles, csr6.raster_tiles_tri,
            csr6.raster_tiles_disc8, csr6.raster_tiles_disc8_uv,
            csr6.raster_tiles_rows9, csr4.raster_tiles4,
            csr6.raster_tiles_cap10, csr3.raster_tiles3,
            csr.raster_tiles1, csr2.raster_tiles2,
            csr2.raster_tiles2_disc8, csr5.raster_tiles5,
            csr5.raster_tiles5_shaded)


def sharded_config(backend, max_per_tile=512):
    from pointcloud_render_tpu_torch.raster.render import RasterConfig

    return RasterConfig(backend=backend, max_big=SHARDED_MAX_BIG,
                        max_per_tile=max_per_tile)


def sharded_frame(preset, pcl, config, mesh, frame_index=SHARDED_FRAME):
    """One point-sharded traj_ball frame at 1920x1080 (every rank)."""
    from pointcloud_render_tpu_torch.parallel import render_parallel as rp

    return rp.render_scene_point_sharded(
        preset, pcl[:, :3], config, mesh, velocities=pcl[:, 3:],
        frame_index=frame_index, width=WIDTH, height=HEIGHT)


def frame_tensors(fb):
    """(depth, index, rgb) of a FrameBuffers or ShardedFrame."""
    return fb.depth, fb.index, fb.rgb


def wall_ms(fn, reps=SHARDED_REPS, barrier=None):
    """Median host time of ``reps`` calls of ``fn`` after a warm-up, each
    ended by a synchronise (and started after ``barrier``, if given)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def merge_ms(group, dev):
    """Host ms of the sharded merge's four all-reduces on 1920x1080
    buffers (depth MIN, id MIN, rgb SUM, overflow SUM) over ``group``."""
    import torch
    import torch.distributed as dist

    from pointcloud_render_tpu_torch.parallel import render_parallel as rp

    bufs = [(torch.zeros((HEIGHT, WIDTH), device=dev), dist.ReduceOp.MIN),
            (torch.zeros((HEIGHT, WIDTH), dtype=torch.int32, device=dev),
             dist.ReduceOp.MIN),
            (torch.zeros((HEIGHT, WIDTH, 3), device=dev), dist.ReduceOp.SUM),
            (torch.zeros((1,), dtype=torch.int32, device=dev),
             dist.ReduceOp.SUM)]
    return wall_ms(lambda: [rp.all_reduce(t, op, group) for t, op in bufs],
                   reps=5, barrier=lambda: dist.barrier(group))


def sharded_rank(rank, port, tmp):
    """Phase 16 (b) and (c) on one of SHARDED_RANKS ranks sharing the card
    through gloo; writes its numbers to ``tmp/rank{rank}.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.parallel import multihost
    from pointcloud_render_tpu_torch.parallel import render_parallel as rp
    from pointcloud_render_tpu_torch.parallel.streaming import (
        StreamingRasterizer,
    )
    from pointcloud_render_tpu_torch.raster.render import RasterConfig
    from pointcloud_render_tpu_torch.run import pipeline

    multihost.initialize(f"127.0.0.1:{port}", SHARDED_RANKS, rank,
                         backend="gloo")
    try:
        dev = torch.device("cuda")
        counters = kernel_counters()
        preset = PRESETS["traj_ball"]
        pcl = np.load(os.path.join(tmp, "pcl.npy"))
        m12 = rp.make_render_mesh(1, SHARDED_RANKS)
        m21 = rp.make_render_mesh(SHARDED_RANKS, 1)
        group = m12.get_group("points")
        nums = {"backend": dist.get_backend(group),
                "host_copies": rp.host_copies(group, dev), "launches": {}}
        # (b) The frame point-sharded over both ranks == phase (a)'s.
        for b in ("pallas6", "pallas4"):
            reset_counts(counters)
            fr = sharded_frame(preset, pcl, sharded_config(b), m12)
            torch.cuda.synchronize()
            nums["launches"][b] = launch_counts(counters)
            check(int(fr.overflow) == 0, f"2-rank {b} frame overflowed")
            want = torch.load(os.path.join(tmp, f"a_{b}.pt"))
            check_equal_bits(frame_tensors(fr), want,
                             f"the 2-rank {b} frame vs the world of one")
        nums["frame_ms"] = wall_ms(
            lambda: sharded_frame(preset, pcl, sharded_config("pallas6"),
                                  m12), barrier=dist.barrier)
        nums["merge_ms"] = merge_ms(group, dev)
        # The batch on a (2, 1) and a (1, 2) mesh == each frame alone.
        frames = np.stack([pcl] * len(SHARDED_BATCH))
        batch = {name: rp.render_scene_batch_sharded(
            preset, frames[..., :3], frames[..., 3:], SHARDED_BATCH,
            sharded_config("pallas6"), mesh, width=WIDTH, height=HEIGHT)
            for name, mesh in (("2x1", m21), ("1x2", m12))}
        pipe = pipeline.FramePipeline(preset, sharded_config("pallas6"),
                                      device=dev)
        for j, fi in enumerate(SHARDED_BATCH):
            want = frame_tensors(pipe.render_array(pcl, fi))
            for name, out in batch.items():
                check(int(out.overflow[j]) == 0, f"batch {name} overflowed")
                check_equal_bits(
                    (out.depth[j], out.index[j], out.rgb[j]), want,
                    f"the {name} batch's frame {fi} vs its single-device "
                    "frame")
        del batch, frames
        # (c) The mesh stream == the one-rank stream.
        cam = stream_camera(dev)
        soups = torch_soups()
        scenes = {
            "disc": (2, dict(config=RasterConfig(backend="pallas6",
                                                 discs_only=True),
                             max_big=1024)),
            "trail": (1, dict(
                config=RasterConfig(backend="pallas6", span=4,
                                    cap_rows10=True),
                soup_fn=soups.trail_soup_fn(cam, STREAM_RADIUS,
                                            STREAM_SEGMENTS,
                                            STREAM_TRAIL_RADIUS),
                max_big=STREAM_TRAIL_MAX_BIG))}
        nums["stream"] = {}
        for scene, (n_chunks, kw) in scenes.items():
            chunks = list(stream_chunks(scene, n_chunks, 0))
            reset_counts(counters)
            t0 = time.perf_counter()
            sr = StreamingRasterizer(cam, STREAM_CHUNK, STREAM_RADIUS,
                                     backend="pallas6", device=dev,
                                     mesh=m12, **kw)
            got = sr.rasterize(chunks, return_attrs=True)
            torch.cuda.synchronize()
            nums["stream"][scene] = dict(
                ms=(time.perf_counter() - t0) * 1e3 / n_chunks,
                launches=launch_counts(counters),
                staging_waits=sr.staging_waits)
            if rank == 0:
                want = StreamingRasterizer(
                    cam, STREAM_CHUNK, STREAM_RADIUS, backend="pallas6",
                    device=dev, **kw).rasterize(chunks, return_attrs=True)
                check_equal_bits(got, want, f"the 2-rank {scene} stream vs "
                                 "the one-rank stream")
            del got, chunks
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(nums, f)
    finally:
        dist.destroy_process_group()


def sharded_phase(card, dev, counters, tmp) -> dict:
    """Phase 16: the sharded renders (see the module docstring) -> the
    sharded_launches of the three kernels they launch."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.io import ply
    from pointcloud_render_tpu_torch.parallel import multihost
    from pointcloud_render_tpu_torch.parallel import render_parallel as rp
    from pointcloud_render_tpu_torch.raster import tiles
    from pointcloud_render_tpu_torch.run import pipeline
    from pointcloud_render_tpu_torch.shading.shade import shade_framebuffer

    t_phase = time.perf_counter()
    preset = PRESETS["traj_ball"]
    # Phase 5's frame-120 PLY (seed 11, the second drift), loaded as the
    # CLI loads it.
    pos, vel = flagship_cloud(1_000_000, seed=11)
    path = os.path.join(tmp, "frame_0120_b0.ply")
    ply.write_ply(path, pos + (0.01 * vel).astype(np.float32),
                  velocities=vel)
    pcl = pipeline.FramePipeline(preset, device=dev).load_and_prepare(path)
    pcl = np.ascontiguousarray(pcl, np.float32)
    np.save(os.path.join(tmp, "pcl.npy"), pcl)
    print(f"[sharded] torch.distributed: nccl {dist.is_nccl_available()}, "
          f"gloo {dist.is_gloo_available()} ({card})", flush=True)

    # (a) A world of one on the card.
    multihost.initialize()
    nums = {}
    try:
        mesh = rp.make_render_mesh(1, 1)
        group = mesh.get_group("points")
        backend = dist.get_backend(group)
        cam = pipeline.frame_camera(preset, SHARDED_FRAME, WIDTH, HEIGHT, dev)
        soup = pipeline.build_primitives(preset, cam, pcl[:, :3],
                                         pcl[:, 3:], SHARDED_FRAME)
        bins = tiles.bin_primitives(soup, WIDTH, HEIGHT, max_per_tile=1)
        cap = int(bins.counts.max())
        for b, kernel in SHARDED_BACKENDS.items():
            cfg = sharded_config(b, cap)
            reset_counts(counters)
            fr = sharded_frame(preset, pcl, cfg, mesh)
            torch.cuda.synchronize()
            counts = launch_counts(counters)
            check(counts == {kernel: 1},
                  f"world-of-one {b} frame: launches {counts}")
            nums[SHARDED_KERNELS[kernel]] = dict(sharded_launches=1)
            pipe = pipeline.FramePipeline(preset, cfg, device=dev)
            want = frame_tensors(pipe.render_array(pcl, SHARDED_FRAME))
            got = frame_tensors(fr)
            ovf = int(fr.overflow)
            note = ""
            if b == "tiled" and ovf:
                # The capped walk (mirrored from the JAX package) drops
                # what passes its 64-prim big list: the frame is the
                # capped single-device render, not the exact one.
                d, i, _ = tiles.rasterize_tiled(soup, WIDTH, HEIGHT,
                                                max_per_tile=cap)
                capped = (d, i, shade_framebuffer(soup, cam, d, i,
                                                  cfg.shading))
                check_equal_bits(got, capped, "the world-of-one tiled frame "
                                 "vs the capped single-device render")
                differ = int((got[1] != want[1]).sum())
                note = (f"; the big list's cap of {tiles.MAX_BIG} drops "
                        f"{ovf} of {int(bins.big_count)} big prims: == the "
                        f"capped single-device render bit for bit, "
                        f"{differ} winners differ from FramePipeline's exact "
                        "frame")
            else:
                check(ovf == 0, f"world-of-one {b} frame overflowed ({ovf})")
                check_equal_bits(got, want, f"the world-of-one {b} frame vs "
                                 "FramePipeline's")
                note = "; == FramePipeline's frame bit for bit (rgb, depth, " \
                       "index)"
            if b != "tiled":
                torch.save(got, os.path.join(tmp, f"a_{b}.pt"))
            ms = wall_ms(lambda: sharded_frame(preset, pcl, cfg, mesh))
            single = wall_ms(lambda: pipe.render_array(pcl, SHARDED_FRAME))
            caps = f" (max_per_tile {cap})" if b == "tiled" else ""
            print(f"[sharded] world 1 ({backend}, host copies "
                  f"{rp.host_copies(group, dev)}) {b}: traj_ball frame "
                  f"{SHARDED_FRAME}, {pcl.shape[0]} points, {WIDTH}x{HEIGHT}"
                  f"{caps}: {ms:.2f} ms per sharded frame warm, FramePipeline "
                  f"{single:.2f} ms; {SHARDED_KERNELS[kernel]} launches "
                  f"{counts[kernel]}{note} ({card})", flush=True)
        print(f"[sharded] world 1 ({backend}): the merge's four all-reduces "
              f"at {WIDTH}x{HEIGHT}: {merge_ms(group, dev):.3f} ms "
              f"({card})", flush=True)
        del soup, bins
    finally:
        dist.destroy_process_group()

    # (b), (c): two ranks on the one card.  The kernels are built (phase
    # 2), so the ranks only load them.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.spawn(sharded_rank, args=(port, tmp), nprocs=SHARDED_RANKS,
                   join=False)
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline,
                  f"the {SHARDED_RANKS}-rank world did not finish in "
                  f"{SHARDED_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SmokeFailure(f"a rank of the {SHARDED_RANKS}-rank world "
                           f"failed:\n{e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    ranks = []
    for r in range(SHARDED_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        for b, counts in res["launches"].items():
            kernel = SHARDED_BACKENDS[b]
            check(counts == {kernel: 1},
                  f"rank {r}'s 2-rank {b} frame: launches {counts}")
        for scene, st in res["stream"].items():
            kernel = {"disc": "raster_tiles_disc8",
                      "trail": "raster_tiles_cap10"}[scene]
            n = {"disc": 2, "trail": 1}[scene]
            check(st["launches"] == {kernel: n},
                  f"rank {r}'s {scene} mesh stream: launches "
                  f"{st['launches']}")
    r0 = ranks[0]
    print(f"[sharded] world {SHARDED_RANKS} ({r0['backend']} on one card, "
          f"host copies {r0['host_copies']}): the point-sharded pallas6 and "
          f"pallas4 frames == the world of one's bit for bit, one launch per "
          f"rank; {r0['frame_ms']:.2f} ms per sharded pallas6 frame warm "
          f"(rank 0; rank 1 {ranks[1]['frame_ms']:.2f}); the merge's four "
          f"all-reduces {r0['merge_ms']:.3f} ms ({card})", flush=True)
    print(f"[sharded] render_scene_batch_sharded of frames {SHARDED_BATCH} "
          f"on a (2, 1) and a (1, 2) mesh: each frame == its single-device "
          f"FramePipeline frame bit for bit ({card})", flush=True)
    for scene, st in r0["stream"].items():
        print(f"[sharded] mesh stream, {scene} scene ({STREAM_CHUNK} points "
              f"a chunk, {STREAM_FILM[0]}x{STREAM_FILM[1]}): the 2-rank "
              f"stream == the one-rank stream bit for bit (depth, index, "
              f"attributes); {st['ms']:.2f} ms per chunk on rank 0; "
              f"launches per rank {st['launches']}; staging waits "
              f"{[r['stream'][scene]['staging_waits'] for r in ranks]} "
              f"({card})", flush=True)
    print(f"[sharded] phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return nums


# Phase 17: bench.py's trail lane with --trail-segments adaptive (its
# tuned knobs: rows9, three_tone, span and max_big by its probe, the
# row_budget by :808-820) on 1M points, 1920x1080, over linspace(20, 219,
# ADAPTIVE_FRAMES) (bench.py:705), beside the same lane at segments 4;
# the droplet lane's adaptive frames.
ADAPTIVE_POINTS = 1_000_000
ADAPTIVE_FRAMES = 40
ADAPTIVE_CHECK_FRAMES = (120, 219)
ADAPTIVE_DROPLET_FRAMES = (20, 120, 219)
# The walks held against their plain versions on the adaptive soup, each
# with the sized row_budget and with half the binned rows: (kernel, knobs).
ADAPTIVE_WALKS = (
    ("csr6_raster", dict(span=2)),
    ("csr6_raster", dict(span=2, allow_exit=False)),
    ("csr6_raster", dict(span=4)),
    ("csr6_cap10", dict(span=4, cap_rows10=True)),
    ("csr6_rows9", dict(span=4, rows9=True)),
)


def row_budget_for(binned):
    """bench.py:816-817's row_budget over the probed binned prefixes: 10%
    and 8,192 rows over the largest, in multiples of 4,096."""
    need = int(max(binned) * 1.10) + 8192
    return -(-need // 4096) * 4096


def lane_probe(csr6, soup_fn, frames):
    """bench.py:722-760's probe of a lane: the big count and the binned
    prefix at every span over 4 of ``frames`` -> (span, max_big, {span:
    [binned per probe frame]}, {span: [big per probe frame]}, the probe
    frames).  The span is the smallest whose worst frame has at most
    2,048 big rows; max_big 1.5x that plus 64, rounded up to 256 (384 at
    least)."""
    probe = list(dict.fromkeys([frames[0], frames[len(frames) // 2],
                                frames[-2], frames[-1]]))
    bigs = {s: [] for s in csr6.SPANS}
    binned = {s: [] for s in csr6.SPANS}
    for fi in probe:
        soup, _ = soup_fn(fi)
        for s in csr6.SPANS:
            big, n_small = csr6.bin_diagnostics6(
                soup, WIDTH, HEIGHT, max_big=0, span=s, return_binned=True)
            bigs[s].append(int(big))
            binned[s].append(int(n_small))
    span = next((s for s in csr6.SPANS if max(bigs[s]) <= 2048), 8)
    need = int(max(bigs[span]) * 1.5) + 64
    max_big = 384 if need <= 384 else ((need + 255) // 256) * 256
    check(max_big <= 65536, f"probed big list {bigs}")
    return span, max_big, binned, bigs, probe


def lane_tones(csr6, soup):
    """bench.py:780-804: the three-tone reps of a soup, else its four-tone
    reps, else None."""
    reps3, ok3 = csr6.derive_three_tone(soup)
    if bool(ok3):
        return tuple(int(r) for r in reps3.cpu())
    reps4, ok4 = csr6.derive_four_tone(soup)
    return tuple(int(r) for r in reps4.cpu()) if bool(ok4) else None


def cut_checks(csr6, soup, fi, sized, max_big, max_err, what,
               walks=ADAPTIVE_WALKS):
    """Each walk of ``walks`` == its plain version bit for bit on
    ``soup``, with its span's sized row_budget (every exact walk's uncut
    frame is one plain frame, rows9's another) and with half its binned
    rows (row_overflow > 0, the cut frame != the uncut one) -> [(kernel,
    knobs, budget, binned, row_overflow)]."""
    import torch

    plain_full = {}

    def full(key, span):
        if key not in plain_full:
            plain_full[key] = csr6.rasterize_csr6(
                soup, WIDTH, HEIGHT, max_big=max_big, plain=True, span=span,
                rows9=key == "rows9")
        return plain_full[key]

    out = []
    for name, kw in walks:
        span = kw["span"]
        _, n_small = csr6.bin_diagnostics6(soup, WIDTH, HEIGHT, max_big=0,
                                           span=span, return_binned=True)
        n_small = int(n_small)
        for budget in (sized[span], n_small // 2):
            got = csr6.rasterize_csr6(soup, WIDTH, HEIGHT, max_big=max_big,
                                      row_budget=budget, **kw)
            cut = budget < n_small
            key = "rows9" if kw.get("rows9") else "exact"
            want = (csr6.rasterize_csr6(soup, WIDTH, HEIGHT, max_big=max_big,
                                        row_budget=budget, plain=True, **kw)
                    if cut else full(key, span))
            torch.cuda.synchronize()
            label = (f"{what} frame {fi} {name} {kw} row_budget {budget} "
                     f"({n_small} binned)")
            check(int(got[2]["big_overflow"]) == 0, f"{label}: big list "
                  "overflowed")
            ovf = int(got[2]["row_overflow"])
            check(ovf == max(n_small - budget, 0)
                  and ovf == int(want[2]["row_overflow"]),
                  f"{label}: row_overflow {ovf}")
            err = check_equal_bits(got[:2], want[:2], label)
            max_err[name] = max(max_err[name], err)
            if cut:
                check(not torch.equal(got[1], full(key, span)[1]),
                      f"{label}: the cut changed nothing")
            out.append((name, kw, budget, n_small, ovf))
    return out


def time_walk16(csr6, soup, max_big, span):
    """csr6_raster at ``span`` (no exit) on ``soup``: == its plain version
    bit for bit -> dict(err, ms, plain_ms, bound_ms, bound_by, the tile
    rows and work items); the bound counts 17 operations per pair of the
    tile rows and every pixel x every live big row (walk_bound)."""
    import torch

    b = csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big, span=span)
    check(int(b["diag"]["big_overflow"]) == 0, "big list overflowed")
    zeros = torch.zeros((soup.count, 3), device=soup.device)
    args = (csr6.build_table16(soup, zeros, zeros[:, 0]), b["order"],
            b["starts"], b["big_ids"], b["big_n"], WIDTH, HEIGHT, False,
            span)
    want = csr6.raster_tiles_plain(*args)
    err = check_equal_bits(csr6.raster_tiles(*args), want,
                           f"csr6_raster span {span}")
    bound_ms, bound_by = walk_bound(b, soup, WIDTH, HEIGHT, 64,
                                    OPS_CAPSULE16, 2, span=span)
    return dict(err=err, ms=time_ms(lambda: csr6.raster_tiles(*args), 11),
                plain_ms=time_ms(lambda: csr6.raster_tiles_plain(*args), 1),
                bound_ms=bound_ms, bound_by=bound_by,
                **tile_stats(csr6, b, WIDTH, HEIGHT, span,
                             int(b["big_n"][0])))


def adaptive_stages(csr6, pipeline, trails_mod, prims_mod, render_mod,
                    trajectory, preset, cam, pos, vel, fi, cfg, segs):
    """The stages of one lane frame: the soup build's parts (at
    ``segs="adaptive"`` the trail terms, the endpoints' projection, the
    cost argmin, the vertices and the capsules apart), then the render
    under rows9 (binning, rows, kernel, the tone shade), as
    build_primitives and render_shaded_csr6 run them."""
    import numpy as np
    import torch

    w, h, span = WIDTH, HEIGHT, cfg.span
    color = np.asarray(preset.trail_color, np.float32)

    def furniture(f):
        n = pos.shape[0]
        f["parts"] = [
            render_mod.ground_plane(cam, preset.ground_half_extent,
                                    preset.ground_center),
            prims_mod.discs_from_points(
                pos, cam, torch.full((n,), preset.point_radius,
                                     device=pos.device),
                np.asarray(preset.point_color, np.float32))]

    def terms(f):
        f["dir"], f["len"], _ = trails_mod.velocity_trail_lengths(
            pos, vel, fi, preset.trail_schedule)

    def extents(f):
        f["ext"] = pipeline._trail_extents(pos, f["dir"], f["len"], cam,
                                           preset.trail_radius)

    def argmin(f):
        f["k"] = pipeline._cheapest_segment_counts(*f["ext"])

    def vertices(f):
        f["pts"], f["vv"] = trails_mod.velocity_trails_adaptive(
            pos, vel, fi, f["k"], pipeline.TRAIL_ADAPTIVE_BUDGET,
            preset.trail_schedule)

    def capsules(f):
        f["parts"].append(prims_mod.capsules_from_polylines(
            f["pts"], f["vv"], cam, preset.trail_radius, color))

    def columns(f):
        sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS,
                                   segs + 1)).astype(np.int32)
        f["cols"], f["valid"] = trails_mod.velocity_trail_vertex_columns(
            pos, vel, fi, sub, preset.trail_schedule)

    def capsules_cols(f):
        f["parts"].append(prims_mod.capsules_from_vertex_columns(
            f["cols"], [f["valid"]] * len(f["cols"]), cam,
            preset.trail_radius, color))

    def concat(f):
        f["soup"] = prims_mod.ScreenPrimitives.concatenate(f["parts"])

    def binning(f):
        f["b"] = csr6.bin_csr6(f["soup"], w, h, cfg.max_big, span=span,
                               kind_split=True)
        f["order"], _ = csr6.cut_order(f["b"]["order"], f["b"]["starts"][-1],
                                       cfg.row_budget)

    def tables(f):
        soup, b = f["soup"], f["b"]
        f["zeros"] = torch.zeros((soup.count, 3), device=soup.device)
        f["rows9"] = csr6.build_table9(soup, f["order"], b["starts"][-1])
        f["big"] = csr6.build_table16_rows(soup, f["zeros"],
                                           f["zeros"][:, 0], b["big_ids"])

    def kernel(f):
        b = f["b"]
        f["depth"], f["index"] = csr6.raster_tiles_rows9(
            f["rows9"], f["big"], b["starts"], b["big_n"], w, h, span)

    def shade(f):
        f["rgb"] = csr6.shade_by_id(f["soup"], cam, cfg.shading, f["depth"],
                                    f["index"], f["zeros"], f["zeros"][:, 0],
                                    three_tone=cfg.three_tone)

    if segs == "adaptive":
        trail = [("trail terms", terms), ("endpoint projection", extents),
                 ("cost argmin", argmin), ("adaptive vertices", vertices),
                 ("trail capsules", capsules)]
    else:
        trail = [("trail vertex columns", columns),
                 ("trail capsules", capsules_cols)]
    return ([("ground + discs", furniture)] + trail
            + [("concatenate", concat), ("binning (kind split)", binning),
               ("table9 + big rows", tables), ("csr6_rows9 kernel", kernel),
               ("shade_by_id (tones)", shade),
               ("srgb_encode_u8",
                lambda f: trajectory.srgb_encode_u8(f["rgb"])),
               ("certificate read-back",
                lambda f: int(f["b"]["diag"]["big_overflow"]))])


def adaptive_lane(card, dev, max_err, counters, tmp) -> dict:
    """Phase 17 (see the module docstring) -> {kernel: its adaptive_
    numbers}."""
    import dataclasses

    import numpy as np
    import torch

    from pointcloud_render_tpu_torch.configs import PRESETS
    from pointcloud_render_tpu_torch.geometry import trails as trails_mod
    from pointcloud_render_tpu_torch.raster import csr6
    from pointcloud_render_tpu_torch.raster import primitives as prims_mod
    from pointcloud_render_tpu_torch.raster import render as render_mod
    from pointcloud_render_tpu_torch.raster.render import (
        RasterConfig,
        render,
    )
    from pointcloud_render_tpu_torch.run import pipeline, trajectory

    t_phase = time.perf_counter()
    n = ADAPTIVE_POINTS
    budget_k = pipeline.TRAIL_ADAPTIVE_BUDGET
    # bench.py:383-384, :698-699: positions uniform in [-0.5, 0.5)^3 from
    # seed 0, velocities normal(0, 2) from seed 1.
    pos = torch.tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (n, 3)).astype(np.float32), device=dev)
    vel = torch.tensor(np.random.default_rng(1).normal(
        0, 2, (n, 3)).astype(np.float32), device=dev)
    frames = np.linspace(20, 219, ADAPTIVE_FRAMES).astype(np.int32).tolist()

    def lane(preset_name, segs):
        preset = PRESETS[preset_name]

        def soup_fn(fi):
            cam = pipeline.frame_camera(preset, fi, WIDTH, HEIGHT, dev)
            return pipeline.build_primitives(preset, cam, pos, vel, fi,
                                             trail_segments=segs), cam

        span, max_big, binned, bigs, probe = lane_probe(csr6, soup_fn,
                                                        frames)
        sized = {s: row_budget_for(binned[s]) for s in csr6.SPANS}
        cfg = RasterConfig(
            rows9=True, span=span, max_big=max_big,
            row_budget=sized[span] if segs == "adaptive" else None,
            three_tone=lane_tones(csr6, soup_fn(frames[0])[0]))
        print(f"[adaptive] {preset_name} segments {segs}: probe frames "
              f"{probe}: big list by span {bigs}, binned by span {binned}; "
              f"span {span}, max_big {max_big}, row_budget "
              f"{cfg.row_budget}, tones {cfg.three_tone}", flush=True)
        return preset, soup_fn, cfg, sized

    preset, soup_a, cfg_a, sized = lane("traj_ball", "adaptive")
    _, soup_f, cfg_f, _ = lane("traj_ball", budget_k)

    # Kernels against their plain versions on the adaptive soup, with the
    # sized budgets and with half the binned rows.
    reset_counts(counters)
    for fi in ADAPTIVE_CHECK_FRAMES:
        soup, cam = soup_a(fi)
        big = max(int(csr6.bin_diagnostics6(soup, WIDTH, HEIGHT, max_big=0,
                                            span=s)) for s in (2, 4))
        runs = cut_checks(csr6, soup, fi, sized, max(big, 1), max_err,
                          "adaptive")
        print(f"[adaptive] frame {fi}: csr6_raster (span 2 exit on and off, "
              f"span 4), csr6_cap10 and csr6_rows9 (span 4) == plain bit "
              f"for bit with the sized budget (row_overflow 0) and half the "
              f"binned rows (row_overflow "
              f"{sorted({r[4] for r in runs if r[4]})}); big list up to "
              f"{big}", flush=True)
        # A budget that cuts nothing changes nothing: the lane's frame ==
        # the frame with no budget.
        a = render(soup, cam, cfg_a)
        b = render(soup, cam, dataclasses.replace(cfg_a, row_budget=None))
        for field in ("rgb", "depth", "index"):
            check(torch.equal(getattr(a, field).view(torch.int32),
                              getattr(b, field).view(torch.int32)),
                  f"adaptive frame {fi}: {field} with the sized budget != "
                  "without one")
    # csr6_disc8 on the disc lane's frame 120 with half its binned rows.
    disc_preset = dataclasses.replace(PRESETS["traj_ball"],
                                      point_radius=0.002, point_color=LOOK[0])
    cam = pipeline.frame_camera(disc_preset, 120, WIDTH, HEIGHT, dev)
    discs = pipeline.build_primitives(disc_preset, cam, pos, None, 120)
    _, n_disc = csr6.bin_diagnostics6(discs, WIDTH, HEIGHT, discs_only=True,
                                      return_binned=True)
    n_disc = int(n_disc)
    uncut = csr6.rasterize_csr6(discs, WIDTH, HEIGHT, max_big=256,
                                discs_only=True)
    for budget in (n_disc, n_disc // 2):
        got = csr6.rasterize_csr6(discs, WIDTH, HEIGHT, max_big=256,
                                  discs_only=True, row_budget=budget)
        want = csr6.rasterize_csr6(discs, WIDTH, HEIGHT, max_big=256,
                                   discs_only=True, row_budget=budget,
                                   plain=True)
        torch.cuda.synchronize()
        label = f"csr6_disc8 disc lane frame 120 row_budget {budget}"
        max_err["csr6_disc8"] = max(max_err["csr6_disc8"], check_equal_bits(
            got[:2], want[:2], label))
        ovf = int(got[2]["row_overflow"])
        check(ovf == n_disc - budget, f"{label}: row_overflow {ovf}")
        check(torch.equal(got[1], uncut[1]) == (ovf == 0),
              f"{label}: the frame against the uncut one")
    print(f"[adaptive] csr6_disc8 on the disc lane's frame 120 ({n_disc} "
          f"binned discs) == plain bit for bit with row_budget {n_disc} "
          f"(== the uncut frame) and {n_disc // 2} (row_overflow "
          f"{n_disc - n_disc // 2})", flush=True)
    check_launches = launch_counts(counters)

    # The main path: the lane's frames through build_primitives + render,
    # both certificates read once at the end.
    reset_counts(counters)
    certs, cover = [], []
    for fi in frames:
        soup, cam = soup_a(fi)
        fb, diag = render(soup, cam, cfg_a, return_diag=True)
        certs.append(torch.stack([diag["big_overflow"],
                                  diag["row_overflow"]]))
        cover.append((fb.index >= 0).float().mean())
    torch.cuda.synchronize()
    launches = csr6.raster_tiles_rows9.launches
    check(launches == len(frames)
          and set(launch_counts(counters)) == {"raster_tiles_rows9"},
          f"adaptive lane: csr6_rows9 launched {launches} times over "
          f"{len(frames)} frames; launches {launch_counts(counters)}")
    certs = torch.stack(certs).cpu().numpy()
    cover = torch.stack(cover).cpu().tolist()
    check(not certs.any(), f"adaptive lane certificates (big_overflow, "
          f"row_overflow) per frame: {certs.tolist()}")
    check(min(cover) > 0.05, f"adaptive lane frames look empty: {cover}")
    print(f"[adaptive] lane: {len(frames)} frames {frames[0]}..{frames[-1]}, "
          f"big_overflow 0 and row_overflow 0 on every frame, csr6_rows9 "
          f"launches {launches}, covered share {min(cover):.3f}.."
          f"{max(cover):.3f}", flush=True)
    cam = pipeline.frame_camera(preset, frames[1], WIDTH, HEIGHT, dev)
    fi_dev = torch.tensor(float(frames[1]), device=dev)
    _, syncs = host_syncs(lambda: pipeline.build_primitives(
        preset, cam, pos, vel, fi_dev, trail_segments="adaptive"))
    check(not syncs, f"the adaptive soup build synchronises: {syncs}")
    print("[adaptive] soup build (heuristic included) under "
          "set_sync_debug_mode: 0 host synchronisations", flush=True)

    # Per frame: binned rows, tile rows (true_entries), big list and the
    # share of trails at each k, beside segments 4.
    tot = {"adaptive": [0, 0], budget_k: [0, 0]}
    for fi in frames:
        line = []
        for segs, soup_fn, cfg in (("adaptive", soup_a, cfg_a),
                                   (budget_k, soup_f, cfg_f)):
            soup, cam = soup_fn(fi)
            b = csr6.bin_csr6(soup, WIDTH, HEIGHT, cfg.max_big,
                              span=cfg.span, kind_split=True)
            nb, te = int(b["starts"][-1]), int(b["diag"]["true_entries"])
            tot[segs][0] += nb
            tot[segs][1] += te
            line.append(f"segments {segs}: {soup.count} rows, {nb} binned, "
                        f"tile rows {te}, big list {int(b['big_count'])}")
        d, tl, _ = trails_mod.velocity_trail_lengths(
            pos, vel, fi, preset.trail_schedule)
        k = pipeline._adaptive_trail_segment_counts(pos, d, tl, cam,
                                                    preset.trail_radius)
        share = (torch.bincount(k, minlength=budget_k + 1)[1:].double()
                 / n).cpu().tolist()
        print(f"[adaptive] frame {fi}: " + "; ".join(line) + "; trails at k "
              "1-4: " + ", ".join(f"{s:.4f}" for s in share), flush=True)
    print(f"[adaptive] over the {len(frames)} frames: binned rows "
          f"{tot['adaptive'][0]} against {tot[budget_k][0]} at segments 4 "
          f"({tot['adaptive'][0] / tot[budget_k][0]:.3f}), tile rows "
          f"{tot['adaptive'][1]} against {tot[budget_k][1]} "
          f"({tot['adaptive'][1] / tot[budget_k][1]:.3f})", flush=True)

    # Each kernel's time at frame 120, adaptive beside segments 4.
    nums = {}
    for segs, soup_fn, cfg in (("adaptive", soup_a, cfg_a),
                               (budget_k, soup_f, cfg_f)):
        soup, _ = soup_fn(120)
        big = max(int(csr6.bin_diagnostics6(soup, WIDTH, HEIGHT, max_big=0,
                                            span=4)), 1)
        r16 = time_walk16(csr6, soup, big, 4)
        r10, _ = compare_cap10(soup, WIDTH, HEIGHT, csr6, big, 4,
                               timing=True)
        r9, _ = compare_rows9(soup, WIDTH, HEIGHT, csr6, cfg.max_big,
                              cfg.span, timing=True, card=card)
        for name, r, span in (("csr6_raster", r16, 4),
                              ("csr6_cap10", r10, 4),
                              ("csr6_rows9", r9, cfg.span)):
            max_err[name] = max(max_err[name], r["err"])
            nums[name, segs] = r
            print(f"[adaptive] {name} span {span} segments {segs}, frame "
                  f"120: kernel "
                  f"{r['ms']:.3f} ms (median of 11), plain "
                  f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.3f} ms by "
                  f"{r['bound_by']}; {stats_text(r)} ({card})", flush=True)

    # Warm ms per frame of the lane's loop, adaptive and segments 4 in
    # turns (one synchronisation per pass).
    times = {"adaptive": [], budget_k: []}
    for segs in ("adaptive", budget_k, budget_k, "adaptive"):
        soup_fn, cfg = ((soup_a, cfg_a) if segs == "adaptive"
                        else (soup_f, cfg_f))
        t0 = time.perf_counter()
        for fi in frames:
            soup, cam = soup_fn(fi)
            render(soup, cam, cfg)
        torch.cuda.synchronize()
        times[segs].append((time.perf_counter() - t0) * 1e3 / len(frames))
    for segs, ts in times.items():
        print(f"[adaptive] lane loop segments {segs}: warm ms/frame over "
              f"{len(frames)} frames (build_primitives + render, one "
              f"synchronisation a pass): "
              + ", ".join(f"{t:.3f}" for t in ts) + f" ({card})", flush=True)
    for segs, soup_fn, cfg in (("adaptive", soup_a, cfg_a),
                               (budget_k, soup_f, cfg_f)):
        _, cam = soup_fn(120)
        stages = adaptive_stages(csr6, pipeline, trails_mod, prims_mod,
                                 render_mod, trajectory, preset, cam, pos,
                                 vel, 120, cfg, segs)
        for stage, ms in stage_times(stages).items():
            print(f"[stage] adaptive lane segments {segs} frame 120 "
                  f"{stage}: {ms:.3f} ms ({card})", flush=True)
        busy, wall_us, top, _ = device_profile(
            lambda soup_fn=soup_fn, cfg=cfg: render(*soup_fn(120), cfg), 3,
            tmp)
        if top:
            print(f"[trace] adaptive lane segments {segs}, frame 120, 3 "
                  f"warm frames: device busy {busy / 1e3:.2f} of "
                  f"{wall_us / 1e3:.2f} ms wall, idle share "
                  f"{1 - busy / wall_us:.3f} ({card})", flush=True)
            for name, us in top[:5]:
                print(f"[trace] adaptive segments {segs} {us / 3e3:9.3f} "
                      f"ms/frame  {name[:90]}", flush=True)
        else:
            print("[trace] adaptive lane: the profiler saw no device "
                  "activity; device busy share not measured", flush=True)

    # The droplet lane's frames with adaptive trails (traj_vel, 1M
    # droplets, its config by the same probe and the four-tone reps).
    reset_counts(counters)
    dpreset, dsoup, dcfg, dsized = lane("traj_vel", "adaptive")
    for fi in ADAPTIVE_DROPLET_FRAMES:
        soup, cam = dsoup(fi)
        fb, diag = render(soup, cam, dcfg, return_diag=True)
        big, rows = int(diag["big_overflow"]), int(diag["row_overflow"])
        check(big == 0 and rows == 0, f"adaptive droplet frame {fi}: "
              f"big_overflow {big}, row_overflow {rows}")
        print(f"[adaptive] droplet lane frame {fi}: {soup.count} rows, "
              f"big_overflow 0, row_overflow 0", flush=True)
    d_launches = csr6.raster_tiles_rows9.launches
    check(d_launches == len(ADAPTIVE_DROPLET_FRAMES),
          f"adaptive droplet lane: csr6_rows9 launched {d_launches} times")
    soup, _ = dsoup(120)
    runs = cut_checks(csr6, soup, 120, dsized, dcfg.max_big, max_err,
                      "adaptive droplet",
                      walks=(("csr6_rows9", dict(span=dcfg.span,
                                                 rows9=True)),))
    print(f"[adaptive] droplet lane frame 120: csr6_rows9 (span "
          f"{dcfg.span}) == plain bit for bit with row_budget "
          f"{runs[0][2]} (row_overflow 0) and {runs[1][2]} (row_overflow "
          f"{runs[1][4]}); csr6_rows9 launches on the lane's frames "
          f"{d_launches}", flush=True)
    print(f"[adaptive] phase 17 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    out = {name: {"adaptive_check_launches": check_launches.get(wrapper, 0)}
           for name, wrapper in (("csr6_raster", "raster_tiles"),
                                 ("csr6_cap10", "raster_tiles_cap10"),
                                 ("csr6_rows9", "raster_tiles_rows9"),
                                 ("csr6_disc8", "raster_tiles_disc8"))}
    for name in ("csr6_raster", "csr6_cap10", "csr6_rows9"):
        r, f = nums[name, "adaptive"], nums[name, budget_k]
        out[name].update(adaptive_ms=r["ms"], adaptive_plain_ms=r["plain_ms"],
                         adaptive_bound_ms=r["bound_ms"],
                         adaptive_bound_by=r["bound_by"],
                         adaptive_fixed4_ms=f["ms"],
                         adaptive_fixed4_bound_ms=f["bound_ms"])
    out["csr6_rows9"]["adaptive_launches"] = launches
    return out


def run() -> dict:
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    try:
        from pointcloud_render_tpu_torch.cli import traj_ball_renderer
        from pointcloud_render_tpu_torch.configs import PRESETS
        from pointcloud_render_tpu_torch.io import ply
        from pointcloud_render_tpu_torch.raster import (
            csr,
            csr2,
            csr3,
            csr4,
            csr5,
            csr6,
        )
        from pointcloud_render_tpu_torch.raster.render import RasterConfig
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

    counters = kernel_counters()

    # Phase 2: build from the checkout's sources, one nvcc per source (and
    # the parent's csr2_raster.cu under --parent), all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        extra = pool.submit(build_parent, kernels)
        kernels.build_all()
        extra.result()
    for name in kernels.LIBRARIES:
        kernels.load(name)
    print(f"[build] csr6_raster.cu (csr6_raster, csr6_cap10, csr6_disc8, "
          f"csr6_disc8_uv, csr6_rows9, csr4_raster, csr3_raster), "
          f"csr2_raster.cu (csr2_raster, csr2_disc8, csr1_raster), "
          f"csr5_raster.cu (csr5_raster, "
          f"csr5_shaded){' and the parent' if PARENT['libs'] else ''} in "
          f"parallel "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels.LIBRARIES:
        for line in kernels.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)

    # Phase 3: kernel vs plain on seeded soups.
    default_big = csr6.DEFAULT_MAX_BIG
    max_err = dict.fromkeys(REPLACES, 0.0)
    shading = ShadingConfig()
    seeded = soups(dev)
    v5_seeded = dict(seeded)  # phase 12's kernel == plain soups
    for name, soup in seeded.items():
        err = compare(soup, WIDTH, HEIGHT, csr6, csr4, default_big)[0]["err"]
        max_err["csr6_raster"] = max(max_err["csr6_raster"], err)
        print(f"[kernel==plain] csr6_raster {name}: {soup.count} prims ok "
              f"(exit off and on, items of {csr6.SPLIT_ROWS} and "
              f"{SPLIT_FORCED} rows)", flush=True)
    exit_split_soups(dev, csr6, csr4, max_err)
    # The disc-row kernels on the same soups (their capsules ride the big
    # list; "mixed" is left to "invalid_nearclip", the same rows with
    # holes) and on a two-tone disc scene: exact ties, two wide discs.
    del seeded["mixed"]
    seeded["disc_ties_wide"] = disc_lane_soup(dev)
    # Each at spans 2, 4 and 8, with items of csr6.SPLIT_ROWS_DISC and of
    # SPLIT_FORCED rows, csr6_disc8 at span 2 also with the exit forced on;
    # and the cull's band soup (discs tangent to its bands, centred on
    # band boundaries, over a ragged bottom band, ties across items) on
    # its own film.
    cam = soup_camera(dev)
    ts = torch_soups()
    disc_cases = [(name, soup, cam, WIDTH, HEIGHT)
                  for name, soup in seeded.items()]
    disc_cases.append(("band", ts.band_soup().to(dev),
                       ts.tcam(device=dev), ts.W, ts.H))
    for name, soup, c, w, h in disc_cases:
        _, flag = csr6.preshade(soup, c, shading)
        for span in csr6.SPANS:
            res, b = compare_disc(soup, flag, w, h, csr6, 1 << 16,
                                  span=span)
            for kernel, r in res.items():
                max_err[kernel] = max(max_err[kernel], r["err"])
        print(f"[kernel==plain] csr6_disc8, csr6_disc8_uv {name} ({w}x{h}): "
              f"{soup.count} prims, big list {int(b['big_count'])} ok (spans "
              f"2, 4, 8; items of {csr6.SPLIT_ROWS_DISC} and {SPLIT_FORCED} "
              "rows; csr6_disc8 exit on at span 2)", flush=True)
    # Phase 8 (a): the kind-split kernel at spans 2, 4 and 8 on the same
    # soups and on seeded traj_vel soups.
    # Phase 10 (a): csr6_cap10 at spans 2, 4 and 8 and csr6_raster at 4
    # and 8 on the same soups.
    seeded.update(droplet_soups(dev))
    for name, soup in seeded.items():
        for span in csr6.SPANS:
            res, b = compare_rows9(soup, WIDTH, HEIGHT, csr6, 1 << 16, span)
            max_err["csr6_rows9"] = max(max_err["csr6_rows9"], res["err"])
            print(f"[kernel==plain] csr6_rows9 span {span} {name}: "
                  f"{soup.count} prims, {int(b['starts'][-1])} binned, big "
                  f"list {int(b['big_count'])} ok (items of "
                  f"{csr6.SPLIT_ROWS} and {SPLIT_FORCED} rows)", flush=True)
            res, _ = compare_cap10(soup, WIDTH, HEIGHT, csr6, 1 << 16, span)
            max_err["csr6_cap10"] = max(max_err["csr6_cap10"], res["err"])
            if span != 2:
                r16, _ = compare(soup, WIDTH, HEIGHT, csr6, csr4, 1 << 16,
                                 span=span)
                max_err["csr6_raster"] = max(max_err["csr6_raster"],
                                             r16["err"])
            print(f"[kernel==plain] csr6_cap10{'' if span == 2 else ', csr6_raster'}"
                  f" span {span} {name}: {res['binned']} binned, big list "
                  f"{res['big']} ok", flush=True)
    v3_soups = {k: seeded[k] for k in ("disc_ties_wide", "big_list",
                                        "invalid_nearclip")}
    del seeded
    preset = PRESETS["traj_ball"]
    pos, vel = flagship_cloud(20000, seed=7)
    pcl = normalize.transform_coordinates(normalize.standardize_point_cloud(
        np.concatenate([pos, vel], axis=1)), flip_x=preset.flip_x)
    cam = pipeline.frame_camera(preset, 120, WIDTH, HEIGHT, dev)
    small = pipeline.build_primitives(preset, cam, pcl[:, :3], pcl[:, 3:],
                                      120)
    err = compare(small, WIDTH, HEIGHT, csr6, csr4, default_big)[0]["err"]
    max_err["csr6_raster"] = max(max_err["csr6_raster"], err)
    print(f"[kernel==plain] traj_ball 20k frame 120: {small.count} prims ok",
          flush=True)
    # Phase 9 (a): the binned-triangle walk and the v4 walk.
    mesh_kernels_vs_plain(dev, csr6, csr4, max_err)
    # Phase 11 (a): the v1 and v2 strip walks.
    strip_kernels_vs_plain(dev, max_err)

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
        reset_counts(counters)
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
            res, _ = compare(soup, WIDTH, HEIGHT, csr6, csr4, max_big,
                             timing=True)
            max_err["csr6_raster"] = max(max_err["csr6_raster"], res["err"])
            timed[fi] = res
            b = csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big)
            print(f"[time] frame {fi} shape: {n} points, {soup.count} prims, "
                  f"{int(b['starts'][-1])} binned, true_entries "
                  f"{int(b['diag']['true_entries'])}, big list "
                  f"{int(b['big_count'])}", flush=True)
            print_v6_times("csr6_raster", res, f"traj_ball frame-{fi}", card)
            # The default frame takes the exit: the exit-off frame equals it.
            off = pipeline.FramePipeline(
                preset, RasterConfig(allow_exit=False, max_big=max_big),
                device=dev)
            equal_buffers(off.render_array(clouds[fi], fi),
                          pipe.render_array(clouds[fi], fi),
                          f"traj_ball frame {fi}: exit off vs the default")
            print(f"[exit] traj_ball frame {fi}: the default frame (exit "
                  "on) == allow_exit=False bit for bit (rgb, depth, index)",
                  flush=True)
            if fi == 120:
                keys = {z: time_ms(lambda z=z: csr6.bin_csr6(
                    soup, WIDTH, HEIGHT, max_big, with_z=z), 11)
                        for z in (True, False)}
                print(f"[time] bin_csr6 at the traj_ball frame-120 shape: "
                      f"{keys[True]:.3f} ms with the int32 exit key, "
                      f"{keys[False]:.3f} ms with the int16 key (medians of "
                      f"11; {soup.count} keys) ({card})", flush=True)
                zeros = torch.zeros((soup.count, 3), device=dev)
                bz = csr6.bin_csr6(soup, WIDTH, HEIGHT, max_big, with_z=True)
                sweep = (csr6.build_table16(soup, zeros, zeros[:, 0]),
                         bz["order"], bz["starts"], bz["big_ids"],
                         bz["big_n"], WIDTH, HEIGHT)
                split_sweep("csr6_raster exit off, traj_ball frame 120",
                            lambda w, wk: csr6.raster_tiles(
                                *sweep, split_rows=w, walked=wk), card)
                split_sweep("csr6_raster exit on, traj_ball frame 120",
                            lambda w, wk: csr6.raster_tiles(
                                *sweep, zmeta=bz["zmeta"], split_rows=w,
                                walked=wk), card,
                            csr6.tile_rows(bz["starts"], WIDTH, HEIGHT))
                del sweep, zeros, bz
            if fi in (120, 205):
                # Phase 10: the cap_rows10 walk renders the same frame.
                cap10 = pipeline.FramePipeline(
                    preset, RasterConfig(cap_rows10=True, max_big=max_big),
                    device=dev)
                equal_buffers(cap10.render_array(clouds[fi], fi),
                              pipe.render_array(clouds[fi], fi),
                              f"traj_ball frame {fi}: cap_rows10 vs default")
                print(f"[heal] frame {fi}: cap_rows10 frame == the default "
                      "walk's bit for bit (rgb, depth, index)", flush=True)
        del clouds, soup
        # Phase 8 (b): the traj_vel CLI on the same PLYs.
        droplet_cli(card, inp, os.path.join(tmp, "out_vel"), counters)
        # Phase 9 (c): the same PLYs through --backend pallas4.
        v4 = v4_flagship(card, dev, inp, out, os.path.join(tmp, "out_v4"),
                         counters, max_err)
        # Phase 11 (b): the same PLYs through --backend pallas.
        strips = v2_flagship(card, dev, inp, out,
                             os.path.join(tmp, "out_v2"), counters, max_err)
        # Phase 14: the look passes on the same PLYs.
        shadow_nums = look_phase(card, dev, inp,
                                 os.path.join(tmp, "out_look"), counters,
                                 max_err)
    # Phase 7: bench.py's disc lane and the flythrough loop.
    disc = disc_lane(card, dev, max_err, counters)
    # Phase 8 (c): bench.py's droplet lane.
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        droplet = droplet_lane(card, dev, max_err, counters, tmp)
    # Phase 9 (b): 10,000 mesh-LOD droplets.
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        mesh = mesh_lane(card, dev, max_err, counters, tmp)
    # Phase 10 (b): the traj preset at 700,000 points (cap_rows10).
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        traj = traj_slice(card, dev, max_err, counters, tmp)
    # Phase 10 (c): the v3 disc fast path (pallas3).
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        v3 = v3_lane(card, dev, max_err, counters, tmp, v3_soups)
    # Phase 11 (c): bench.py's disc lane through backend pallas.
    disc2 = v2_disc_lane(card, dev, max_err, counters)
    # Phase 12: the v5 slice (and B4's disc rows at spans 4 and 8).
    v5_seeded["disc_ties_wide"] = disc_lane_soup(dev)
    v5 = v5_lane(card, dev, max_err, counters, v5_seeded)
    # Phase 13: the fidelity certificate of segments and rows9.
    fidelity_phase(card, dev, counters)
    # Phase 15: the stream (BASELINE.json config 5).
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        stream = stream_phase(card, dev, counters, max_err, tmp)
    # Phase 16: the sharded renders (ROADMAP A15).
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        sharded = sharded_phase(card, dev, counters, tmp)
    # Phase 17: the adaptive trail lane and row_budget.
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        adaptive = adaptive_lane(card, dev, max_err, counters, tmp)
    # csr1_raster's entry stays rasterize_csr's walk at traj_ball frame 120
    # (phase 11 (b)); the shadow map's numbers (phase 14, its launches the
    # look CLI's) ride under shadow_.
    strips["csr1_raster"] = dict(
        strips["csr1_raster"],
        **{f"shadow_{k}": v for k, v in shadow_nums.items()})
    numbers = {"csr6_raster": dict(timed[120], launches=launches), **disc,
               "csr6_rows9": droplet, "csr6_raster[bin_triangles]": mesh,
               "csr4_raster": v4, "csr6_cap10": traj, "csr3_raster": v3,
               **strips, "csr2_disc8": disc2, **v5}
    for name, extra in stream.items():
        numbers[name] = dict(numbers[name], **extra)
    for name, extra in (*sharded.items(), *adaptive.items()):
        numbers[name] = dict(numbers[name], **extra)
    return dict(card=card, kernels=[dict(
        name=name, route="cuda",
        source=(STRIP_SOURCE if name in STRIP_KERNELS else V5_SOURCE
                if name.startswith("csr5") else KERNEL_SOURCE),
        replaces=REPLACES[name], launches=numbers[name]["launches"],
        max_abs_err=max_err[name], ms=numbers[name]["ms"],
        plain_ms=numbers[name]["plain_ms"],
        bound_ms=numbers[name]["bound_ms"],
        bound_by=numbers[name]["bound_by"], library_ms=None,
        **{k: numbers[name][k] for k in EXTRA_KEYS
           if numbers[name].get(k) is not None})
        for name in REPLACES])


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--parent"] and len(args) == 2:
        PARENT["tree"] = os.path.abspath(args[1])
    elif args:
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
