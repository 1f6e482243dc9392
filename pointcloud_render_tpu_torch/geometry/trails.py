"""Trail geometry: velocity-extrapolated and Catmull-Rom history-fit
trails (the PyTorch twin of ``pointcloud_render_tpu.geometry.trails``).

Three length-scale schedules exist across the reference scripts:

* ``"ball"``  — ramp f/19 for frames 0-19, then hold 1.0
  (reference: traj_ball_renderer.py:119-124);
* ``"vel"``   — ramp 0-19, hold 20-199, fade 1-(f-199)/20 for 200-219
  (reference: traj_vel_renderer.py:215-224);
* ``"fixed"`` — constant 1.0 (reference: traj_b0.py:127).

``velocity_trail_points`` is the exact host float64 replay of one trail
(the golden 21-point state layer); ``velocity_trails`` the batched float32
tensor build; ``velocity_trails_sampled`` the same at the sampled
vertices only, as an (N, K, 3) polyline (the streamed trail soup's
build), and ``velocity_trail_vertex_columns`` the production build that
computes only those vertices as packed columns;
``velocity_trails_adaptive`` samples each trail at its own segment count
k (``trail_segments="adaptive"``), from the terms that
``velocity_trail_lengths`` exposes.  ``catmull_rom_trails``
fits the traj preset's trails through the last frames' positions
(traj_renderer.py:204-396).  The float32 builds keep
the JAX expression order with explicit component sums (no
``torch.linalg.norm``) and tensor divisors, so CPU and CUDA agree bit for
bit (see ``scene/camera.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_render_tpu_torch.utils.consts import as_f32, const
from pointcloud_render_tpu_torch.utils.ieee import sqrt_rn

VELOCITY_EPS = 1e-6  # reference: traj_ball_renderer.py:112
BASE_TRAIL_LENGTH = 0.07  # reference: traj_ball_renderer.py:132
MAX_TRAIL_LENGTH = 0.3  # reference: traj_ball_renderer.py:133
VEL_NORMALIZER = 10.0  # reference: traj_ball_renderer.py:134
N_TRAIL_POINTS = 20  # samples before the appended current position
TRAIL_DEDUP_EPS = 1e-5  # reference: traj_renderer.py:359
HISTORY_WINDOW = 20  # reference: traj_renderer.py:218
LAST_MOTION_FRAME = 199
FADE_FRAMES = 20


def trail_length_scale(schedule: str, frame_index, device=None) -> torch.Tensor:
    """Length-scale factor for a frame as a float32 scalar tensor."""
    f = as_f32(frame_index, device)
    if schedule == "fixed":
        return torch.ones_like(f)
    ramp = f / as_f32(19.0, device)
    one = torch.ones_like(f)
    if schedule == "ball":
        return torch.where(f <= 19, ramp, one)
    if schedule == "vel":
        fade = 1.0 - (f - LAST_MOTION_FRAME) / as_f32(FADE_FRAMES, device)
        return torch.where(f <= 19, ramp,
                           torch.where(f <= LAST_MOTION_FRAME, one, fade))
    raise ValueError(f"unknown schedule {schedule!r}")


def velocity_trail_points(position, velocity, length_scale) -> np.ndarray:
    """Exact host-side single-point replay -> (21, 3) float64 polyline.

    Point i sits at position + (-v/|v|) * L * t_i with t_i = (19-i)/19,
    from the far end toward the position; the position itself is then
    appended (so the last two points coincide,
    reference: traj_ball_renderer.py:141-150).
    """
    velocity = np.array(velocity, dtype=np.float64)
    vel_norm = np.linalg.norm(velocity)
    vel_normalized = min(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * length_scale
    direction = -velocity / vel_norm
    ts = (N_TRAIL_POINTS - 1 - np.arange(N_TRAIL_POINTS)) / (N_TRAIL_POINTS - 1)
    pts = np.asarray(position)[None, :] + direction[None, :] * trail_length * ts[:, None]
    return np.concatenate([pts, np.asarray(position, np.float64)[None, :]], axis=0)


def _trail_terms(positions, velocities, frame_index, schedule):
    """Shared float32 terms: (p, direction, trail_length, valid)."""
    p = positions.to(torch.float32)
    v = velocities.to(torch.float32)
    dev = p.device
    scale = trail_length_scale(schedule, frame_index, device=dev)
    vel_norm = sqrt_rn(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                       + v[:, 2] * v[:, 2])
    valid = (vel_norm >= VELOCITY_EPS) & (scale > 0)
    vel_normalized = torch.minimum(vel_norm / as_f32(VEL_NORMALIZER, dev),
                                   torch.ones_like(vel_norm))
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * scale
    safe = torch.where(vel_norm < VELOCITY_EPS, torch.ones_like(vel_norm),
                       vel_norm)
    direction = -v / safe[:, None]
    return p, direction, trail_length, valid


def velocity_trail_lengths(positions, velocities, frame_index,
                           schedule: str = "ball"):
    """(direction (N, 3), trail_length (N,), valid (N,)): the float32 terms
    every straight-trail build shares (the same tensors the sampled and
    column builds use), exposed so that the adaptive segment count can
    project trail endpoints without building vertices."""
    return _trail_terms(positions, velocities, frame_index, schedule)[1:]


def _ts_full() -> np.ndarray:
    return (N_TRAIL_POINTS - 1
            - np.arange(N_TRAIL_POINTS, dtype=np.float32)) / (N_TRAIL_POINTS - 1)


def sampled_ts_table(budget: int) -> np.ndarray:
    """(budget, budget + 1) float32: row ``k - 1`` holds the t values of
    the k-segment sampled build, 0 (the position) past vertex k.  The
    vertex indices are the fixed-k build's ``round(linspace(0, 20, k +
    1))`` (``run.pipeline.build_primitives``), so a trail that the
    adaptive build samples at k segments has the k-segment build's
    vertices bit for bit."""
    ttab = np.zeros((budget, budget + 1), np.float32)
    ts_full = _ts_full()
    for kk in range(1, budget + 1):
        idx = np.round(np.linspace(0, N_TRAIL_POINTS, kk + 1)).astype(np.int64)
        tr = ts_full[np.minimum(idx, N_TRAIL_POINTS - 1)]
        tr[idx >= N_TRAIL_POINTS] = 0.0
        ttab[kk - 1, :kk + 1] = tr
    return ttab


def velocity_trails(positions, velocities, frame_index, schedule: str = "ball"):
    """Batched trails for a whole cloud.

    Returns (points (N, 21, 3) float32, valid (N,) bool): velocity above
    epsilon, length scale > 0 and every vertex finite
    (reference: traj_ball_renderer.py:112,127).
    """
    p, direction, trail_length, valid = _trail_terms(
        positions, velocities, frame_index, schedule)
    ts = as_f32(_ts_full(), p.device)
    offsets = direction[:, None, :] * (trail_length[:, None] * ts[None, :])[..., None]
    pts = torch.cat([p[:, None, :] + offsets, p[:, None, :]], dim=1)
    valid = valid & torch.isfinite(pts.reshape(pts.shape[0], -1)).all(dim=1)
    return pts, valid


def velocity_trails_sampled(positions, velocities, frame_index, indices,
                            schedule: str = "ball"):
    """``velocity_trails`` evaluated only at vertex ``indices``: points
    (N, K, 3) and valid (N,), bit for bit ``velocity_trails(...)[0][:,
    indices]`` and its mask (the same float32 expression at the same t;
    index 20 is the position itself; the mask keeps the full build's
    21-vertex finiteness rule, since non-finite values can only come from
    non-finite inputs, which poison every vertex)."""
    p, direction, trail_length, valid = _trail_terms(
        positions, velocities, frame_index, schedule)
    idx = np.asarray(indices, np.int64)
    ts = _ts_full()[np.minimum(idx, N_TRAIL_POINTS - 1)]
    ts[idx >= N_TRAIL_POINTS] = 0.0
    offsets = direction[:, None, :] * (
        trail_length[:, None] * as_f32(ts, p.device)[None, :])[..., None]
    pts = p[:, None, :] + offsets
    is_pos = const(idx >= N_TRAIL_POINTS, np.bool_, p.device)
    pts = torch.where(is_pos[None, :, None], p[:, None, :].expand_as(pts),
                      pts)
    valid = valid & torch.isfinite(pts.reshape(pts.shape[0], -1)).all(dim=1)
    return pts, valid


def velocity_trails_adaptive(positions, velocities, frame_index, k,
                             budget: int = 4, schedule: str = "ball"):
    """Each trail sampled at its own segment count: ``k`` (N,) int in
    1..budget (clipped) -> (pts (N, budget + 1, 3), vertex_valid (N,
    budget + 1)).

    Trail i's first k[i] + 1 vertices are the k[i]-segment sampled
    build's (:func:`sampled_ts_table`: the same float32 expressions at
    the same t, the position vertex exactly the position); the vertices
    past k[i] repeat the position and are invalid, so their capsules are
    dropped while the soup keeps budget capsules per trail."""
    p, direction, trail_length, valid = _trail_terms(
        positions, velocities, frame_index, schedule)
    dev = p.device
    ttab = const(sampled_ts_table(budget), np.float32, dev)
    k = torch.clamp(torch.as_tensor(k, device=dev).to(torch.int32), 1,
                    budget)
    tsel = ttab[(k - 1).long()]  # (N, budget + 1)
    offsets = direction[:, None, :] * (trail_length[:, None] * tsel)[..., None]
    pts = p[:, None, :] + offsets
    j = const(np.arange(budget + 1), np.int32, dev)[None, :]
    is_pos = j >= k[:, None]
    pts = torch.where(is_pos[..., None], p[:, None, :].expand_as(pts), pts)
    valid = valid & torch.isfinite(pts.reshape(pts.shape[0], -1)).all(dim=1)
    return pts, valid[:, None] & (j <= k[:, None])


def velocity_trail_vertex_columns(positions, velocities, frame_index,
                                  indices, schedule: str = "ball"):
    """``velocity_trails`` evaluated only at vertex ``indices``, as packed
    (N, 3) columns: ``cols[j]`` is vertex ``indices[j]`` (index 20 is the
    position itself) and ``valid`` the (N,) trail mask over the sampled
    vertices (non-finite values can only come from non-finite inputs,
    which poison every vertex, so this equals the full build's mask)."""
    p, direction, trail_length, valid = _trail_terms(
        positions, velocities, frame_index, schedule)
    ts_full = _ts_full()
    cols = []
    for j in np.asarray(indices, np.int64):
        if j >= N_TRAIL_POINTS:
            pt = p
        else:
            pt = p + direction * (trail_length * np.float32(ts_full[j]))[:, None]
        cols.append(pt)
        valid = valid & torch.isfinite(pt).all(dim=1)
    return cols, valid


# --------------------------------------------------------------------------
# Catmull-Rom history-fit trails (traj_renderer)
# --------------------------------------------------------------------------

def _catmull_rom(p0, p1, p2, p3, t):
    """Reference spline segment (traj_renderer.py:239-252); t in [0, 1]."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2 * p1)
                  + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


def _history_sample_plan(m: int):
    """Static sampling plan for m history points -> (segments, samples per
    segment, the 20 indices taken from the dense samples), as
    traj_renderer.py:266-311: samples_per_segment = max(2, 20 // (m-1));
    oversampled lists are decimated with linspace indices, undersampled
    ones repeat the last sample."""
    n_seg = m - 1
    sps = max(2, N_TRAIL_POINTS // n_seg)
    total = n_seg * sps
    if total > N_TRAIL_POINTS:
        sub = np.linspace(0, total - 1, N_TRAIL_POINTS).astype(int)
    else:
        sub = np.concatenate([
            np.arange(total),
            np.full(N_TRAIL_POINTS - total, total - 1, dtype=int),
        ])
    return n_seg, sps, sub


def _dist3(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis: the float32 square root of the sum of the
    three squares in order, as ``jnp.linalg.norm`` reduces them."""
    return sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                   + d[..., 2] * d[..., 2])


def catmull_rom_trails(history, positions):
    """History-fit trails of a whole cloud.

    ``history`` is (H, N, 3) positions of the last H frames (oldest to
    newest; the last HISTORY_WINDOW are used, particles matched by index
    as traj_renderer.py:546-552 does), ``positions`` (N, 3) the current
    positions, appended as the final vertex.  Returns points (N, 21, 3)
    float32, valid (N,) bool and keep (N, 21) bool: the per-vertex mask
    replaying the reference's finite filter, its sequential 1e-5 dedup
    against the last kept vertex and its open-curve trim (a last kept
    vertex within 1e-5 of the first is dropped; traj_renderer.py:340-375).
    """
    positions = torch.as_tensor(positions, dtype=torch.float32)
    dev = positions.device
    n = positions.shape[0]
    history = torch.as_tensor(history, dtype=torch.float32, device=dev)
    m = min(HISTORY_WINDOW, int(history.shape[0]))
    nv = N_TRAIL_POINTS + 1
    if m < 2:
        return (torch.zeros((n, nv, 3), dtype=torch.float32, device=dev),
                torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.zeros((n, nv), dtype=torch.bool, device=dev))
    hist = history[-m:]
    if m == 2:
        ts = np.arange(N_TRAIL_POINTS, dtype=np.float32) / (N_TRAIL_POINTS - 1)
        smooth = (as_f32((1 - ts)[None, :, None], dev) * hist[0][:, None, :]
                  + as_f32(ts[None, :, None], dev) * hist[1][:, None, :])
    else:
        n_seg, sps, sub = _history_sample_plan(m)
        ts = as_f32((np.arange(sps, dtype=np.float32) / (sps - 1))
                    [None, :, None], dev)
        chunks = []
        for seg in range(n_seg):
            if seg == 0:
                p0 = hist[0] - (hist[1] - hist[0])
                p1, p2, p3 = hist[0], hist[1], hist[min(2, m - 1)]
            elif seg == n_seg - 1:
                p0 = hist[max(seg - 1, 0)]
                p1, p2 = hist[seg], hist[seg + 1]
                p3 = hist[seg + 1] + (hist[seg + 1] - hist[seg])
            else:
                p0, p1, p2 = hist[seg - 1], hist[seg], hist[seg + 1]
                p3 = hist[min(seg + 2, m - 1)]
            chunks.append(_catmull_rom(p0[:, None, :], p1[:, None, :],
                                       p2[:, None, :], p3[:, None, :], ts))
        dense = torch.cat(chunks, dim=1)  # (N, n_seg * sps, 3)
        # The plan's indices through the constant cache: a per-frame upload
        # of a host array would wait for the stream.
        smooth = dense[:, const(sub, np.int64, dev)]
    pts = torch.cat([smooth, positions[:, None, :]], dim=1)  # (N, 21, 3)
    finite = torch.isfinite(pts).all(dim=2)

    # Sequential dedup over the 21 vertices: keep a vertex only if it is
    # > 1e-5 from the last KEPT one.
    last = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    any_kept = torch.zeros((n,), dtype=torch.bool, device=dev)
    keeps = []
    for j in range(nv):
        point = pts[:, j]
        keep = finite[:, j] & (~any_kept
                               | (_dist3(point - last) > TRAIL_DEDUP_EPS))
        last = torch.where(keep[:, None], point, last)
        any_kept = any_kept | keep
        keeps.append(keep)
    keep = torch.stack(keeps, dim=1)

    # Open-curve trim: first and last kept vertices within 1e-5 drop the
    # last kept one.
    idx = torch.arange(nv, device=dev)[None, :]
    first_idx = torch.where(keep, idx, nv + 1).amin(dim=1)
    last_idx = torch.where(keep, idx, -1).amax(dim=1)
    rows = torch.arange(n, device=dev)
    first_pt = pts[rows, torch.clamp(first_idx, 0, N_TRAIL_POINTS)]
    last_pt = pts[rows, torch.clamp(last_idx, 0, N_TRAIL_POINTS)]
    closed = _dist3(first_pt - last_pt) < TRAIL_DEDUP_EPS
    drop_last = closed & (keep.sum(dim=1) >= 2)
    keep = keep & ~(drop_last[:, None] & (idx == last_idx[:, None]))
    valid = keep.sum(dim=1) >= 2
    return pts, valid, keep
