"""Seeded inputs shared by the port's tests (``tests/test_torch_*.py``):
small primitive soups on a film with partial edge tiles, and a
(positions, velocities) cloud for the traj_ball preset.  Holds no tests
and imports no jax, so the card-only tests can use it on a machine that
has none.
"""

import types

import numpy as np
import torch

from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import trails
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    capsules_from_polylines,
    capsules_from_vertex_columns,
    discs_from_points,
    triangles_from_mesh,
)
from pointcloud_render_tpu_torch.raster.render import ground_plane
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.scene.camera import Camera
from pointcloud_render_tpu_torch.utils import convert

W, H = 150, 90  # not multiples of 32: partial edge tiles on both axes
ORIGIN = (2.0, 2.0, 2.0)
TARGET = (0.0, 0.0, -0.05)


TRAIL_COLOR = (0.2, 1.0, 0.4)

NEAR_ORIGIN = (1.2, 1.2, 1.0)  # long capsules span 2-4 tiles
# 10x8 tiles: from NEAR_ORIGIN some long capsules of droplet_soup reach 5-8
# tiles, binned only at span 8.
SPAN8_FILM = (320, 256)


def tcam(w=W, h=H, device=None, origin=ORIGIN):
    return Camera(origin=torch.tensor(origin, device=device),
                  target=torch.tensor(TARGET, device=device), width=w,
                  height=h)


def _discs(cam, pos, radius, color=(0.3, 0.3, 0.3)):
    n = pos.shape[0]
    return discs_from_points(torch.tensor(pos), cam,
                             torch.full((n,), radius), np.asarray(color))


def pad_invalid(soup, n):
    """``soup`` followed by invalid all-zero rows up to ``n`` rows: the
    JAX reference evaluated op by op compiles each op per input shape, so
    cases padded to one row count share those compiles."""
    m = n - soup.count
    dev = soup.device
    pad = ScreenPrimitives(
        kind=torch.zeros(m, dtype=torch.int32, device=dev),
        params=torch.zeros((m, soup.params.shape[1]), device=dev),
        color=torch.zeros((m, 3), device=dev),
        valid=torch.zeros(m, dtype=torch.bool, device=dev),
        bbox=torch.zeros((m, 4), device=dev),
        normal=torch.zeros((m, 3), device=dev))
    return ScreenPrimitives.concatenate([soup, pad])


def mixed_soup(cam, n, trails, seed, radius=0.025):
    """Ground + discs + 4-segment random polylines (capsules)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pts = rng.uniform(-0.4, 0.4, (trails, 5, 3)).astype(np.float32)
    ones = torch.ones(trails, dtype=torch.bool)
    caps = capsules_from_vertex_columns(
        [torch.tensor(pts[:, j]) for j in range(5)], [ones] * 5, cam,
        0.003, np.array([0.2, 1.0, 0.4], np.float32))
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), _discs(cam, pos, radius),
         caps])


def _near_clip_tris(cam):
    """Three wide triangles crossing the near plane (1 or 2 vertices
    behind it): split rows, invalid rows and big-list rows."""
    eye = np.array(ORIGIN, np.float32)
    fwd = np.array(TARGET, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    side = np.cross(fwd, [0.0, 0.0, 1.0]).astype(np.float32)
    side /= np.linalg.norm(side)
    up = np.cross(side, fwd).astype(np.float32)
    verts, faces = [], []
    for k, (a, b) in enumerate(((0.05, 0.6), (-0.05, 0.9), (0.3, 0.5))):
        base = len(verts)
        verts += [eye + fwd * a + side * 0.3, eye + fwd * b - side * 0.2,
                  eye + fwd * b + up * 0.25 + side * 0.1 * k]
        faces.append([base, base + 1, base + 2])
    tris = triangles_from_mesh(np.asarray(verts, np.float32),
                               np.asarray(faces), cam,
                               np.array([0.9, 0.4, 0.1], np.float32))
    assert bool((~tris.valid[3:]).any()) and bool(tris.valid.any())
    return tris


def _near_clip_soup(cam):
    """Triangles crossing the near plane plus a few discs."""
    tris = _near_clip_tris(cam)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.4, 0.4, (80, 3)).astype(np.float32)
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), tris, _discs(cam, pos, 0.02)])


def _screen_discs(px, py, z, r):
    """Discs placed directly in screen space (no camera)."""
    n = len(px)
    params = np.zeros((n, 12), np.float32)
    params[:, 0], params[:, 1], params[:, 2], params[:, 3] = px, py, z, r
    p = params
    bbox = np.stack([p[:, 0] - p[:, 3], p[:, 0] + p[:, 3],
                     p[:, 1] - p[:, 3], p[:, 1] + p[:, 3]], axis=1)
    return convert.soup_from_fields(types.SimpleNamespace(
        kind=np.zeros(n, np.int32), params=params,
        color=np.full((n, 3), 0.3, np.float32), valid=np.ones(n, bool),
        bbox=bbox, normal=np.zeros((n, 3), np.float32)))


def make_soup(case):
    cam = tcam()
    if case == "mixed":
        return mixed_soup(cam, n=300, trails=30, seed=7)
    if case == "spill":  # ~2-tile radii: every class and range live
        return mixed_soup(cam, n=200, trails=20, seed=11, radius=0.08)
    if case == "ties":
        rng = np.random.default_rng(3)
        pos = rng.uniform(-0.5, 0.5, (240, 3)).astype(np.float32)
        pos[40:80] = pos[:40]  # duplicated discs -> exact depth ties
        discs = _discs(cam, pos, 0.03)
        return ScreenPrimitives.concatenate(
            [ground_plane(cam, 10.0, (0, 0, -0.5)), discs, discs])
    if case == "wide_big":  # wide discs ride the big list
        rng = np.random.default_rng(9)
        pos = rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32)
        return ScreenPrimitives.concatenate(
            [_discs(cam, pos, 0.5, (0.8, 0.2, 0.2)),
             mixed_soup(cam, n=60, trails=10, seed=2)])
    if case == "invalid":  # invalid rows, some with non-finite params
        soup = convert.soup_to_numpy(mixed_soup(cam, n=250, trails=25, seed=19))
        rng = np.random.default_rng(19)
        drop = rng.random(soup["valid"].shape[0]) < 0.25
        soup["valid"][drop] = False
        soup["params"][np.flatnonzero(drop)[::3], 2] = np.nan
        return convert.soup_from_fields(types.SimpleNamespace(**soup))
    if case == "near_clip":
        return _near_clip_soup(cam)
    if case == "dense_tile":  # hundreds of prims on a few tiles
        rng = np.random.default_rng(4)
        n = 600
        px = rng.uniform(40, 70, n)
        py = rng.uniform(30, 60, n)
        z = np.round(rng.uniform(1.0, 3.0, n), 1)  # many exact ties
        return _screen_discs(px, py, z, rng.uniform(0.5, 6.0, n))
    raise ValueError(case)


def disc_soup(cam, ties=40, wide=2, n=300, radius=0.03, ground=True):
    """A two-tone disc scene: gray discs with ``ties`` exact depth ties,
    ``wide`` wide gray discs that ride the big list, and the white ground."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[ties:2 * ties] = pos[:ties]
    parts = [ground_plane(cam, 10.0, (0, 0, -0.5))] if ground else []
    if wide:
        parts.append(_discs(cam, pos[:wide] * 0.2, 0.4))
    parts.append(_discs(cam, pos, radius))
    return ScreenPrimitives.concatenate(parts)


def band_soup(seed=23, n=90):
    """Screen-space discs on the W x H film against the disc walks' cull
    by bands of 4 pixel rows (tile rows 4b .. 4b + 3): ``n`` discs tangent
    to the nearest pixel centre of the band beyond a band boundary (r * r
    == fl(dy * dy) there, on a pixel column where dx = 0: covered at
    equality), ``n`` whose radius is one float below that, ``n`` centred
    on band boundaries, and discs over the ragged bottom tile row (rows
    64-89: its band 6 is cut at row 89, band 7 lies below the image), each
    three times at the same depth (exact ties, split across work items),
    over the white ground and one wide disc on the big list."""
    rng = np.random.default_rng(seed)
    px = (rng.integers(4, W - 4, n) + 0.5).astype(np.float32)
    edge = (rng.integers(1, H // 4, n) * 4).astype(np.float32)
    off = rng.uniform(0.05, 3.45, n).astype(np.float32)
    above = rng.random(n) < 0.5
    # A disc above the boundary reaches the centre edge + 0.5 below it; one
    # below it (past the band [edge - 4, edge - 1]) reaches edge - 0.5.
    py = np.where(above, edge - off, edge + off).astype(np.float32)
    near = np.where(above, edge + np.float32(0.5), edge - np.float32(0.5))
    tangent = np.abs(near.astype(np.float32) - py).astype(np.float32)
    inside = np.nextafter(tangent, np.float32(0))
    centred = rng.uniform(0.4, 3.0, n).astype(np.float32)
    bottom_y = rng.uniform(80.0, 92.0, n // 3).astype(np.float32)
    bottom_x = rng.uniform(0.0, W, n // 3).astype(np.float32)
    cols = [np.concatenate(c) for c in zip(
        (px, py, tangent), (px, py, inside), (px, edge, centred),
        (bottom_x, bottom_y, rng.uniform(0.5, 3.0, n // 3)))]
    z = np.round(rng.uniform(1.0, 3.0, cols[0].shape[0]), 1)
    discs = _screen_discs(cols[0], cols[1], z, cols[2])
    wide = _screen_discs([70.0], [40.0], [2.0], [60.0])
    cam = tcam()
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), wide, discs, discs, discs])


def segment_soup(seed=29, n=60):
    """Screen-space discs on the W x H film against csr2_disc8's cull by
    warp blocks of 32 columns (columns 32 j .. 32 j + 31 of an 8 x 128
    strip): ``n`` discs tangent to the nearest pixel centre beyond a
    32-column boundary (r * r == fl(dx * dx) there, on a pixel row where
    dy = 0: covered at equality), ``n`` whose radius is one float below
    that, ``n`` centred on column boundaries, and discs over the ragged
    right strip (columns 128-149), each three times at the same depth
    (exact ties, split across work items), over the white ground and one
    wide disc on the big list."""
    rng = np.random.default_rng(seed)
    py = (rng.integers(4, H - 4, n) + 0.5).astype(np.float32)
    edge = (rng.integers(1, (W - 1) // 32 + 1, n) * 32).astype(np.float32)
    off = rng.uniform(0.05, 3.45, n).astype(np.float32)
    left = rng.random(n) < 0.5
    # A disc left of the boundary reaches the centre edge + 0.5 right of
    # it; one right of it reaches edge - 0.5.
    px = np.where(left, edge - off, edge + off).astype(np.float32)
    near = np.where(left, edge + np.float32(0.5), edge - np.float32(0.5))
    tangent = np.abs(near.astype(np.float32) - px).astype(np.float32)
    inside = np.nextafter(tangent, np.float32(0))
    centred = rng.uniform(0.4, 3.0, n).astype(np.float32)
    right_x = rng.uniform(124.0, 152.0, n // 3).astype(np.float32)
    right_y = rng.uniform(0.0, H, n // 3).astype(np.float32)
    cols = [np.concatenate(c) for c in zip(
        (px, py, tangent), (px, py, inside), (edge, py, centred),
        (right_x, right_y, rng.uniform(0.5, 3.0, n // 3)))]
    z = np.round(rng.uniform(1.0, 3.0, cols[0].shape[0]), 1)
    discs = _screen_discs(cols[0], cols[1], z, cols[2])
    wide = _screen_discs([70.0], [40.0], [2.0], [60.0])
    cam = tcam()
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), wide, discs, discs, discs])


def block_soup(seed=37, n=40, col=16, row=4):
    """Screen-space discs on the W x H film against the v5 kernels' cull
    by warp blocks (32 columns x 4 rows of a tile, 16 columns x 8 rows
    where the tile is 16 wide): ``n`` discs tangent to the nearest pixel
    centre beyond a multiple of ``col`` columns (r * r == fl(dx * dx)
    there, on a pixel row where dy = 0: covered at equality), ``n`` whose
    radius is one float below that, ``n`` centred on such boundaries; the
    same across multiples of ``row`` pixel rows; ``n`` discs over the
    ragged right and bottom tiles; each three times at the same depth
    (exact ties), over the white ground and one wide disc on the big
    list."""
    rng = np.random.default_rng(seed)
    cols = []
    for axis, step, extent, other in ((0, col, W, H), (1, row, H, W)):
        across = (rng.integers(4, other - 4, n) + 0.5).astype(np.float32)
        edge = (rng.integers(1, (extent - 1) // step + 1, n)
                * step).astype(np.float32)
        off = rng.uniform(0.05, 3.45, n).astype(np.float32)
        before = rng.random(n) < 0.5
        # A disc before the boundary reaches the centre edge + 0.5 past it;
        # one past it reaches edge - 0.5.
        along = np.where(before, edge - off, edge + off).astype(np.float32)
        near = np.where(before, edge + np.float32(0.5),
                        edge - np.float32(0.5))
        tangent = np.abs(near.astype(np.float32) - along).astype(np.float32)
        for a, r in ((along, tangent),
                     (along, np.nextafter(tangent, np.float32(0))),
                     (edge, rng.uniform(0.4, 3.0, n).astype(np.float32))):
            cols.append((a, across, r) if axis == 0 else (across, a, r))
    cols.append((rng.uniform(W - 30.0, W + 2.0, n).astype(np.float32),
                 rng.uniform(H - 30.0, H + 2.0, n).astype(np.float32),
                 rng.uniform(0.5, 3.0, n).astype(np.float32)))
    px, py, r = (np.concatenate(c) for c in zip(*cols))
    z = np.round(rng.uniform(1.0, 3.0, px.shape[0]), 1)
    discs = _screen_discs(px, py, z, r)
    wide = _screen_discs([70.0], [40.0], [2.0], [60.0])
    cam = tcam()
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), wide, discs, discs, discs])


def tie_tile_soup(copies=48):
    """Screen-space discs in tile (1, 1) of the W x H film for the v3
    walk's split: ``copies`` identical discs (the same centre, radius and
    depth: an exact tie, its entries cut across many work items), a
    cover of the whole tile in front of the deep discs (so the exit can
    leave the run) and deep discs behind it, over no ground."""
    rng = np.random.default_rng(41)
    k = 40
    px = np.concatenate([np.full(copies, 40.5), rng.uniform(33, 63, k),
                         [48.0]]).astype(np.float32)
    py = np.concatenate([np.full(copies, 41.5), rng.uniform(33, 63, k),
                         [48.0]]).astype(np.float32)
    z = np.concatenate([np.full(copies, 0.5), rng.uniform(3.0, 4.0, k),
                        [2.0]]).astype(np.float32)
    r = np.concatenate([np.full(copies, 3.0), np.full(k, 2.0),
                        [23.0]]).astype(np.float32)
    return _screen_discs(px, py, z, r)


CASES = ["mixed", "spill", "ties", "wide_big", "invalid", "near_clip",
         "dense_tile"]

# The film of the JAX package's test_exit_does_not_skip_cross_class_prims
# (tests/test_raster.py's W, H).
CROSS_FILM = (256, 160)


def cross_class_soup(seed=0, n_far=300):
    """The cross-class case of the JAX package's
    ``test_exit_does_not_skip_cross_class_prims`` on CROSS_FILM: a wide
    disc at depth 1 on the big list, ``n_far`` far discs (depth 5-6, more
    than one 256-row chunk) anchored in tile (2, 2) without spill, and one
    near disc (depth 0.5) anchored there too that spills into tile (3, 2).
    An early exit inside the anchor's merged range would leave it on the
    far discs' bucket and skip the near disc."""
    rng = np.random.default_rng(seed)
    mid = _screen_discs([128.0], [80.0], [1.0], [400.0])
    far = _screen_discs(rng.uniform(68, 92, n_far), rng.uniform(68, 92, n_far),
                        rng.uniform(5.0, 6.0, n_far), np.full(n_far, 2.0))
    near = _screen_discs([95.5], [80.0], [0.5], [2.0])
    return ScreenPrimitives.concatenate([mid, far, near])


def _screen_capsules(x0, y0, z0, r0, sdx, sdy, sdz, sdr):
    """Capsules placed directly in screen space (no camera)."""
    n = len(x0)
    params = np.zeros((n, 12), np.float32)
    for k, col in enumerate((x0, y0, z0, r0, sdx, sdy, sdz, sdr)):
        params[:, k] = col
    p = params
    params[:, 8] = np.float32(1.0) / (p[:, 4] * p[:, 4] + p[:, 5] * p[:, 5])
    x1, y1, r1 = p[:, 0] + p[:, 4], p[:, 1] + p[:, 5], p[:, 3] + p[:, 7]
    bbox = np.stack([np.minimum(p[:, 0] - p[:, 3], x1 - r1),
                     np.maximum(p[:, 0] + p[:, 3], x1 + r1),
                     np.minimum(p[:, 1] - p[:, 3], y1 - r1),
                     np.maximum(p[:, 1] + p[:, 3], y1 + r1)], axis=1)
    return convert.soup_from_fields(types.SimpleNamespace(
        kind=np.ones(n, np.int32), params=params,
        color=np.full((n, 3), 0.5, np.float32), valid=np.ones(n, bool),
        bbox=bbox, normal=np.zeros((n, 3), np.float32)))


def split_soup(n=6000, seed=31):
    """Thousands of short capsules over the corner of four tiles of the
    150x90 film (every spill class, each tile's range far past one work
    item of 2048 rows), a wide disc at a middle depth on the big list, and
    a copy of every tenth capsule (exact depth ties between ids)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0.0, 2.0 * np.pi, n)
    length = rng.uniform(1.0, 6.0, n)
    cols = (rng.uniform(22, 42, n), rng.uniform(22, 42, n),
            np.round(rng.uniform(1.0, 6.0, n), 2), rng.uniform(0.6, 2.0, n),
            length * np.cos(ang), length * np.sin(ang),
            rng.uniform(-0.5, 0.5, n), rng.uniform(-0.3, 0.3, n))
    caps = _screen_capsules(*(np.asarray(c, np.float32) for c in cols))
    dup = _screen_capsules(*(np.asarray(c[::10], np.float32) for c in cols))
    wide = _screen_discs([40.0], [30.0], [3.5], [120.0])
    return ScreenPrimitives.concatenate([wide, caps, dup])


def droplet_soup(cam, n=160, seed=13, frame=120, long_caps=12):
    """A traj_vel soup (ground, head discs, tapered tail capsules, 2-segment
    velocity trails) at ``cam`` with exact depth ties (40 droplets twice),
    invalid rows (every 7th) and ``long_caps`` long straight trail
    capsules after the trails: seen from ``tcam(origin=NEAR_ORIGIN)``
    they span 2 to 4 tiles, so some ride the big list at span 2 and are
    binned at span 4."""
    from pointcloud_render_tpu_torch.configs import PRESETS  # noqa: PLC0415
    from pointcloud_render_tpu_torch.run import pipeline  # noqa: PLC0415

    pos, vel = cloud(n, seed)
    pos[40:80], vel[40:80] = pos[:40], vel[:40]
    preset = PRESETS["traj_vel"]
    soup = pipeline.build_primitives(
        preset, cam, torch.tensor(pos, device=cam.device),
        torch.tensor(vel, device=cam.device), frame, trail_segments=2)
    rng = np.random.default_rng(seed + 1)
    a = rng.uniform(-0.4, 0.4, (long_caps, 3)).astype(np.float32)
    b = (a + rng.uniform(-0.7, 0.7, (long_caps, 3))).astype(np.float32)
    ones = torch.ones(long_caps, dtype=torch.bool, device=cam.device)
    caps = capsules_from_vertex_columns(
        [torch.tensor(a, device=cam.device),
         torch.tensor(b, device=cam.device)], [ones, ones], cam,
        preset.trail_radius, np.asarray(preset.trail_color, np.float32))
    soup = ScreenPrimitives.concatenate([soup, caps])
    valid = soup.valid.clone()
    valid[::7] = False
    return ScreenPrimitives(kind=soup.kind, params=soup.params,
                            color=soup.color, valid=valid, bbox=soup.bbox,
                            normal=soup.normal)


def mesh_soup(cam, n=12, seed=17, scale=4.0, ties=3, near=2, discs=60):
    """A mesh-LOD droplet soup at ``cam``: the ground, ``n`` instanced
    teardrop meshes at seeded positions and velocity orientations, scaled
    ``scale`` times about their centres (a triangle spans a few pixels at
    150x90), the first ``ties`` after the near ones instanced twice (exact
    depth ties between ids), ``near`` unscaled droplets close to the eye
    whose near clip splits triangles and leaves invalid rows, three wide
    triangles across the near plane (big-list rows), and ``discs`` gray
    discs."""
    from pointcloud_render_tpu_torch.geometry import droplet  # noqa: PLC0415
    from pointcloud_render_tpu_torch.geometry import (  # noqa: PLC0415
        rotation,
    )

    dev = cam.device
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.35, 0.35, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 2, (n, 3)).astype(np.float32)
    eye = np.array(ORIGIN, np.float32)
    fwd = np.array(TARGET, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    side = np.cross(fwd, [0.0, 0.0, 1.0]).astype(np.float32)
    for k, dist in enumerate((0.104, 0.11)[:near]):
        pos[k] = eye + fwd * dist + side * (0.02 - 0.04 * k)
    pos = np.concatenate([pos, pos[near:near + ties]])
    vel = np.concatenate([vel, vel[near:near + ties]])
    m = pos.shape[0]
    rot = rotation.rotation_matrices_from_velocities(
        torch.tensor(vel, device=dev), torch.tensor(pos, device=dev))
    verts, faces = droplet.instance_droplets(rot)
    centre = torch.tensor(pos, device=dev)[:, None, :]
    factor = torch.full((m, 1, 1), scale, device=dev)
    factor[:near] = 1.0
    verts = ((verts.reshape(m, -1, 3) - centre) * factor + centre).reshape(
        -1, 3)
    tris = triangles_from_mesh(verts, faces, cam,
                               np.array([0.3, 0.3, 0.8], np.float32))
    parts = [ground_plane(cam, 10.0, (0, 0, -0.5)), tris,
             _near_clip_tris(cam)]
    if discs:
        parts.append(_discs(cam, rng.uniform(-0.4, 0.4, (discs, 3)).astype(
            np.float32), 0.02))
    return ScreenPrimitives.concatenate(parts)


def cloud(n=300, seed=0):
    """A seeded (positions, velocities) cloud for the traj_ball preset."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 3, (n, 3)).astype(np.float32)
    vel[4] = 0.0  # below the velocity epsilon: no trail
    return pos, vel


# The adaptive trail scene: from this close camera the trails of
# adaptive_cloud() span up to several tiles of the W x H film, so every
# adaptive segment count (1..4) occurs.
ADAPTIVE_ORIGIN = (0.6, 0.6, 0.5)


def adaptive_cloud(n=200, seed=3):
    """A seeded (positions, velocities) cloud for the adaptive trails:
    positions uniform in [-0.4, 0.4)^3, velocities normal(0, 10)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 10, (n, 3)).astype(np.float32)
    return pos, vel


def adaptive_soup(preset="traj_ball", frame=120, segments="adaptive",
                  device=None):
    """(soup, layout, camera) of ``adaptive_cloud()`` through
    ``build_primitives(..., trail_segments=segments)`` from
    ADAPTIVE_ORIGIN at W x H."""
    cam = tcam(device=device, origin=ADAPTIVE_ORIGIN)
    pos, vel = adaptive_cloud()
    soup, layout = pipeline.build_primitives(
        PRESETS[preset], cam, torch.tensor(pos, device=device),
        torch.tensor(vel, device=device), frame, trail_segments=segments,
        return_layout=True)
    return soup, layout, cam


def wide_disc_soup():
    """On the 10x8-tile SPAN8_FILM: the ground, discs and capsules of
    ``mixed_soup``, and screen-space discs of radii 0.5-125 px at 40
    depths (exact ties), a fifth of them wide enough to cover 5-8 tiles:
    binned only at span 8 (the discs_only walks at spans 4 and 8)."""
    w, h = SPAN8_FILM
    rng = np.random.default_rng(21)
    n = 150
    r = np.concatenate([rng.uniform(0.5, 12.0, n - 30),
                        rng.uniform(40.0, 125.0, 30)])
    discs = _screen_discs(rng.uniform(-20, w + 20, n),
                          rng.uniform(-20, h + 20, n),
                          np.round(rng.uniform(1.0, 5.0, n), 1), r)
    return ScreenPrimitives.concatenate(
        [mixed_soup(tcam(w, h), n=100, trails=10, seed=5, radius=0.05),
         discs])


def _v5_cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)


def cross_chunk_ties(soup, pairs, k=16):
    """``soup`` with ``pairs`` exact depth ties between overlapping discs of
    different ``k``-prim chunks: disc j (0.5-2 px from an earlier disc i,
    the two in different chunks, each in at most one pair) takes i's
    depth, so the tie is decided by the ids across two superrows."""
    p = soup.params.cpu().numpy()
    disc = np.flatnonzero(soup.kind.cpu().numpy() == 0)
    xy = p[disc, :2]
    dist = np.linalg.norm(xy[:, None] - xy[None], axis=-1)
    used = np.zeros(soup.count, bool)
    params = p.copy()
    found = 0
    for a, i in enumerate(disc):
        for b in np.flatnonzero((dist[a] > 0.5) & (dist[a] < 2.0)):
            j = disc[b]
            if j > i and i // k != j // k and not used[i] and not used[j]:
                params[j, 2] = params[i, 2]
                used[i] = used[j] = True
                found += 1
                break
        if found == pairs:
            break
    assert found == pairs, found
    return ScreenPrimitives(**{**{f: getattr(soup, f) for f in (
        "kind", "color", "valid", "bbox", "normal")},
        "params": torch.tensor(params, device=soup.device)})


def v5_soups(device=None):
    """The v5 slice's soups at ``tcam()``: "sorted" (the ground and 600
    Morton-sorted discs with 60 cross-chunk exact depth ties),
    "unsorted" (200 discs in random order, whose chunks span the film,
    and three wide discs) and "mixed" (300 Morton-sorted discs, 4-segment
    capsule polylines and triangles across the near plane)."""
    from pointcloud_render_tpu_torch.scene import spatial  # noqa: PLC0415

    cam = tcam(device=device)
    ground = ground_plane(cam, 10.0, (0, 0, -0.5))

    def discs(pos, radius=0.02):
        return discs_from_points(
            torch.tensor(pos, device=device), cam,
            torch.full((pos.shape[0],), radius, device=device),
            np.array([0.3, 0.3, 0.3], np.float32))

    rng = np.random.default_rng(8)
    pts = rng.uniform(-0.4, 0.4, (25, 5, 3)).astype(np.float32)
    ones = torch.ones(25, dtype=torch.bool, device=device)
    caps = capsules_from_vertex_columns(
        [torch.tensor(pts[:, j], device=device) for j in range(5)],
        [ones] * 5, cam, 0.003, np.array([0.2, 1.0, 0.4], np.float32))
    return {
        "sorted": cross_chunk_ties(ScreenPrimitives.concatenate([
            ground, discs(spatial.spatial_sort(_v5_cloud(600, 3))[0])]), 60),
        "unsorted": ScreenPrimitives.concatenate(
            [ground, discs(_v5_cloud(200, 11)),
             discs(_v5_cloud(3, 5) * 0.2, 0.4)]),
        "mixed": ScreenPrimitives.concatenate(
            [ground, discs(spatial.spatial_sort(_v5_cloud(300, 4))[0]),
             caps, _near_clip_tris(cam)]),
    }


def morton_soup(soup):
    """``soup`` with its rows in the Morton order of their screen bbox
    centres and depths (what ``spatial_sort`` gives a cloud)."""
    from pointcloud_render_tpu_torch.scene import spatial  # noqa: PLC0415

    key = torch.stack([(soup.bbox[:, 0] + soup.bbox[:, 1]) * 0.5,
                       (soup.bbox[:, 2] + soup.bbox[:, 3]) * 0.5,
                       soup.params[:, 2]], dim=1)
    order = torch.as_tensor(spatial.spatial_order(key), device=soup.device)
    return ScreenPrimitives(**{f: getattr(soup, f)[order] for f in (
        "kind", "params", "color", "valid", "bbox", "normal")})


def trail_soup_fn(cam, radius, segments=4, trail_radius=0.0007):
    """``benchmarks/stream_10m.py``'s streamed trail soup as a
    ``StreamingRasterizer`` soup_fn: (positions, colors, velocities) ->
    (discs of ``radius`` and ``segments``-capsule velocity trails
    through ``trails.velocity_trails_sampled`` at frame 120 under the
    "ball" schedule, layout)."""
    sub = np.round(np.linspace(0, trails.N_TRAIL_POINTS,
                               segments + 1)).astype(np.int32)

    def trail_soup(pos, colors, vel):
        n = pos.shape[0]
        discs = discs_from_points(pos, cam, torch.full(
            (n,), radius, device=pos.device), colors)
        ends, valid = trails.velocity_trails_sampled(pos, vel, 120, sub,
                                                     "ball")
        caps = capsules_from_polylines(
            ends, valid[:, None].expand(ends.shape[:2]), cam, trail_radius,
            np.asarray(TRAIL_COLOR, np.float32))
        return ScreenPrimitives.concatenate([discs, caps]), [
            (n, 1), (caps.count, segments)]
    return trail_soup
