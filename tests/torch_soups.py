"""Seeded inputs shared by the port's tests (``tests/test_torch_*.py``):
small primitive soups on a film with partial edge tiles, and a
(positions, velocities) cloud for the traj_ball preset.  Holds no tests
and imports no jax, so the card-only tests can use it on a machine that
has none.
"""

import types

import numpy as np
import torch

from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    capsules_from_vertex_columns,
    discs_from_points,
    triangles_from_mesh,
)
from pointcloud_render_tpu_torch.raster.render import ground_plane
from pointcloud_render_tpu_torch.scene.camera import Camera
from pointcloud_render_tpu_torch.utils import convert

W, H = 150, 90  # not multiples of 32: partial edge tiles on both axes
ORIGIN = (2.0, 2.0, 2.0)
TARGET = (0.0, 0.0, -0.05)


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


def _near_clip_soup(cam):
    """Triangles crossing the near plane (1 or 2 vertices behind it) plus
    a few discs."""
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


CASES = ["mixed", "spill", "ties", "wide_big", "invalid", "near_clip",
         "dense_tile"]


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


def cloud(n=300, seed=0):
    """A seeded (positions, velocities) cloud for the traj_ball preset."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 3, (n, 3)).astype(np.float32)
    vel[4] = 0.0  # below the velocity epsilon: no trail
    return pos, vel
