"""Fidelity bounds for the geometry-changing tuned knobs: the port's
counterpart of ``pointcloud_render_tpu.utils.fidelity``.

Two knobs of ``tuned_defaults.json`` change what is drawn, not only how
fast: trail ``segments`` (a velocity trail as fewer, longer capsules than
the reference's 20-segment polyline) and ``rows9`` (binned capsules
through the renormalized segment-frame evaluation of the kind-split
walk).  This module measures the shift they cause as a winner-flip rate,
so that a knob is certified before a lane runs it.  A "flip" is a pixel
whose winning SURFACE changed (empty, ground, or (part, owning point))
between the candidate and the reference polyline; same-surface sub-pixel
depth shifts are not flips.

Every render goes through the port: ``run/pipeline.build_primitives``
(``return_layout=True``) on the port's camera, then
``csr6.rasterize_csr6`` on the soup's device.  The exact renders take the
default v6 walk (the ``csr6_raster`` kernel on the card, its plain walk
on the CPU).  ``capsule_eval="cap8"`` renders the candidate through the
rows9 walk at ``span=capsule_span`` (``csr6_rows9`` on the card): the
port's twin of the JAX function's ``cpu_reference`` ``cap8`` oracle.  A
big list that overflows is re-rendered at the size it needs, so every
render is exact for its mode.

The certificate's rule is ``benchmarks/pick_tuned.py``'s
(``certify_geometry``): a knob's ``trail_rate`` must be at most
``max(FLIP_BOUND, rate(DEFAULT_SEGMENTS) + FLIP_MARGIN)`` on its preset
(:func:`flip_limit`).
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.run.pipeline import build_primitives
from pointcloud_render_tpu_torch.scene.camera import (
    TARGETS,
    TOTAL_FRAMES,
    Camera,
    camera_origin_torch,
)

# pick_tuned.py's rule: the absolute bound on trail_rate, and the
# marginal allowance over the production default segment count (8, the
# port's run/pipeline.VEL_TRAIL_RENDER_SEGMENTS as the JAX package's).
FLIP_BOUND = 0.005
FLIP_MARGIN = 2e-3
DEFAULT_SEGMENTS = 8
CAPSULE_EVALS = ("cap10", "cap8")


def flip_limit(default_rate: float, bound: float = FLIP_BOUND) -> float:
    """The largest ``trail_rate`` a geometry knob may have on a preset
    whose rate at DEFAULT_SEGMENTS is ``default_rate``: the absolute
    bound, relaxed to a marginal allowance where the preset's baseline
    already exceeds it (pick_tuned.certify_geometry)."""
    return max(bound, default_rate + FLIP_MARGIN)


def owner_map(layout, n_prims: int) -> np.ndarray:
    """(kind, owner) code per prim id from a build_primitives layout.

    Codes: furniture part k -> -(k + 1); per-point parts -> part_index *
    2**32 + point_index.  Codes are comparable across renders with
    different trail segment counts because part order is fixed (ground,
    splats, trails) and owners are row-major in point index.  A
    ``("split2", faces_per_point)`` count (the mesh LOD's) takes its
    faces per point.
    """
    codes = np.empty(n_prims, np.int64)
    row = 0
    for k, (rows, c) in enumerate(layout):
        if isinstance(c, tuple):  # ("split2", faces_per_point) mesh LOD
            c = c[1]
        if c == 0:
            codes[row:row + rows] = -(k + 1)
        else:
            codes[row:row + rows] = (np.int64(k) << 32) + (
                np.arange(rows, dtype=np.int64) // c)
        row += rows
    if row != n_prims:
        raise ValueError(f"layout covers {row} of {n_prims} prims")
    return codes


def surface_image(index_img: np.ndarray, layout) -> np.ndarray:
    """Map a winner-index image to a surface-code image (-1 = empty)."""
    n_prims = sum(rows for rows, _ in layout)
    codes = owner_map(layout, n_prims)
    out = np.full(index_img.shape, np.int64(-1))
    hit = index_img >= 0
    if codes.size:
        out[hit] = codes[index_img[hit]]
    return out


def part_image(index_img: np.ndarray, layout) -> np.ndarray:
    """Map a winner-index image to a part-index image (-1 = empty): unlike
    :func:`surface_image`'s codes, furniture part 0 and empty stay
    distinct.  The flip decomposition attributes a flipped pixel to the
    pair of winning parts it moved between."""
    bounds = np.cumsum([0] + [rows for rows, _ in layout])
    out = np.full(index_img.shape, -1, np.int32)
    hit = index_img >= 0
    out[hit] = (np.searchsorted(bounds, index_img[hit], side="right")
                .astype(np.int32) - 1)
    return out


def _scene(n_points: int, seed: int, device):
    """The JAX function's cloud: positions uniform in [-0.5, 0.5)^3 and
    velocities normal(0, 2) from ``default_rng(seed)``, as float32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n_points, 3)).astype(np.float32)
    vel = rng.normal(0, 2, (n_points, 3)).astype(np.float32)
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(vel, device=device))


def _camera(preset, frame_index: int, width: int, height: int, device):
    """The JAX function's camera: the preset's origin schedule over
    TOTAL_FRAMES, the default field of view."""
    return Camera(
        origin=camera_origin_torch(preset.camera_preset, frame_index,
                                   TOTAL_FRAMES, device=device),
        target=torch.as_tensor(np.asarray(TARGETS[preset.camera_preset],
                                          np.float32), device=device),
        width=width, height=height)


def _index(soup, width: int, height: int, rows9: bool = False,
           span: int = csr6.SPAN) -> np.ndarray:
    """The winner-index image of ``soup`` on its device: the exact default
    v6 walk, or with ``rows9`` the kind-split walk at ``span``; a big list
    past its capacity is rendered again at the size it needs."""
    max_big = csr6.DEFAULT_MAX_BIG
    while True:
        _, index, diag = csr6.rasterize_csr6(soup, width, height,
                                             max_big=max_big, rows9=rows9,
                                             span=span)
        over = int(diag["big_overflow"])
        if over == 0:
            return index.cpu().numpy()
        max_big += over


def _render(preset, cam, pos, vel, frame_index, segments, **kw):
    """(index image, layout) of the preset's trail scene at ``segments``."""
    soup, layout = build_primitives(preset, cam, pos, vel, frame_index,
                                    trail_segments=segments,
                                    return_layout=True)
    return _index(soup, cam.width, cam.height, **kw), layout


def trail_flip_decomposition(segments, n_points: int = 1500,
                             frames=(60, 120, 199), width: int = 480,
                             height: int = 270,
                             preset_name: str = "traj_vel",
                             reference_segments: int = 20, seed: int = 0,
                             device="cuda") -> dict:
    """Attribute the winner-flip rate of ``segments`` (a count or
    ``"adaptive"``) against the reference polyline to winning-part
    transitions, both renders exact.

    Returns ``{"frame", "parts": [names...], "denom": trail_pixels,
    "trail_rate": total, "transitions": {"a->b": rate, ...},
    "trail_owner_swap": rate}`` of the worst frame by ``trail_rate``
    (no ``"frame"`` when no frame has a trail pixel): each rate is flips
    of that class over the pixels a trail wins in either render.
    ``trail_owner_swap`` is the trail->trail subset, invisible in the
    flat-color render; the per-part transitions are the pixels a viewer
    could notice.
    """
    preset = PRESETS[preset_name]
    pos, vel = _scene(n_points, seed, device)
    names = (["ground", "head", "tail", "trail"]
             if preset.splat == "droplet" else ["ground", "disc", "trail"])
    worst = None
    for fi in frames:
        cam = _camera(preset, fi, width, height, device)
        surfs, part_imgs, trail_hits = [], [], []
        for segs in (segments, reference_segments):
            idx, layout = _render(preset, cam, pos, vel, fi, segs)
            surfs.append(surface_image(idx, layout))
            pimg = part_image(idx, layout)
            part_imgs.append(pimg)
            trail_hits.append(pimg == len(layout) - 1)
        flips = surfs[0] != surfs[1]
        denom = int((trail_hits[0] | trail_hits[1]).sum())
        if not denom:
            continue
        rec = {"frame": int(fi), "parts": names, "denom": denom,
               "trail_rate": float(flips.sum()) / denom,
               "transitions": {}, "trail_owner_swap": 0.0}
        pa, pb = part_imgs[0][flips], part_imgs[1][flips]
        for a in np.unique(pa):
            for b in np.unique(pb[pa == a]):
                cnt = int(((pa == a) & (pb == b)).sum())
                an = names[a] if a >= 0 else "empty"
                bn = names[b] if b >= 0 else "empty"
                if an == bn == "trail":
                    rec["trail_owner_swap"] = cnt / denom
                else:
                    rec["transitions"][f"{an}->{bn}"] = cnt / denom
        if worst is None or rec["trail_rate"] > worst["trail_rate"]:
            worst = rec
    return worst or {"parts": names, "denom": 0, "trail_rate": 0.0,
                     "transitions": {}, "trail_owner_swap": 0.0}


def trail_segments_flip_rate(segments, n_points: int = 1500,
                             frames=(60, 120, 199), width: int = 480,
                             height: int = 270,
                             preset_name: str = "traj_ball",
                             reference_segments: int = 20, seed: int = 0,
                             capsule_eval: str = "cap10",
                             capsule_span: int = 4, device="cuda") -> dict:
    """Winner-flip rates of ``segments`` (a count in 1..20 or
    ``"adaptive"``, as ``build_primitives`` takes them) against the
    reference polyline.

    Renders the preset's trail scene at ``segments`` (the candidate) and
    at ``reference_segments`` (the exact walk) and returns the max over
    ``frames`` of
      * ``frame_rate``: flipped pixels / all pixels;
      * ``trail_rate``: flipped pixels / pixels a trail wins in either
        render (the rate the certificate bounds);
      * ``kind_rate``: the visible subset of trail_rate, pixels whose
        winning part changed (trail <-> disc / ground / empty);
      * ``candidate_diff``: pixels whose surface differs between the
        candidate and the exact walk's render of the same segment count
        (0 unless ``capsule_eval="cap8"``).
    ``capsule_eval="cap8"`` renders the candidate through the rows9 walk
    at ``capsule_span`` (pass the production span), so the rate bounds
    the combined segments + rows9 drift; ``"cap10"`` renders it exactly.
    """
    if capsule_eval not in CAPSULE_EVALS:
        raise ValueError(f"capsule_eval must be one of {CAPSULE_EVALS}")
    rows9 = capsule_eval == "cap8"
    preset = PRESETS[preset_name]
    pos, vel = _scene(n_points, seed, device)
    worst_frame = worst_trail = worst_kind = 0.0
    worst_diff = 0
    for fi in frames:
        cam = _camera(preset, fi, width, height, device)
        cand, layout = _render(preset, cam, pos, vel, fi, segments,
                               rows9=rows9, span=capsule_span)
        ref, ref_layout = _render(preset, cam, pos, vel, fi,
                                  reference_segments)
        imgs = [surface_image(cand, layout), surface_image(ref, ref_layout)]
        if rows9:
            exact, _ = _render(preset, cam, pos, vel, fi, segments)
            worst_diff = max(worst_diff, int(
                (surface_image(exact, layout) != imgs[0]).sum()))
        # Trail parts come last in the layout (ground, splats, trails):
        # their surface codes carry the highest part index.
        trail_part = len(layout) - 1
        trail_hits = [(img >> 32) == trail_part for img in imgs]
        flips = imgs[0] != imgs[1]
        # Part code: the high 32 bits of a per-point code, the negative
        # furniture / empty code itself otherwise (an arithmetic shift
        # would fold -(k + 1) into -1).
        parts = [np.where(img >= 0, img >> 32, img) for img in imgs]
        kind_flips = parts[0] != parts[1]
        denom = int((trail_hits[0] | trail_hits[1]).sum())
        worst_frame = max(worst_frame, float(np.mean(flips)))
        if denom:
            worst_trail = max(worst_trail, float(flips.sum()) / denom)
            worst_kind = max(worst_kind, float(kind_flips.sum()) / denom)
    return {"segments": segments, "frame_rate": worst_frame,
            "trail_rate": worst_trail, "kind_rate": worst_kind,
            "candidate_diff": worst_diff}
