"""Plain reference frames of the benchmark's scenes: soup, winners,
shading and the sRGB uint8 encode, worked out from the benchmark's inputs.

``flythrough_frame`` is one frame of the reference's traj_ball scene
(traj_ball_renderer.py: the ground, one sphere per point and straight
velocity trails as capsules, on the two-phase dolly).  It returns the
(H, W, 3) uint8 frame and the ``KeyBuffer`` whose counts the roofline
readers take.  ``quantize`` stores the soup's float fields in a lower
precision first (the control).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import scene as sc
from portbench.reference.raster import KeyBuffer


def srgb_u8(rgb: torch.Tensor) -> torch.Tensor:
    """Linear [0, 1] -> sRGB uint8 (the value lies in [0.5, 255.5]; the
    cast truncates)."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    srgb = torch.where(rgb <= 0.0031308, rgb * 12.92,
                       1.055 * torch.pow(rgb, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).to(torch.uint8)


def shade(kind, px, py, r, color, normal, hit, cam: sc.Camera, look: dict):
    """Per-pixel Lambert shading of the winners' attributes: a sphere
    normal from the pixel's offset in a disc, the face normal of a
    triangle, the flat trail boost on a capsule; one key light straight
    down (world +z in camera space), an ambient floor, the background
    where nothing won."""
    dev = px.device
    h, w = hit.shape
    m = cam.w2c
    l0, l1, l2 = m[0, 2], m[1, 2], m[2, 2]
    half = np.float32(0.5)
    qx = (torch.arange(w, dtype=torch.float32, device=dev) + half)[None, :]
    qy = (torch.arange(h, dtype=torch.float32, device=dev) + half)[:, None]
    rr = torch.clamp(r, min=1e-6)
    inv_r = torch.ones_like(rr) / rr
    u = (qx - px) * inv_r
    v = -(qy - py) * inv_r
    w2 = torch.clamp(1.0 - u * u - v * v, min=0.0)
    nz = -sc.sqrt_rn(w2)
    ndotl_disc = u * l0 + v * l1 + nz * l2
    ndotl_tri = normal[..., 0] * l0 + normal[..., 1] * l1 + normal[..., 2] * l2
    ndotl = torch.where(kind == sc.KIND_DISC, ndotl_disc, ndotl_tri)
    lit = look["ambient"] + look["diffuse"] * torch.clamp(ndotl, min=0.0)
    lit = torch.where(kind == sc.KIND_CAPSULE,
                      torch.full_like(lit, look["trail_boost"]), lit)
    rgb = color * lit[..., None]
    rgb = torch.where(hit[..., None], rgb, sc.f32(look["background"], dev))
    return torch.clamp(rgb, 0.0, 1.0)


def _shade_winners(table, ids, cam, look):
    """Shade winners whose soup rows sit in ``table`` (kind, px, py, r,
    colour, normal columns; a last all-zero row for the empty pixels)."""
    hit = ids >= 0
    a = table[torch.where(hit, ids, table.shape[0] - 1)]
    return shade(a[..., 0], a[..., 1], a[..., 2], a[..., 3], a[..., 4:7],
                 a[..., 7:10], hit, cam, look)


def _table(soup: sc.Soup) -> torch.Tensor:
    return torch.cat([soup.kind.to(torch.float32)[:, None],
                      soup.params[:, 0:2], soup.params[:, 3:4], soup.color,
                      soup.normal], dim=1)


def _zero_row(device):
    return torch.zeros((1, 10), dtype=torch.float32, device=device)


def flythrough_camera(frame: torch.Tensor, scene: dict) -> sc.Camera:
    path = scene["camera"]
    origin = sc.dolly_origin(path["waypoints"], frame, path["last_motion"],
                             path["fade"])
    return sc.look_at(origin, path["target"], scene["width"],
                      scene["height"], scene["fov_x_degrees"])


def flythrough_soup(positions, velocities, frame_index: int, scene: dict):
    """(camera, soup) of one frame: the ground, the spheres, the trails."""
    dev = positions.device
    frame = torch.tensor(float(frame_index), dtype=torch.float32, device=dev)
    cam = flythrough_camera(frame, scene)
    g, s, t = scene["ground"], scene["spheres"], scene["trails"]
    cols, valid = sc.trail_vertices(positions, velocities, frame,
                                    t["segments"], t["ramp_frames"])
    soup = sc.Soup.cat([
        sc.ground(cam, g["half_extent"], g["center"], g["color"]),
        sc.discs(positions, cam, s["radius"], s["color"]),
        sc.capsules(cols, valid, cam, t["radius"], t["color"])])
    return cam, soup


def flythrough_frame(positions, velocities, frame_index: int, scene: dict,
                     quantize=None):
    """(uint8 frame, KeyBuffer) of frame ``frame_index``."""
    cam, soup = flythrough_soup(positions, velocities, frame_index, scene)
    if quantize is not None:
        soup = sc.quantized(soup, quantize)
    keys = KeyBuffer(cam.width, cam.height, positions.device)
    keys.draw(soup)
    _, ids = keys.winners()
    table = torch.cat([_table(soup), _zero_row(positions.device)])
    return srgb_u8(_shade_winners(table, ids, cam, scene["look"])), keys

