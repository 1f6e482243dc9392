"""The plain reference and the rooflines' arithmetic: the reference's
winners equal a pixel-by-pixel loop over every primitive's bbox window
(the oracle's rule), its counts of accepted pairs and drawn primitives
are exact on a hand-built soup, the roofline's least time follows from
them, and the reference loads nothing of the program or of JAX."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.lib import imports, profile
from portbench.metrics import _roofline
from portbench.reference import raster, scene
from portbench.tests.tiny import REPO


def hand_soup():
    """A disc, a diagonal capsule over it, an invalid disc and a triangle
    across a 24 x 16 film, with one exact depth tie (rows 0 and 4)."""
    p = np.zeros((5, 12), np.float32)
    p[0, :4] = [6.0, 5.0, 2.0, 3.0]                   # disc
    p[1, :9] = [2.0, 2.0, 1.5, 1.0, 14.0, 9.0, 1.0, 0.5,
                1.0 / (14.0 * 14.0 + 9.0 * 9.0)]       # capsule
    p[2, :4] = [12.0, 8.0, 0.5, 4.0]                  # disc, invalid
    # A triangle (10, 2) (22, 2) (16, 14) at inverse depth 1/3.
    vx, vy = [10.0, 22.0, 16.0], [2.0, 2.0, 14.0]
    area = (vx[1] - vx[0]) * (vy[2] - vy[0]) - (vy[1] - vy[0]) * (vx[2] - vx[0])
    cols = []
    for a, b in ((1, 2), (2, 0), (0, 1)):
        ex, ey = vx[b] - vx[a], vy[b] - vy[a]
        cols += [ex, ey, ey * vx[a] - ex * vy[a]]
    p[3] = cols + [1.0 / 3.0 / area] * 3
    p[4, :4] = [6.0, 5.0, 2.0, 2.0]                   # disc tied with row 0
    kind = np.array([0, 1, 0, 2, 0], np.int32)
    bbox = np.array([[3, 9, 2, 8], [1, 16.5, 1, 11.5], [8, 16, 4, 12],
                     [10, 22, 2, 14], [4, 8, 3, 7]], np.float32)
    valid = np.array([1, 1, 0, 1, 1], bool)
    t = torch.from_numpy
    return scene.Soup(t(kind), t(p), torch.ones((5, 3)), t(valid), t(bbox),
                      torch.zeros((5, 3)))


def loop_oracle(soup, w, h):
    """Pixel by pixel over each valid bbox window: (depth, id, accepted
    pairs by kind)."""
    depth = np.full((h, w), np.inf, np.float32)
    ids = np.full((h, w), -1, np.int64)
    accepted = {0: 0, 1: 0, 2: 0}
    for i in range(soup.count):
        if not bool(soup.valid[i]):
            continue
        xmin, xmax, ymin, ymax = soup.bbox[i].tolist()
        k = int(soup.kind[i])
        for r in range(max(0, int(np.ceil(ymin - 0.5))),
                       min(h - 1, int(np.floor(ymax - 0.5))) + 1):
            for c in range(max(0, int(np.ceil(xmin - 0.5))),
                           min(w - 1, int(np.floor(xmax - 0.5))) + 1):
                qx = torch.tensor([c + 0.5])
                qy = torch.tensor([r + 0.5])
                cov, z = raster._test(k, soup.params[i:i + 1], qx, qy)
                if bool(cov[0]):
                    accepted[k] += 1
                    z = float(z[0])
                    if z < depth[r, c]:
                        depth[r, c], ids[r, c] = z, i
    return depth, ids, accepted


def test_winners_and_counts_equal_the_loop():
    soup = hand_soup()
    keys = raster.KeyBuffer(24, 16, "cpu")
    keys.draw(soup)
    depth, ids = keys.winners()
    want_d, want_i, accepted = loop_oracle(soup, 24, 16)
    assert np.array_equal(ids.numpy(), want_i)
    assert np.array_equal(depth.numpy(), want_d)
    assert keys.accepted == accepted
    assert keys.prims == {0: 2, 1: 1, 2: 1}
    # The tie at equal depth goes to the lower row.
    assert (ids.numpy() == 4).sum() == 0 and (ids.numpy() == 0).sum() > 0


def test_capsule_narrowing_keeps_every_accepted_pair():
    """Random capsules: the row-narrowed windows accept exactly the pairs
    of the full bbox windows."""
    g = torch.Generator().manual_seed(7)
    n, w, h = 200, 160, 90
    x0 = torch.rand(n, generator=g) * w
    y0 = torch.rand(n, generator=g) * h
    dx = (torch.rand(n, generator=g) - 0.5) * 80
    dy = (torch.rand(n, generator=g) - 0.5) * 80
    r0 = torch.rand(n, generator=g) * 3
    dr = (torch.rand(n, generator=g) - 0.5) * 2
    z0 = 1 + torch.rand(n, generator=g)
    dz = torch.rand(n, generator=g) - 0.5
    il2 = 1.0 / (dx * dx + dy * dy)
    params = torch.nn.functional.pad(torch.stack(
        [x0, y0, z0, r0, dx, dy, dz, dr, il2], 1), (0, 3))
    r1 = r0 + dr
    bbox = torch.stack([torch.minimum(x0 - r0, x0 + dx - r1),
                        torch.maximum(x0 + r0, x0 + dx + r1),
                        torch.minimum(y0 - r0, y0 + dy - r1),
                        torch.maximum(y0 + r0, y0 + dy + r1)], 1)
    soup = scene.Soup(torch.ones(n, dtype=torch.int32), params,
                      torch.ones((n, 3)), torch.ones(n, dtype=torch.bool),
                      bbox, torch.zeros((n, 3)))
    keys = raster.KeyBuffer(w, h, "cpu")
    keys.draw(soup)
    # The same soup as "discs" of the capsule formula: no narrowing.
    full = raster.KeyBuffer(w, h, "cpu")
    full.draw(scene.Soup(torch.zeros(n, dtype=torch.int32), params,
                         soup.color, soup.valid, bbox, soup.normal))
    assert keys.accepted[1] == full.accepted[0] > 0
    assert torch.equal(keys.keys, full.keys)


def test_roofline_least_time_counts_the_hand_soup():
    soup = hand_soup()
    keys = raster.KeyBuffer(24, 16, "cpu")
    keys.draw(soup)
    _, _, accepted = loop_oracle(soup, 24, 16)
    ref = {"accepted": keys.accepted, "prims": keys.prims, "images": 1,
           "pixels": 24 * 16}
    pk = {"fp32_flops_per_s": 1.0, "hbm_bytes_per_s": 1e12}
    ops = 21 * (accepted[0] + accepted[1]) + 22 * accepted[2]
    assert _roofline.least_seconds(ref, pk) == ops
    pk = {"fp32_flops_per_s": 1e15, "hbm_bytes_per_s": 1.0}
    assert _roofline.least_seconds(ref, pk) == (3 * 9 + 12) * 4 + 24 * 16 * 8


def test_roofline_calls_group_plan_walk_and_merge():
    walk = _roofline.walk_pattern(0, "kRows16")
    spans = [(0, 1, "void split_plan_kernel<TileRows>(int)"),
             (1, 11, "void csr6_walk_kernel<(RowMode)0>(float const*)"),
             (11, 13, "void csr6_merge_kernel<false>(int const*)"),
             (20, 21, "void split_plan_kernel<TileRows>(int)"),
             (21, 31, "void csr6_walk_kernel<(RowMode)2>(float const*)"),
             (31, 32, "void csr6_merge_kernel<false>(int const*)")]
    assert _roofline.calls(spans, walk) == [13e-6]
    cap10 = _roofline.walk_pattern(2, "kRows10")
    assert _roofline.calls(spans, cap10) == [12e-6]


def test_profile_busy_union_and_program_syncs():
    """Busy time is the union of the device's intervals; the runtime
    calls keep the program's synchronising calls and leave out the
    device synchronise that closes the traced window; an idle gap takes
    the name of the host's torch operation that overlaps it most."""
    def ev(cat, ts, dur, name):
        return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}
    events = [ev("kernel", 0, 10, "a"), ev("kernel", 5, 10, "b"),
              ev("gpu_memcpy", 30, 5, "Memcpy DtoH"),
              ev("gpu_memset", 45, 5, "Memset"),
              ev("cuda_runtime", 1, 1, "cudaLaunchKernel"),
              ev("cuda_runtime", 20, 9, "cudaEventSynchronize"),
              ev("cuda_runtime", 16, 1, "cudaDeviceSynchronize"),
              ev("cuda_runtime", 60, 1, "cudaDeviceSynchronize"),
              ev("cpu_op", 14, 5, "aten::mul"),
              ev("cpu_op", 21, 3, "aten::add"),
              {"ph": "i", "name": "mark"}]
    prof = profile.summarize(events, 1e-4)
    assert prof["busy_s"] == pytest.approx(25e-6)
    assert prof["runtime"] == {"cudaLaunchKernel": 1,
                               "cudaEventSynchronize": 1,
                               "cudaDeviceSynchronize": 1}
    assert [h[2] for h in prof["host"]] == ["aten::mul", "aten::add"]
    assert profile.idle_gaps(prof) == [
        ["aten::mul", pytest.approx(15e-6)],
        ["host: no torch op", pytest.approx(10e-6)]]


def test_reference_imports_nothing_of_the_program():
    assert imports.reference_imports_program() == []
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.render, portbench.harness; "
            "from portbench.lib import imports; "
            "bad = [m for m in sys.modules if imports.top_level(m) in "
            "imports.FORBIDDEN + (imports.PROGRAM,)]; "
            "print(bad); sys.exit(1 if bad else 0)" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_forbidden_names_compare_whole_top_level_names():
    assert imports.loaded_forbidden(
        ["pointcloud_render_tpu_torch.raster", "jaxtyping", "numpy"]) == []
    assert imports.loaded_forbidden(
        ["pointcloud_render_tpu.raster", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "pointcloud_render_tpu.raster"]


@pytest.mark.cuda
def test_reference_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    soup = hand_soup()
    cuda = scene.Soup(*(getattr(soup, f).cuda() for f in
                        ("kind", "params", "color", "valid", "bbox",
                         "normal")))
    a = raster.KeyBuffer(24, 16, "cpu")
    a.draw(soup)
    b = raster.KeyBuffer(24, 16, "cuda")
    b.draw(cuda)
    assert torch.equal(a.keys, b.keys.cpu()) and a.accepted == b.accepted
