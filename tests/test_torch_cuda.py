"""The port on an NVIDIA GPU: the csr6 CUDA kernels (16-float rows, 8-float
disc rows, disc rows with the fused (u, v), kind-split 9-float rows)
against their plain PyTorch versions, and a frame and a flythrough
rendered on the card against the same on the CPU.  Every test here needs a card (marker ``cuda``) and skips
without one.  The file imports no jax, so it also runs on a machine that
has none (from the repository root, without the JAX conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The seeded soups are ``tests/torch_soups.py``'s, the ones
``test_torch_raster.py`` holds against the NumPy oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.run.trajectory import TrajectoryScanRenderer
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
# By file name (pytest puts this directory on sys.path): an installed
# regular package named ``tests`` would shadow ``tests.torch_soups``.
from torch_soups import (
    CASES,
    NEAR_ORIGIN,
    SPAN8_FILM,
    H,
    W,
    cloud,
    disc_soup,
    droplet_soup,
    make_soup,
    tcam,
)

LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(cuda_device, case):
    soup = make_soup(case).to(cuda_device)
    before = csr6.raster_tiles.launches
    d_k, i_k, _ = csr6.rasterize_csr6(soup, W, H)
    d_p, i_p, _ = csr6.rasterize_csr6(soup, W, H, plain=True)
    torch.cuda.synchronize()
    assert csr6.raster_tiles.launches == before + 1
    np.testing.assert_array_equal(i_k.cpu().numpy(), i_p.cpu().numpy())
    np.testing.assert_array_equal(d_k.cpu().numpy().view(np.int32),
                                  d_p.cpu().numpy().view(np.int32))


@pytest.mark.cuda
def test_frame_on_card_equals_cpu(cuda_device):
    pcl = np.concatenate(cloud(), axis=1)
    for fi in (10, 120, 205):
        fbs = [pipeline.FramePipeline(PRESETS["traj_ball"], width=160,
                                      height=96, device=dev)
               .render_array(pcl, fi) for dev in ("cpu", cuda_device)]
        for field in ("index", "depth", "rgb"):
            np.testing.assert_array_equal(
                getattr(fbs[0], field).numpy(),
                getattr(fbs[1], field).cpu().numpy())


def _bits(t):
    return t.cpu().numpy().view(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["disc_ties"])
def test_disc8_kernels_match_plain_on_card(cuda_device, case):
    """csr6_disc8 and csr6_disc8_uv against their plain versions: depth
    bits, index, and the (u, v) bits with their +inf markers."""
    soup = (disc_soup(tcam()) if case == "disc_ties"
            else make_soup(case)).to(cuda_device)
    _, flag = csr6.preshade(soup, tcam(device=cuda_device), ShadingConfig())
    b = csr6.bin_csr6(soup, W, H, 256, discs_only=True)
    assert int(b["diag"]["big_overflow"]) == 0
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args = (csr6.build_table8(soup, flag),
            csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["order"], b["starts"], b["big_n"], W, H)
    for wrapper, plain in (
            (csr6.raster_tiles_disc8, csr6.raster_tiles_disc8_plain),
            (csr6.raster_tiles_disc8_uv, csr6.raster_tiles_disc8_uv_plain)):
        before = wrapper.launches
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert len(got) == len(want)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(w))
        assert bool((got[1] >= 0).any())


@pytest.mark.cuda
def test_disc_lane_scan_on_card_equals_cpu(cuda_device):
    """The flythrough on the bench's disc lane: the card's frames are the
    CPU's within 1 level (torch.pow differs between the devices), the
    linear frame bit for bit, one fused-kernel launch per frame."""
    pos, _ = cloud(n=400)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.01,
                                 point_color=LOOK[0])
    cfg = RasterConfig(discs_only=True, max_big=256, uniform_look=LOOK)
    ids = [0, 60, 120, 199, 219]
    before = csr6.raster_tiles_disc8_uv.launches
    runs = [TrajectoryScanRenderer(preset, cfg, frames_per_chunk=2,
                                   width=160, height=96, device=dev)
            .render_frames(pos, None, ids) for dev in ("cpu", cuda_device)]
    assert csr6.raster_tiles_disc8_uv.launches == before + len(ids)
    for a, b in zip(*(frames for frames, _ in runs)):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    fbs = [pipeline.FramePipeline(preset, cfg, width=160, height=96,
                                  device=dev).render_array(pos, 120)
           for dev in ("cpu", cuda_device)]
    for field in ("index", "depth", "rgb"):
        np.testing.assert_array_equal(getattr(fbs[0], field).numpy(),
                                      getattr(fbs[1], field).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("span", [2, 4, 8])
@pytest.mark.parametrize("case", CASES + ["droplets"])
def test_rows9_kernel_matches_plain_on_card(cuda_device, case, span):
    """csr6_rows9 against its plain version: depth bits and index, on the
    seeded soups and a traj_vel droplet soup on a 10x8-tile film (ties,
    long capsules on the big list at span 2, binned at span 4, and 5-8
    tiles long, binned only at span 8; invalid rows)."""
    w, h = SPAN8_FILM if case == "droplets" else (W, H)
    soup = (droplet_soup(tcam(w, h, origin=NEAR_ORIGIN))
            if case == "droplets" else make_soup(case)).to(cuda_device)
    b = csr6.bin_csr6(soup, w, h, 256, span=span, kind_split=True)
    assert int(b["diag"]["big_overflow"]) == 0
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args = (csr6.build_table9(soup, b["order"], b["starts"][-1]),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], w, h, span)
    before = csr6.raster_tiles_rows9.launches
    got = csr6.raster_tiles_rows9(*args)
    want = csr6.raster_tiles_rows9_plain(*args)
    torch.cuda.synchronize()
    assert csr6.raster_tiles_rows9.launches == before + 1
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(w))
    assert bool((got[1] >= 0).any())


@pytest.mark.cuda
def test_rows8_and_rows9_share_the_kernel_on_card(cuda_device):
    """rows8 and rows9 launch the same kernel once each and render the
    same frame, equal to the CPU's plain walk bit for bit."""
    cpu_soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    soup = cpu_soup.to(cuda_device)
    cam = tcam(origin=NEAR_ORIGIN, device=cuda_device)
    before = csr6.raster_tiles_rows9.launches
    fbs = [render(soup, cam, RasterConfig(span=4, **{mode: True}))
           for mode in ("rows8", "rows9")]
    torch.cuda.synchronize()
    assert csr6.raster_tiles_rows9.launches == before + 2
    ref = render(cpu_soup, tcam(origin=NEAR_ORIGIN), RasterConfig(
        span=4, rows9=True))
    for field in ("index", "depth"):
        np.testing.assert_array_equal(_bits(getattr(fbs[0], field)),
                                      _bits(getattr(fbs[1], field)))
        np.testing.assert_array_equal(_bits(getattr(fbs[1], field)),
                                      _bits(getattr(ref, field)))


@pytest.mark.cuda
def test_droplet_frame_on_card_near_cpu(cuda_device):
    """A traj_vel frame on the tuned lane's config (rows9, span 4, four
    tones) on the card and on the CPU.  The soups differ only where the
    devices' arccos/cos/sin round differently (the tail capsules, a few
    ulp): all but a few winners agree, and one launch per frame."""
    pos, vel = cloud(n=300)
    pcl = np.concatenate([pos, vel], axis=1)
    preset = PRESETS["traj_vel"]
    soup = pipeline.build_primitives(
        preset, pipeline.frame_camera(preset, 20, 160, 96, "cpu"), pos, vel,
        20)
    tones, ok = csr6.derive_four_tone(soup)
    assert bool(ok)
    cfg = RasterConfig(rows9=True, span=4,
                       three_tone=tuple(int(r) for r in tones))
    before = csr6.raster_tiles_rows9.launches
    fbs = [pipeline.FramePipeline(preset, cfg, width=160, height=96,
                                  device=dev).render_array(pcl, 120)
           for dev in ("cpu", cuda_device)]
    assert csr6.raster_tiles_rows9.launches == before + 1
    same = fbs[0].index.numpy() == fbs[1].index.cpu().numpy()
    soups = [pipeline.build_primitives(
        preset, pipeline.frame_camera(preset, 120, 160, 96, dev), pos, vel,
        120) for dev in ("cpu", cuda_device)]
    tails = slice(4 + len(pos), 4 + 2 * len(pos))
    moved = int((soups[0].params[tails] != soups[1].params[tails].cpu())
                .any(dim=1).sum())
    print(f"traj_vel frame, card vs CPU: {int((~same).sum())} winner "
          f"flips; {moved} of {len(pos)} tail capsules differ")
    assert (~same).sum() <= 8
    assert (fbs[0].index.numpy() >= 0).any()
