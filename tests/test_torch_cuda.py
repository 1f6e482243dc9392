"""The port on an NVIDIA GPU: the CUDA kernels (csr6 16-float rows at
spans 2, 4 and 8, with and without binned triangles, 10-float cap_rows10
rows, 8-float disc rows, disc rows with the fused (u, v), kind-split
9-float rows; the v4 walk with and without its z-bucket early exit; the
v3 disc fast path with and without its exit; the v1 and v2 strip walks,
16-float and 8-float disc rows, with their saturation exit; the v5
chunk-binned disc walk, with and without its exit and its fused shade;
the disc rows at spans 4 and 8; the 16-, 10-, 9- and 8-float walks and
the v2 strip walk with their tiles split into work items, the 16-float
walk and the disc walk with their z-bucket exit, the disc walks' cull on
discs tangent to its bands)
against their plain PyTorch versions, and frames and flythroughs (traj_ball, the disc
lane, traj's history trails, the pallas backend) rendered on the card
against the same on the CPU.  Every test here needs a card (marker
``cuda``) and skips without one.  The file imports no jax, so it also runs on a machine that
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
from pointcloud_render_tpu_torch.raster import (
    csr,
    csr2,
    csr3,
    csr4,
    csr5,
    csr6,
)
from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.run.trajectory import TrajectoryScanRenderer
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
# By file name (pytest puts this directory on sys.path): an installed
# regular package named ``tests`` would shadow ``tests.torch_soups``.
from torch_soups import (
    CASES,
    CROSS_FILM,
    NEAR_ORIGIN,
    SPAN8_FILM,
    H,
    W,
    band_soup,
    cloud,
    cross_class_soup,
    disc_soup,
    droplet_soup,
    make_soup,
    mesh_soup,
    morton_soup,
    split_soup,
    tcam,
    v5_soups,
    wide_disc_soup,
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
    args = (csr6.build_rows8(soup, flag, b["order"]),
            csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["starts"], b["big_n"], W, H)
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
@pytest.mark.parametrize("split_rows", [csr6.SPLIT_ROWS, 64])
@pytest.mark.parametrize("span", [2, 4, 8])
@pytest.mark.parametrize("case", CASES + ["droplets"])
def test_rows9_kernel_matches_plain_on_card(cuda_device, case, span,
                                            split_rows):
    """csr6_rows9 against its plain version: depth bits and index, on the
    seeded soups and a traj_vel droplet soup on a 10x8-tile film (ties,
    long capsules on the big list at span 2, binned at span 4, and 5-8
    tiles long, binned only at span 8; invalid rows), its tiles cut into
    work items of ``split_rows`` rows (at 64, the dense tile's into more
    than csr6.ITEMS_PER_TILE items); one launch a call."""
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
    got = csr6.raster_tiles_rows9(*args, split_rows=split_rows)
    want = csr6.raster_tiles_rows9_plain(*args)
    torch.cuda.synchronize()
    assert csr6.raster_tiles_rows9.launches == before + 1
    for a, ref in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(ref))
    assert bool((got[1] >= 0).any())
    if case == "dense_tile" and split_rows == 64:
        # The plan's item size (csrc/split_walk.cuh split_plan_kernel).
        k2t = span * span * csr6.grid_shape(w, h)[0] * csr6.grid_shape(w, h)[1]
        rows = (csr6.tile_rows(b["starts"][:k2t + 1], w, h, span)
                + csr6.tile_rows(b["starts"][k2t:], w, h, span)
                + int(b["big_n"][0]))
        item = max(split_rows, -(-int(rows.sum()) // (
            (csr6.ITEMS_PER_TILE - 1) * rows.numel())))
        assert -(-int(rows.max()) // item) > csr6.ITEMS_PER_TILE


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


@pytest.mark.cuda
@pytest.mark.parametrize("bin_triangles", [False, True])
@pytest.mark.parametrize("case", CASES + ["mesh"])
def test_binned_triangle_and_v4_kernels_match_plain_on_card(
        cuda_device, case, bin_triangles):
    """csr6_raster (with and without bin_triangles) and csr4_raster with
    its z-bucket exit and with it off, against their plain versions:
    depth bits and index, on the seeded soups and a mesh-LOD soup (binned
    droplet triangles, ties, near-clip rows, wide triangles on the big
    list)."""
    soup = (mesh_soup(tcam()) if case == "mesh"
            else make_soup(case)).to(cuda_device)
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    table = csr6.build_table16(soup, zeros, zeros[:, 0],
                               bin_triangles=bin_triangles)
    b = csr6.bin_csr6(soup, W, H, 1 << 14, bin_triangles=bin_triangles)
    args = (table, b["order"], b["starts"], b["big_ids"], b["big_n"], W, H,
            bin_triangles)
    counter = csr6.raster_tiles_tri if bin_triangles else csr6.raster_tiles
    before = counter.launches
    got = csr6.raster_tiles(*args)
    want = csr6.raster_tiles_plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(w))
    b4 = csr4.bin_csr4(soup, W, H, 1 << 14, bin_triangles)
    for zq in (b4["zq_bits"], 0):  # the early exit on, then off
        args4 = (table, b4["entries"], b4["starts"], b4["big_ids"],
                 b4["big_n"], b4["zmeta"], W, H, zq, bin_triangles)
        before = csr4.raster_tiles4.launches
        got4 = csr4.raster_tiles4(*args4)
        want4 = csr4.raster_tiles4_plain(*args4)
        torch.cuda.synchronize()
        assert csr4.raster_tiles4.launches == before + 1
        for a, w in zip(got4, want4):
            np.testing.assert_array_equal(_bits(a), _bits(w))
        # walked: the whole range without the exit; with it, at least the
        # first chunk of 256 (the exit is tested after each chunk).
        lengths = b4["starts"][1:] - b4["starts"][:-1]
        walked = torch.full_like(lengths, -1)
        again = csr4.raster_tiles4(*args4, walked=walked)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(_bits(again[0]), _bits(got4[0]))
        if zq == 0:
            assert torch.equal(walked, lengths)
        else:
            assert bool((walked <= lengths).all())
            assert bool((walked >= torch.clamp(lengths, max=256)).all())
        for a, w in zip(got4, got):  # v4 == v6
            np.testing.assert_array_equal(_bits(a), _bits(w))
    assert bool((got[1] >= 0).any())


@pytest.mark.cuda
def test_v4_capacity_truncation_on_card(cuda_device):
    """csr4_raster on entries truncated below true_entries equals its
    plain version on the same truncated entries."""
    soup = mesh_soup(tcam()).to(cuda_device)
    cap = int(csr4.true_entry_count4(soup, W, H, bin_triangles=True)) // 2
    before = csr4.raster_tiles4.launches
    d, i, diag = csr4.rasterize_csr4(soup, W, H, entry_capacity=cap,
                                     bin_triangles=True)
    d_p, i_p, _ = csr4.rasterize_csr4(soup, W, H, entry_capacity=cap,
                                      bin_triangles=True, plain=True)
    torch.cuda.synchronize()
    assert csr4.raster_tiles4.launches == before + 1
    assert int(diag["true_entries"]) > cap
    np.testing.assert_array_equal(_bits(i), _bits(i_p))
    np.testing.assert_array_equal(_bits(d), _bits(d_p))


@pytest.mark.cuda
def test_mesh_frame_on_card_near_cpu(cuda_device):
    """A 160x96 mesh-LOD traj_vel frame on the card and on the CPU: the
    droplets' rotations round differently on the two devices (ROADMAP
    queue C), so whole droplets move by ulps; all but a few winners agree.
    One binned-triangle launch; pallas4 renders the card's frame too."""
    pos, vel = cloud(n=40, seed=3)
    pcl = np.concatenate([pos, vel], axis=1)
    preset = PRESETS["traj_vel"]
    before = csr6.raster_tiles_tri.launches
    fbs = [pipeline.FramePipeline(preset, droplet_lod="mesh", width=160,
                                  height=96, device=dev).render_array(pcl, 120)
           for dev in ("cpu", cuda_device)]
    assert csr6.raster_tiles_tri.launches == before + 1
    same = fbs[0].index.numpy() == fbs[1].index.cpu().numpy()
    print(f"mesh-LOD frame, card vs CPU: {int((~same).sum())} winner flips")
    assert (~same).sum() <= 8
    v4 = pipeline.FramePipeline(
        preset, RasterConfig(backend="pallas4", bin_triangles=True),
        droplet_lod="mesh", width=160, height=96,
        device=cuda_device).render_array(pcl, 120)
    for field in ("index", "depth", "rgb"):
        np.testing.assert_array_equal(_bits(getattr(v4, field)),
                                      _bits(getattr(fbs[1], field)))


@pytest.mark.cuda
@pytest.mark.parametrize("span", [2, 4, 8])
@pytest.mark.parametrize("case", CASES + ["droplets"])
def test_cap10_and_wide_span_kernels_match_plain_on_card(cuda_device, case,
                                                         span):
    """csr6_cap10 and csr6_raster at ``span`` == their plain versions bit
    for bit, and == each other (the same capsule expressions)."""
    if case == "droplets":
        soup = droplet_soup(tcam(*SPAN8_FILM, device=cuda_device,
                                 origin=NEAR_ORIGIN))
        w, h = SPAN8_FILM
    else:
        soup, (w, h) = make_soup(case).to(cuda_device), (W, H)
    b = csr6.bin_csr6(soup, w, h, 1 << 14, span=span)
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args10 = (csr6.build_table10(soup), csr6.build_table16_rows(
        soup, zeros, zeros[:, 0], b["big_ids"]), b["order"], b["starts"],
        b["big_n"], w, h, span)
    args16 = (csr6.build_table16(soup, zeros, zeros[:, 0]), b["order"],
              b["starts"], b["big_ids"], b["big_n"], w, h, False, span)
    before = (csr6.raster_tiles_cap10.launches, csr6.raster_tiles.launches)
    got10 = csr6.raster_tiles_cap10(*args10)
    got16 = csr6.raster_tiles(*args16)
    torch.cuda.synchronize()
    assert (csr6.raster_tiles_cap10.launches,
            csr6.raster_tiles.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((got10, csr6.raster_tiles_cap10_plain(*args10)),
                      (got16, csr6.raster_tiles_plain(*args16)),
                      (got10, got16)):
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      want[1].cpu().numpy())
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("exit_on", [True, False])
@pytest.mark.parametrize("case", CASES + ["disc_ties"])
def test_v3_kernel_matches_plain_on_card(cuda_device, case, exit_on):
    """csr3_raster == raster_tiles3_plain bit for bit (depth bits, entry
    image) with its exit on and off, on full and on capacity-cut entries;
    the entries it walked never pass a tile's run."""
    soup = (disc_soup(tcam()) if case == "disc_ties"
            else make_soup(case)).to(cuda_device)
    b = csr3.bin_csr_2x2(soup, W, H, max_big=1 << 14)
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    for cap in (None, 2 * int(b["starts"][-1]) // 3):
        entries, starts = csr3.cut_entries(b, cap)
        rows = csr3.pack_rows8(soup, entries, b["big_ids"], zeros,
                               zeros[:, 0], (0.0, 0.0, 0.0))
        args = (rows[:entries.shape[0]], csr6.build_table16_rows(
            soup, zeros, zeros[:, 0], b["big_ids"]), starts, b["big_n"],
            b["zmeta"], W, H, b["zq_bits"])
        walked = torch.empty_like(starts[1:])
        before = csr3.raster_tiles3.launches
        got = csr3.raster_tiles3(*args, walked=walked, allow_exit=exit_on,
                                 block=64)
        want = csr3.raster_tiles3_plain(*args)
        torch.cuda.synchronize()
        assert csr3.raster_tiles3.launches == before + 1
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      want[1].cpu().numpy())
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        lengths = starts[1:] - starts[:-1]
        assert bool((walked <= lengths).all())
        if not exit_on:
            assert torch.equal(walked, lengths)


@pytest.mark.cuda
def test_traj_frame_and_scan_on_card_near_cpu(cuda_device):
    """A 160x96 traj frame with 20 frames of history, on the card and on
    the CPU (the droplets' rotations round differently per device:
    ROADMAP queue C), and the card's frame through cap_rows10 and pallas3
    against its default walk; a short traj scan on the card equals the
    pipeline's frames there."""
    pos, vel = cloud()
    hist = np.stack([pos + vel * np.float32(0.002 * (k - 20))
                     for k in range(20)])
    pcl = np.concatenate([pos, vel], axis=1)
    fbs = [pipeline.FramePipeline(PRESETS["traj"], cfg, width=160,
                                  height=96, device=dev)
           .render_array(pcl, 23, hist)
           for dev, cfg in (("cpu", RasterConfig()),
                            (cuda_device, RasterConfig()),
                            (cuda_device, RasterConfig(cap_rows10=True,
                                                       span=4)))]
    flips = int((fbs[0].index.numpy() != fbs[1].index.cpu().numpy()).sum())
    assert flips <= 8
    span4 = pipeline.FramePipeline(PRESETS["traj"], RasterConfig(span=4),
                                   width=160, height=96, device=cuda_device)
    want = span4.render_array(pcl, 23, hist)
    for field in ("index", "depth", "rgb"):
        np.testing.assert_array_equal(
            _bits(getattr(fbs[2], field)), _bits(getattr(want, field)))
    scan = TrajectoryScanRenderer(PRESETS["traj"], dt=0.002,
                                  frames_per_chunk=3, width=160, height=96,
                                  device=cuda_device)
    frames, _ = scan.render_frames(pos, vel, range(5))
    assert len(frames) == 5 and (frames[4].min(axis=2) < 250).mean() > 0.005


# (name, rasterize function, its keyword arguments) of the strip walks:
# v1 and v2 generic rows, v2 without binned triangles, v2 disc rows, a
# strip shape of 2048 pixels (two passes per tile) and a narrow one.
STRIP_WALKS = {
    "v1": (csr.rasterize_csr, {}),
    "v1_max_big_3": (csr.rasterize_csr, dict(max_big=3)),
    "v2": (csr2.rasterize_csr2, {}),
    "v2_no_triangles": (csr2.rasterize_csr2, dict(no_triangles=True)),
    "v2_discs_only": (csr2.rasterize_csr2, dict(discs_only=True)),
    "v2_16x128": (csr2.rasterize_csr2, dict(tile_h=16, tile_w=128)),
    "v2_4x24": (csr2.rasterize_csr2, dict(tile_h=4, tile_w=24,
                                          max_tiles_per_prim=8)),
}


# Strip shapes of csr2_raster's split walk with its passes cut into work
# items of 64 rows (4x24: a thread's pixels in several columns).
SPLIT_STRIPS = {"v2_split_8x128": (8, 128), "v2_split_16x256": (16, 256),
                "v2_split_4x32": (4, 32), "v2_split_4x24": (4, 24)}


def _check_split_strips(soup, tile_h, tile_w):
    """csr2_raster with its exit off and on, at csr6.SPLIT_ROWS and at 64
    rows per work item, == the plain strip walk; one launch a call;
    ``walked`` is every row times the passes with the exit off, at most
    that with it on."""
    b = csr.bin_csr(soup, W, H, tile_h, tile_w, max_tiles_per_prim=8)
    n = int(b["starts"][-1])
    args = (csr.pack_rows_generic(soup, b["prims"][:n], b["keys"][:n],
                                  b["zmin"], b["span"]),
            b["starts"], csr.pack_big_rows(soup, b["big_ids"]), b["big_n"],
            W, H, tile_h, tile_w)
    want = csr.raster_strips_plain(*args)
    lengths = (b["starts"][1:] - b["starts"][:-1]) * -(-tile_h * tile_w
                                                       // 1024)
    for allow_exit in (False, True):
        for split_rows in (csr6.SPLIT_ROWS, 64):
            walked = torch.full_like(lengths, -1)
            before = csr2.raster_tiles2.launches
            got = csr2.raster_tiles2(*args, walked=walked,
                                     allow_exit=allow_exit,
                                     split_rows=split_rows)
            torch.cuda.synchronize()
            assert csr2.raster_tiles2.launches == before + 1
            for a, w in zip(got, want):
                np.testing.assert_array_equal(_bits(a), _bits(w))
            if allow_exit:
                assert bool(((walked >= 0) & (walked <= lengths)).all())
            else:
                assert torch.equal(walked, lengths)
    assert bool((want[1] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("walk", sorted(STRIP_WALKS) + sorted(SPLIT_STRIPS))
@pytest.mark.parametrize("case", CASES + ["disc_ties"])
def test_strip_kernels_match_plain_on_card(cuda_device, case, walk):
    """csr1_raster, csr2_raster and csr2_disc8 (with their saturation
    exit) against the plain strip walk (none): depth bits and index, one
    launch of the wrapper the walk names; csr2_raster's split walk also
    with forced splits, its exit off and on (``SPLIT_STRIPS``)."""
    soup = (disc_soup(tcam()) if case == "disc_ties"
            else make_soup(case)).to(cuda_device)
    if walk in SPLIT_STRIPS:
        _check_split_strips(soup, *SPLIT_STRIPS[walk])
        return
    fn, kw = STRIP_WALKS[walk]
    wrapper = (csr.raster_tiles1 if fn is csr.rasterize_csr
               else csr2.raster_tiles2_disc8 if kw.get("discs_only")
               else csr2.raster_tiles2)
    before = wrapper.launches
    got = fn(soup, W, H, **kw)
    want = fn(soup, W, H, plain=True, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for a, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_bits(a), _bits(w))
    assert bool((got[1] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("discs_only", [False, True])
def test_strip_capacity_cut_and_walked_on_card(cuda_device, discs_only):
    """v2 on entries cut by an entry_capacity below true_entries equals
    the plain walk on the same cut; ``walked`` counts at most each tile's
    range, and all of it with nothing to stop on (no ground: tiles never
    fill)."""
    soup = disc_soup(tcam()).to(cuda_device)
    true = int(csr2.true_entry_count(soup, W, H, no_triangles=discs_only))
    cap = 2 * true // 3
    got = csr2.rasterize_csr2(soup, W, H, discs_only=discs_only,
                              entry_capacity=cap)
    want = csr2.rasterize_csr2(soup, W, H, discs_only=discs_only,
                               entry_capacity=cap, plain=True)
    assert int(got[2]["true_entries"]) == true > cap
    for a, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_bits(a), _bits(w))
    b = csr.bin_csr(soup, W, H, max_tiles_per_prim=4)
    zeros = torch.zeros((b["starts"].shape[0] - 1,), dtype=torch.int32,
                        device=cuda_device)
    lengths = b["starts"][1:] - b["starts"][:-1]
    n = int(b["starts"][-1])
    rows = csr.pack_rows_generic(soup, b["prims"][:n], b["keys"][:n],
                                 b["zmin"], b["span"])
    big = csr.pack_big_rows(soup, b["big_ids"])
    walked = zeros.clone()
    csr2.raster_tiles2(rows, b["starts"], big, b["big_n"], W, H,
                       walked=walked)
    assert bool((walked <= lengths).all())
    no_ground = disc_soup(tcam(), ground=False, wide=0).to(cuda_device)
    b = csr.bin_csr(no_ground, W, H, max_tiles_per_prim=4)
    n = int(b["starts"][-1])
    walked = zeros.clone()
    csr2.raster_tiles2(csr.pack_rows_generic(no_ground, b["prims"][:n],
                                             b["keys"][:n], b["zmin"],
                                             b["span"]),
                       b["starts"], csr.pack_big_rows(no_ground,
                                                      b["big_ids"]),
                       b["big_n"], W, H, walked=walked)
    assert torch.equal(walked, b["starts"][1:] - b["starts"][:-1])


@pytest.mark.cuda
def test_pallas_frame_and_scan_on_card_equal_cpu(cuda_device):
    """FramePipeline and the scan through backend "pallas" (v2) at
    160x96: the card's frames equal the CPU's (index, depth, rgb; the scan
    within 1 u8 level), one csr2_raster launch per frame."""
    pcl = np.concatenate(cloud(), axis=1)
    cfg = RasterConfig(backend="pallas")
    for fi in (10, 120):
        fbs = [pipeline.FramePipeline(PRESETS["traj_ball"], cfg, width=160,
                                      height=96, device=dev)
               .render_array(pcl, fi) for dev in ("cpu", cuda_device)]
        for field in ("index", "depth", "rgb"):
            np.testing.assert_array_equal(
                getattr(fbs[0], field).numpy(),
                getattr(fbs[1], field).cpu().numpy())
    pos, _ = cloud(n=400)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.01,
                                 point_color=LOOK[0])
    lane = RasterConfig(backend="pallas", discs_only=True,
                        no_triangles=True, max_tiles_per_prim=4,
                        entry_capacity=4096)
    ids = [0, 120, 219]
    before = csr2.raster_tiles2_disc8.launches
    runs = [TrajectoryScanRenderer(preset, lane, frames_per_chunk=2,
                                   width=160, height=96, device=dev)
            .render_frames(pos, None, ids) for dev in ("cpu", cuda_device)]
    assert csr2.raster_tiles2_disc8.launches == before + len(ids)
    for a, b in zip(*(frames for frames, _ in runs)):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wide", "spill", "disc_ties"])
@pytest.mark.parametrize("span", [4, 8])
def test_disc8_kernels_at_wide_spans_match_plain_on_card(cuda_device, case,
                                                        span):
    """csr6_disc8 and csr6_disc8_uv at spans 4 and 8 == their plain
    versions: depth bits, index, (u, v) bits."""
    if case == "wide":
        soup, (w, h) = wide_disc_soup().to(cuda_device), SPAN8_FILM
    else:
        soup = (disc_soup(tcam()) if case == "disc_ties"
                else make_soup(case)).to(cuda_device)
        w, h = W, H
    _, flag = csr6.preshade(soup, tcam(w, h, device=cuda_device),
                            ShadingConfig())
    b = csr6.bin_csr6(soup, w, h, 1024, discs_only=True, span=span)
    assert int(b["diag"]["big_overflow"]) == 0
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args = (csr6.build_rows8(soup, flag, b["order"]),
            csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["starts"], b["big_n"], w, h, span)
    for wrapper, plain in (
            (csr6.raster_tiles_disc8, csr6.raster_tiles_disc8_plain),
            (csr6.raster_tiles_disc8_uv, csr6.raster_tiles_disc8_uv_plain)):
        before = wrapper.launches
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        for a, w_ in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(w_))
        assert bool((got[1] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("split_rows", [csr6.SPLIT_ROWS_DISC, 64])
@pytest.mark.parametrize("span", [2, 4, 8])
@pytest.mark.parametrize("case", ["band", "disc_ties", "dense_tile"])
def test_disc8_split_cull_matches_plain_on_card(cuda_device, case, span,
                                                split_rows):
    """csr6_disc8 and csr6_disc8_uv with their tiles cut into items of
    ``split_rows`` rows == their plain versions bit for bit (depth, index,
    (u, v)) on discs tangent to the cull's bands, centred on band
    boundaries, at the ragged bottom edge, with exact ties across items;
    ``walked`` is every tile's row count and ``bands`` :func:`band_rows`;
    at span 2 csr6_disc8 also with the exit forced on (the exit binning),
    walking at most every tile's rows."""
    soup = {"band": band_soup, "disc_ties": lambda: disc_soup(tcam()),
            "dense_tile": lambda: make_soup("dense_tile")}[case]()
    soup = soup.to(cuda_device)
    _, flag = csr6.preshade(soup, tcam(device=cuda_device), ShadingConfig())
    b = csr6.bin_csr6(soup, W, H, 256, discs_only=True, span=span,
                      with_z=span == 2)
    assert int(b["diag"]["big_overflow"]) == 0
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args = (csr6.build_rows8(soup, flag, b["order"]),
            csr6.build_table16_rows(soup, zeros, flag, b["big_ids"]),
            b["starts"], b["big_n"], W, H, span)
    rows = csr6.tile_rows(b["starts"], W, H, span)
    kept = csr6.band_rows(args[0], b["starts"], W, H, span)
    runs = [(csr6.raster_tiles_disc8, csr6.raster_tiles_disc8_plain, None),
            (csr6.raster_tiles_disc8_uv, csr6.raster_tiles_disc8_uv_plain,
             None)]
    if span == 2:
        runs.append((csr6.raster_tiles_disc8, csr6.raster_tiles_disc8_plain,
                     b["zmeta"]))
    for wrapper, plain, zmeta in runs:
        walked = torch.full_like(rows, -1)
        bands = torch.full_like(rows, -1)
        kw = dict(walked=walked, bands=bands, split_rows=split_rows)
        if zmeta is not None:
            kw["zmeta"] = zmeta
        got = wrapper(*args, **kw)
        want = plain(*args)
        torch.cuda.synchronize()
        for a, w_ in zip(got, want, strict=True):
            np.testing.assert_array_equal(_bits(a), _bits(w_))
        assert bool((got[1] >= 0).any())
        if zmeta is None:
            assert torch.equal(walked, rows)
            assert torch.equal(bands, kept)
        else:
            assert bool(((walked >= 0) & (walked <= rows)).all())
            assert bool(((bands >= 0) & (bands <= kept)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("span", [4, 8])
def test_disc_entry_point_at_wide_spans_on_card(cuda_device, span):
    """render_shaded_csr6(discs_only, uniform_look) at spans 4 and 8 takes
    the fused walk: one csr6_disc8_uv launch, and rgb, depth and index ==
    its plain walk bit for bit."""
    soup = wide_disc_soup().to(cuda_device)
    cam = tcam(*SPAN8_FILM, device=cuda_device)
    look = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))
    kw = dict(max_big=256, discs_only=True, uniform_look=look, span=span)
    before = (csr6.raster_tiles_disc8.launches,
              csr6.raster_tiles_disc8_uv.launches)
    got = csr6.render_shaded_csr6(soup, cam, ShadingConfig(), **kw)
    torch.cuda.synchronize()
    assert (csr6.raster_tiles_disc8.launches,
            csr6.raster_tiles_disc8_uv.launches) == (before[0],
                                                     before[1] + 1)
    want = csr6.render_shaded_csr6(soup, cam, ShadingConfig(), plain=True,
                                   **kw)
    assert int(got[3]["big_overflow"]) == 0
    for a, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_bits(a), _bits(w_))
    assert bool((got[2] >= 0).any())


# (soup, knobs) of the v5 kernels: the v5 slice's soups, the tile shapes
# 16x64, 64x16 and 8x128, chunks of 8 at span 2, exit checks every row,
# an entry capacity past the true count, and the seeded soups of
# torch_soups in their original order and in Morton order.
V5_CASES = {
    "v5_sorted": ("v5_sorted", {}),
    "v5_unsorted_spill": ("v5_unsorted", {"max_span": 2, "max_big": 64}),
    "v5_mixed": ("v5_mixed", {}),
    "tile16x64": ("v5_sorted", {"tile_h": 16, "tile_w": 64}),
    "tile64x16": ("v5_mixed", {"tile_h": 64, "tile_w": 16}),
    "tile8x128": ("v5_unsorted", {"tile_h": 8, "tile_w": 128}),
    "k8_span2_check1": ("v5_sorted", {"k": 8, "max_span": 2,
                                      "check_every": 1}),
    "capacity": ("v5_sorted", {"capacity": 7}),
    **{c: (c, {}) for c in CASES},
    **{c + "_morton": (c + "_morton", {}) for c in CASES},
}


def _v5_soup(name, device):
    if name.startswith("v5_"):
        return v5_soups(device)[name[3:]]
    if name.endswith("_morton"):
        return morton_soup(make_soup(name[:-7]).to(device))
    return make_soup(name).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(V5_CASES))
def test_v5_kernels_match_plain_on_card(cuda_device, case):
    """csr5_raster and csr5_shaded (with and without uniform_color) ==
    raster_tiles5_plain bit for bit (depth, index, rgb) with the exit on
    and off; ``walked`` never passes a tile's run, and is the whole run
    with the exit off."""
    name, kw = V5_CASES[case]
    kw = dict(kw)
    extra = kw.pop("capacity", None)
    check_every = kw.pop("check_every", csr5.DEFAULT_CHECK_EVERY)
    soup = _v5_soup(name, cuda_device)
    cam = tcam(device=cuda_device)
    tile_h, tile_w = kw.get("tile_h", 32), kw.get("tile_w", 32)
    k = kw.get("k", csr5.DEFAULT_K)
    max_spill = kw.get("max_spill", csr5.DEFAULT_MAX_SPILL)
    b = csr5.bin_chunks5(soup, W, H, **kw)
    assert int(b["diag"]["big_overflow"]) == 0
    chunks, starts = b["chunks"], b["starts"]
    if extra is not None:  # a capacity past the true count drops nothing
        e = int(starts[-1]) + extra
        chunks, starts = chunks[:e], torch.clamp(starts, max=e)
    rgb_p, _ = csr6.preshade(soup, cam, ShadingConfig())
    tab, bp, kinds, meta = csr5.tables5(
        soup, b, rgb_p, csr5.look5(soup, cam, ShadingConfig(),
                                   (0.3, 0.3, 0.3)), max_spill, k)
    args = (tab, chunks, starts, bp, kinds, b["big_n"], meta, W, H, tile_h,
            tile_w, k)
    want = csr5.raster_tiles5_plain(*args)
    want_s = csr5.raster_tiles5_plain(*args, fused=True)
    want_u = csr5.raster_tiles5_plain(*args, fused=True, uniform=True)
    lengths = starts[1:] - starts[:-1]
    for exit_on in (True, False):
        before = (csr5.raster_tiles5.launches,
                  csr5.raster_tiles5_shaded.launches)
        walked = torch.full_like(lengths, -1)
        got = csr5.raster_tiles5(*args, check_every=check_every,
                                 allow_exit=exit_on, walked=walked)
        got_s = csr5.raster_tiles5_shaded(*args, check_every=check_every,
                                          allow_exit=exit_on)
        got_u = csr5.raster_tiles5_shaded(*args, check_every=check_every,
                                          uniform=True, allow_exit=exit_on)
        torch.cuda.synchronize()
        assert (csr5.raster_tiles5.launches,
                csr5.raster_tiles5_shaded.launches) == (before[0] + 1,
                                                        before[1] + 2)
        for g, w_ in ((got, want), (got_s, want_s), (got_u, want_u)):
            assert len(g) == len(w_)
            for a, c in zip(g, w_):
                np.testing.assert_array_equal(_bits(a), _bits(c))
        assert bool((got[1] >= 0).any())
        assert bool((walked >= 0).all() & (walked <= lengths).all())
        if not exit_on:
            assert torch.equal(walked, lengths)


@pytest.mark.cuda
def test_v5_entry_points_on_card(cuda_device):
    """rasterize_csr5 and render_shaded_csr5 launch their kernels once and
    equal their plain walks; an entry capacity at the true count equals
    the uncut frame."""
    soup = v5_soups(cuda_device)["mixed"]
    cam = tcam(device=cuda_device)
    before = (csr5.raster_tiles5.launches,
              csr5.raster_tiles5_shaded.launches)
    d, i, diag = csr5.rasterize_csr5(soup, W, H, return_diag=True)
    rgb, d2, i2 = csr5.render_shaded_csr5(soup, cam, ShadingConfig(),
                                          uniform_color=(0.3, 0.3, 0.3))
    torch.cuda.synchronize()
    assert (csr5.raster_tiles5.launches,
            csr5.raster_tiles5_shaded.launches) == (before[0] + 1,
                                                    before[1] + 1)
    pd, pi = csr5.rasterize_csr5(soup, W, H, plain=True)
    prgb, _, _ = csr5.render_shaded_csr5(soup, cam, ShadingConfig(),
                                         uniform_color=(0.3, 0.3, 0.3),
                                         plain=True)
    for a, c in ((d, pd), (i, pi), (d2, pd), (i2, pi), (rgb, prgb)):
        np.testing.assert_array_equal(_bits(a), _bits(c))
    n = int(diag["true_entries"])
    rgb_c, _, i_c = csr5.render_shaded_csr5(
        soup, cam, ShadingConfig(), uniform_color=(0.3, 0.3, 0.3),
        entry_capacity=n)
    np.testing.assert_array_equal(_bits(rgb_c), _bits(rgb))
    np.testing.assert_array_equal(_bits(i_c), _bits(i2))


def _exit_case(case, device):
    """(soup, film) of the exit and split cases."""
    if case == "cross_class":
        return cross_class_soup().to(device), CROSS_FILM
    if case == "split":
        return split_soup().to(device), (W, H)
    if case == "mesh":
        return mesh_soup(tcam()).to(device), (W, H)
    return make_soup(case).to(device), (W, H)


@pytest.mark.cuda
@pytest.mark.parametrize("split_rows", [csr6.SPLIT_ROWS, 64])
@pytest.mark.parametrize("case", CASES + ["split", "cross_class", "mesh"])
def test_exit_and_split_walk_matches_plain_on_card(cuda_device, case,
                                                   split_rows):
    """csr6_raster (binned triangles on the mesh soup) with its z-bucket
    exit on and off, its tiles cut into items of ``split_rows`` rows, ==
    the plain walk bit for bit; ``walked`` is every tile's row count with
    the exit off and at most that with it on."""
    soup, (w, h) = _exit_case(case, cuda_device)
    tri = case == "mesh"
    b = csr6.bin_csr6(soup, w, h, 1 << 14, bin_triangles=tri, with_z=True)
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args = (csr6.build_table16(soup, zeros, zeros[:, 0], bin_triangles=tri),
            b["order"], b["starts"], b["big_ids"], b["big_n"], w, h, tri)
    want = csr6.raster_tiles_plain(*args)
    rows = csr6.tile_rows(b["starts"], w, h)
    tiles_x, tiles_y = csr6.grid_shape(w, h)
    for zmeta in (None, b["zmeta"]):
        walked = torch.full((tiles_x * tiles_y,), -1, dtype=torch.int32,
                            device=cuda_device)
        got = csr6.raster_tiles(*args, zmeta=zmeta, walked=walked,
                                split_rows=split_rows)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got[1].cpu().numpy(),
                                      want[1].cpu().numpy())
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        if zmeta is None:
            assert torch.equal(walked, rows)
        else:
            assert bool(((walked >= 0) & (walked <= rows)).all())
    if case == "cross_class" and split_rows == csr6.SPLIT_ROWS:
        # One item: the big disc (depth 1) sets the tile's depths, and the
        # far discs' segment (depth 5-6) is left after its first chunk.
        assert int(walked[2 * tiles_x + 2]) < int(rows[2 * tiles_x + 2])


@pytest.mark.cuda
@pytest.mark.parametrize("span", [2, 4, 8])
@pytest.mark.parametrize("case", ["split", "dense_tile", "spill"])
def test_cap10_split_matches_plain_on_card(cuda_device, case, span):
    """csr6_cap10 with its tiles cut into items of 64 rows == its plain
    version bit for bit, ``walked`` every tile's row count."""
    soup, (w, h) = _exit_case(case, cuda_device)
    b = csr6.bin_csr6(soup, w, h, 1 << 14, span=span)
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    args = (csr6.build_table10(soup), csr6.build_table16_rows(
        soup, zeros, zeros[:, 0], b["big_ids"]), b["order"], b["starts"],
        b["big_n"], w, h, span)
    tiles_x, tiles_y = csr6.grid_shape(w, h)
    walked = torch.full((tiles_x * tiles_y,), -1, dtype=torch.int32,
                        device=cuda_device)
    got = csr6.raster_tiles_cap10(*args, walked=walked, split_rows=64)
    want = csr6.raster_tiles_cap10_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(walked, csr6.tile_rows(b["starts"], w, h, span))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["traj_ball", "mesh"])
def test_default_exit_frames_equal_exit_off_on_card(cuda_device, case):
    """render_shaded_csr6 by the JAX policy (the exit on) == allow_exit
    False bit for bit (rgb, depth, index), one csr6_raster launch each."""
    mesh = case == "mesh"
    cam = tcam(device=cuda_device)
    if mesh:
        soup = mesh_soup(tcam()).to(cuda_device)
    else:
        pos, vel = cloud()
        cam = pipeline.frame_camera(PRESETS["traj_ball"], 120, W, H,
                                    cuda_device)
        soup = pipeline.build_primitives(
            PRESETS["traj_ball"], cam, torch.tensor(pos, device=cuda_device),
            torch.tensor(vel, device=cuda_device), 120)
    wrapper = csr6.raster_tiles_tri if mesh else csr6.raster_tiles
    before = wrapper.launches
    outs = [csr6.render_shaded_csr6(soup, cam, ShadingConfig(),
                                    allow_exit=allow, bin_triangles=mesh)
            for allow in (None, False)]
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
