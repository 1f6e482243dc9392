"""The port on an NVIDIA GPU: the CUDA kernels (csr6 16-float rows at
spans 2, 4 and 8, with and without binned triangles, 10-float cap_rows10
rows, 8-float disc rows, disc rows with the fused (u, v), kind-split
9-float rows; the v4 walk with and without its z-bucket early exit; the
v3 disc fast path with and without its exit; the v1 and v2 strip walks,
16-float and 8-float disc rows, with their saturation exit; the v5
chunk-binned disc walk, with and without its exit and its fused shade;
the disc rows at spans 4 and 8; the 16-, 10-, 9- and 8-float walks, the
v1 and v2 strip walks and the v3 walk with their tiles split into work
items (v1 also with ties across them),
the 16-float walk and the disc walk with their z-bucket exit, the disc
walks', v3's and v2's disc cull on discs tangent to their bands and
column segments, v3's exact ties across work items; the v4 walk's split
with and without its exit and binned triangles; the v5 walks' split and
warp cull at every tile shape, fused and not, on discs tangent to the
warp blocks' edges, with ties across work items; the v1 walk over the
shadow map's capped strips) against their plain PyTorch versions, and
frames and flythroughs (traj_ball, the disc lane, traj's history trails,
the pallas backend, the look passes, the stream's pallas6, pallas (v4)
and tiled backends on disc and trail chunks) rendered on the card against
the same on the CPU, a stream fed by a generator that holds the card
against its monolithic render (the staging slots' reuse; the discs_only,
default v6, cap_rows10, v4 and tiled walks), the sharded frame on a
world of one rank against the card's single-device frame, and the v6
walks on the adaptive trail soup with and without a row_budget that cuts
its binned rows.  Every test
here needs a card (marker ``cuda``) and skips without one.  The file imports no jax, so it also runs on a machine that
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
from pointcloud_render_tpu_torch.parallel.streaming import StreamingRasterizer
from pointcloud_render_tpu_torch.raster import (
    csr,
    csr2,
    csr3,
    csr4,
    csr5,
    csr6,
    tiles,
)
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives
from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.run.trajectory import TrajectoryScanRenderer
from pointcloud_render_tpu_torch.shading import shadow
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
    adaptive_soup,
    band_soup,
    block_soup,
    cloud,
    cross_class_soup,
    disc_soup,
    droplet_soup,
    make_soup,
    mesh_soup,
    morton_soup,
    segment_soup,
    split_soup,
    tcam,
    tie_tile_soup,
    trail_soup_fn,
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


def _check_split_strips(soup, tile_h, tile_w, wrapper=csr2.raster_tiles2,
                        splits=(csr6.SPLIT_ROWS, 64), no_triangles=False):
    """A 16-float strip walk (csr2_raster, or csr1_raster through
    ``wrapper``; max_tiles_per_prim 8, triangles forced onto the big list
    under ``no_triangles``) with its exit off and on, at each of
    ``splits`` rows per work item, == the plain strip walk; one launch a
    call; ``walked`` is every row times the passes with the exit off, at
    most that with it on -> (the plain walk's (depth, index), the
    binning)."""
    b = csr.bin_csr(soup, W, H, tile_h, tile_w, max_tiles_per_prim=8,
                    force_tri_big=no_triangles)
    n = int(b["starts"][-1])
    args = (csr.pack_rows_generic(soup, b["prims"][:n], b["keys"][:n],
                                  b["zmin"], b["span"]),
            b["starts"], csr.pack_big_rows(soup, b["big_ids"]), b["big_n"],
            W, H, tile_h, tile_w, no_triangles)
    want = csr.raster_strips_plain(*args)
    lengths = (b["starts"][1:] - b["starts"][:-1]) * -(-tile_h * tile_w
                                                       // 1024)
    for allow_exit in (False, True):
        for split_rows in splits:
            walked = torch.full_like(lengths, -1)
            before = wrapper.launches
            got = wrapper(*args, walked=walked, allow_exit=allow_exit,
                          split_rows=split_rows)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            for a, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(_bits(a), _bits(w))
            if allow_exit:
                assert bool(((walked >= 0) & (walked <= lengths)).all())
            else:
                assert torch.equal(walked, lengths)
    assert bool((want[1] >= 0).any())
    return want, b


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


# csr1_raster's split walk (v1, max_tiles_per_prim 8): items of 1, 7 and
# 64 rows (many items per dense strip, ties across them) and the default;
# strips of 8x128 (one pass) and 16x256 (four passes of 1024 pixels).
V1_SPLITS = (1, 7, 64, csr6.SPLIT_ROWS)
V1_STRIPS = {"8x128": (8, 128), "16x256": (16, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("strip", sorted(V1_STRIPS))
@pytest.mark.parametrize("no_triangles", [False, True])
@pytest.mark.parametrize("case", CASES + ["disc_ties", "tie_tile"])
def test_v1_split_matches_plain_on_card(cuda_device, case, no_triangles,
                                        strip):
    """csr1_raster on the split walk, with binned triangles and without,
    its exit off and on, at items of 1, 7, 64 rows and the default ==
    the plain strip walk bit for bit; ``walked`` every strip's rows times
    its passes with the exit off, at most that with it on.  On the tie
    soup 48 identical discs share one strip's run, cut across many items
    and in front of a cover that lets the exit leave the deep rows: the
    first copy (id 0) wins their pixels."""
    soup = {"disc_ties": lambda: disc_soup(tcam()),
            "tie_tile": tie_tile_soup}.get(case, lambda: make_soup(case))()
    th, tw = V1_STRIPS[strip]
    want, b = _check_split_strips(soup.to(cuda_device), th, tw,
                                  csr.raster_tiles1, V1_SPLITS,
                                  no_triangles)
    if case == "tie_tile":
        tiles_x, _ = csr.strip_grid(W, H, th, tw)
        tile = (41 // th) * tiles_x + 40 // tw
        assert int(b["starts"][tile + 1] - b["starts"][tile]) > 48
        assert int(want[1][41, 40]) == 0 and float(want[0][41, 40]) == 0.5


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


def _v3_args(soup, device):
    b = csr3.bin_csr_2x2(soup, W, H, max_big=1 << 14)
    zeros = torch.zeros((soup.count, 3), device=device)
    rows = csr3.pack_rows8(soup, b["entries"], b["big_ids"], zeros,
                           zeros[:, 0], (0.0, 0.0, 0.0))
    return (rows[:b["entries"].shape[0]], csr6.build_table16_rows(
        soup, zeros, zeros[:, 0], b["big_ids"]), b["starts"], b["big_n"],
        b["zmeta"], W, H, b["zq_bits"]), b


def _check_v3_split(args, split_rows, blocks=(csr3.EXIT_BLOCK, 5)):
    """csr3_raster with its tiles cut into items of ``split_rows`` rows,
    exit off and on (at each of ``blocks``) == raster_tiles3_plain bit
    for bit (depth, entry image); one launch a call; ``walked`` every
    tile's run and ``bands`` band_rows3 with the exit off, at most those
    with it on."""
    starts = args[2]
    lengths = starts[1:] - starts[:-1]
    kept = csr3.band_rows3(args[0], starts, W, H)
    want = csr3.raster_tiles3_plain(*args)
    for exit_on, block in [(False, csr3.EXIT_BLOCK)] + [
            (True, k) for k in blocks]:
        walked = torch.full_like(lengths, -1)
        bands = torch.full_like(lengths, -1)
        before = csr3.raster_tiles3.launches
        got = csr3.raster_tiles3(*args, walked=walked, bands=bands,
                                 allow_exit=exit_on, block=block,
                                 split_rows=split_rows)
        torch.cuda.synchronize()
        assert csr3.raster_tiles3.launches == before + 1
        for a, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(_bits(a), _bits(w))
        if exit_on:
            assert bool(((walked >= 0) & (walked <= lengths)).all())
            assert bool(((bands >= 0) & (bands <= kept)).all())
        else:
            assert torch.equal(walked, lengths)
            assert torch.equal(bands, kept)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("split_rows", [1, 7, 64])
@pytest.mark.parametrize("case", CASES + ["disc_ties", "band"])
def test_v3_split_cull_matches_plain_on_card(cuda_device, case, split_rows):
    """csr3_raster's split walk (items of 1, 7 and 64 rows: many items per
    dense tile, exact ties across them), its warp-band cull (band_soup:
    discs tangent to the bands, centred on band boundaries, over the
    ragged bottom band) and its exit at blocks of 128 and 5 entries ==
    the plain walk bit for bit."""
    soup = {"disc_ties": lambda: disc_soup(tcam()),
            "band": band_soup}.get(case, lambda: make_soup(case))()
    args, _ = _v3_args(soup.to(cuda_device), cuda_device)
    want = _check_v3_split(args, split_rows)
    assert bool((want[1] != csr3.IMAX).any())


@pytest.mark.cuda
@pytest.mark.parametrize("split_rows", [1, 7])
def test_v3_tie_across_items_on_card(cuda_device, split_rows):
    """48 identical discs in one tile, their entries cut across many work
    items, in front of a cover that lets the exit leave the tile's deep
    entries: the lowest entry (the first copy, id 0) wins its pixels with
    the exit on and off, as on the plain walk."""
    soup = tie_tile_soup().to(cuda_device)
    args, b = _v3_args(soup, cuda_device)
    tiles_x, _ = csr6.grid_shape(W, H)
    tile = tiles_x + 1
    run = int(b["starts"][tile + 1] - b["starts"][tile])
    assert run > 48
    want = _check_v3_split(args, split_rows)
    ids = csr3.resolve_ids(want[1], want[0], b["entries"], b["big_ids"])
    assert int(ids[41, 40]) == 0 and float(want[0][41, 40]) == 0.5
    assert int(want[1][41, 40]) == int(b["starts"][tile])


# Strip shapes of csr2_disc8's split walk (16x256: four passes of 1024
# pixels per strip; 4x32: one warp of pixels per strip) and their
# max_tiles_per_prim.
DISC_STRIPS = {"8x128": (8, 128, 4), "16x256": (16, 256, 8),
               "4x32": (4, 32, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("strip", sorted(DISC_STRIPS))
@pytest.mark.parametrize("case", CASES + ["disc_ties", "band", "segment"])
def test_v2_disc8_split_cull_matches_plain_on_card(cuda_device, case, strip):
    """csr2_disc8's split walk (items of 1, 7 and 64 rows and the
    default), its warp cull (discs tangent to the warps' column and row
    boundaries) and its saturation exit == the plain strip walk bit for
    bit; one launch a call; ``walked`` every strip's rows times its
    passes and ``bands`` csr.segment_rows with the exit off, at most
    those with it on."""
    th, tw, mtp = DISC_STRIPS[strip]
    soup = {"disc_ties": lambda: disc_soup(tcam()), "band": band_soup,
            "segment": segment_soup}.get(case, lambda: make_soup(case))()
    soup = soup.to(cuda_device)
    b = csr.bin_csr(soup, W, H, th, tw, mtp, force_tri_big=True,
                    force_capsule_big=True)
    n = int(b["starts"][-1])
    args = (csr2.pack_rows_disc(soup, b["prims"][:n], b["keys"][:n],
                                b["zmin"], b["span"]),
            b["starts"], csr.pack_big_rows(soup, b["big_ids"]), b["big_n"],
            W, H, th, tw)
    want = csr.raster_strips_plain(*args)
    lengths = (b["starts"][1:] - b["starts"][:-1]) * -(-th * tw // 1024)
    kept = csr.segment_rows(args[0], b["starts"], W, H, th, tw)
    for split_rows in (1, 7, 64, csr2.SPLIT_ROWS_DISC):
        for allow_exit in (False, True):
            walked = torch.full_like(lengths, -1)
            bands = torch.full_like(lengths, -1)
            before = csr2.raster_tiles2_disc8.launches
            got = csr2.raster_tiles2_disc8(*args, walked=walked,
                                           allow_exit=allow_exit,
                                           bands=bands,
                                           split_rows=split_rows)
            torch.cuda.synchronize()
            assert csr2.raster_tiles2_disc8.launches == before + 1
            for a, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(_bits(a), _bits(w))
            if allow_exit:
                assert bool(((walked >= 0) & (walked <= lengths)).all())
                assert bool(((bands >= 0) & (bands <= kept)).all())
            else:
                assert torch.equal(walked, lengths)
                assert torch.equal(bands, kept)
    assert bool((want[1] >= 0).any())


# csr4_raster's split walk: items of 1, 7 and 64 rows (many items per
# dense tile, ties across them) and the default.
V4_SPLITS = (1, 7, 64, csr6.SPLIT_ROWS4)


def _v4_soup(case):
    return {"mesh": lambda: mesh_soup(tcam()), "split": split_soup,
            "disc_ties": lambda: disc_soup(tcam()),
            "tie_tile": tie_tile_soup}.get(case, lambda: make_soup(case))()


@pytest.mark.cuda
@pytest.mark.parametrize("bin_triangles", [False, True])
@pytest.mark.parametrize("case", CASES + ["mesh", "split", "disc_ties",
                                          "tie_tile"])
def test_v4_split_walk_matches_plain_on_card(cuda_device, case,
                                             bin_triangles):
    """csr4_raster's split walk (both instances) at items of 1, 7 and 64
    rows and the default, with its z-bucket exit on and off, on the whole
    entries and on entries cut to 2/3 by an entry capacity ==
    raster_tiles4_plain bit for bit; one launch a call; ``walked`` every
    tile's entries with the exit off, at most those with it on.  On the
    tie soup the lowest of 48 identical discs, their entries cut across
    many items, wins its pixels."""
    soup = _v4_soup(case).to(cuda_device)
    zeros = torch.zeros((soup.count, 3), device=cuda_device)
    table = csr6.build_table16(soup, zeros, zeros[:, 0],
                               bin_triangles=bin_triangles)
    b = csr4.bin_csr4(soup, W, H, 1 << 14, bin_triangles)
    true = int(b["starts"][-1])
    for cap in (None, true * 2 // 3):
        entries, starts = b["entries"], b["starts"]
        if cap is not None:
            entries, starts = entries[:cap], torch.clamp(starts, max=cap)
        lengths = starts[1:] - starts[:-1]
        for zq in (b["zq_bits"], 0):  # the early exit on, then off
            args = (table, entries, starts, b["big_ids"], b["big_n"],
                    b["zmeta"], W, H, zq, bin_triangles)
            want = csr4.raster_tiles4_plain(*args)
            for split_rows in V4_SPLITS:
                walked = torch.full_like(lengths, -1)
                before = csr4.raster_tiles4.launches
                got = csr4.raster_tiles4(*args, walked=walked,
                                         split_rows=split_rows)
                torch.cuda.synchronize()
                assert csr4.raster_tiles4.launches == before + 1
                for a, w in zip(got, want, strict=True):
                    np.testing.assert_array_equal(_bits(a), _bits(w))
                if zq:
                    assert bool(((walked >= 0) & (walked <= lengths)).all())
                else:
                    assert torch.equal(walked, lengths)
            assert bool((want[1] >= 0).any())
            if case == "tie_tile" and cap is None:
                assert int(want[1][41, 40]) == 0
                assert float(want[0][41, 40]) == 0.5


# The v5 walks' split: items of 1, 7 and 64 rows and the default; every
# tile shape the kernels admit.
V5_SPLITS = (1, 7, 64, csr6.SPLIT_ROWS5)
V5_TILES = ((64, 16), (32, 32), (16, 64), (8, 128))


def _v5_split_soup(case, device):
    if case.startswith("v5_"):
        return v5_soups(device)[case[3:]]
    return {"block": lambda: block_soup().to(device),
            "block_morton": lambda: morton_soup(block_soup().to(device)),
            "band_morton": lambda: morton_soup(band_soup().to(device)),
            "tie_tile": lambda: tie_tile_soup().to(device)}[case]()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", V5_TILES)
@pytest.mark.parametrize("case", ["v5_sorted", "v5_mixed", "block",
                                  "block_morton", "band_morton", "tie_tile"])
def test_v5_split_cull_matches_plain_on_card(cuda_device, case, tile):
    """csr5_raster and csr5_shaded (with and without uniform) at items of
    1, 7 and 64 rows and the default, with the exit on and off, at every
    tile shape == raster_tiles5_plain bit for bit (depth, index, rgb); one
    launch a call; ``walked`` every tile's run and ``bands`` block_slots5
    with the exit off, at most those with it on: the warp cull on discs
    tangent to the warp blocks' edges (block_soup), in singleton rows and
    in chunk superrows, and ties across items (48 identical discs in
    three superrows: the lowest id wins)."""
    th, tw = tile
    soup = _v5_split_soup(case, cuda_device)
    cam = tcam(device=cuda_device)
    b = csr5.bin_chunks5(soup, W, H, th, tw)
    assert int(b["diag"]["big_overflow"]) == 0
    rgb_p, _ = csr6.preshade(soup, cam, ShadingConfig())
    tab, bp, kinds, meta = csr5.tables5(
        soup, b, rgb_p, csr5.look5(soup, cam, ShadingConfig(),
                                   (0.3, 0.3, 0.3)))
    args = (tab, b["chunks"], b["starts"], bp, kinds, b["big_n"], meta, W, H,
            th, tw)
    lengths = b["starts"][1:] - b["starts"][:-1]
    kept = csr5.block_slots5(tab, b["chunks"], b["starts"], W, H, th, tw)
    for fn, kw in ((csr5.raster_tiles5, {}),
                   (csr5.raster_tiles5_shaded, {}),
                   (csr5.raster_tiles5_shaded, {"uniform": True})):
        want = csr5.raster_tiles5_plain(
            *args, fused=fn is csr5.raster_tiles5_shaded, **kw)
        for split_rows in V5_SPLITS:
            for exit_on in (True, False):
                walked = torch.full_like(lengths, -1)
                bands = torch.full_like(lengths, -1)
                before = fn.launches
                got = fn(*args, allow_exit=exit_on, walked=walked,
                         bands=bands, split_rows=split_rows, **kw)
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                for a, w in zip(got, want, strict=True):
                    np.testing.assert_array_equal(_bits(a), _bits(w))
                if exit_on:
                    assert bool(((walked >= 0) & (walked <= lengths)).all())
                    assert bool(((bands >= 0) & (bands <= kept)).all())
                else:
                    assert torch.equal(walked, lengths)
                    assert torch.equal(bands, kept)
        assert bool((want[1] >= 0).any())
    if case == "tie_tile" and tile == (32, 32):
        assert int(want[1][41, 40]) == 0


def _capped_soups(device):
    """Soups for the shadow map's capped strips: the traj_ball light view
    of 1,500 points at 64x64 (thousands of entries past 1,024 per strip)
    and of 300 points at 128x128, and the tests' mixed soup cut at 32 per
    strip and 1 big prim, with the strip grid of each."""
    light = shadow.light_camera(size=64, device=device)
    pos, vel = cloud(n=1500, seed=3)
    dense = pipeline.build_primitives(PRESETS["traj_ball"], light, pos, vel,
                                      120)
    light128 = shadow.light_camera(size=128, device=device)
    pos, vel = cloud()
    sparse = pipeline.build_primitives(PRESETS["traj_ball"], light128, pos,
                                       vel, 120)
    return {"light64": (dense, 64, 64, 1024, 64),
            "light128": (sparse, 128, 128, 1024, 64),
            "mixed_cut": (make_soup("mixed").to(device), W, H, 32, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["light64", "light128", "mixed_cut"])
def test_capped_strips_v1_matches_plain_on_card(cuda_device, case):
    """csr1_raster over tiles.bin_primitives' capped strips (the shadow
    map's raster), its exit off and on, at items of 1, 7, 64 rows and the
    default == the plain strip walk bit for bit; rasterize_tiled launches
    it once and equals its CPU run (depth bits, index, dropped entries)."""
    soup, w, h, cap, big = _capped_soups(cuda_device)[case]
    bins = tiles.bin_primitives(soup, w, h, max_per_tile=cap, max_big=big)
    args = tiles.strip_rows(soup, bins)
    want = csr.raster_strips_plain(*args, w, h)
    for allow_exit in (False, True):
        for split_rows in V1_SPLITS:
            before = csr.raster_tiles1.launches
            got = csr.raster_tiles1(*args, w, h, allow_exit=allow_exit,
                                    split_rows=split_rows)
            torch.cuda.synchronize()
            assert csr.raster_tiles1.launches == before + 1
            for a, b in zip(got, want, strict=True):
                np.testing.assert_array_equal(_bits(a), _bits(b))
    before = csr.raster_tiles1.launches
    on_card = tiles.rasterize_tiled(soup, w, h, max_per_tile=cap,
                                    max_big=big)
    on_cpu = tiles.rasterize_tiled(soup.to(torch.device("cpu")), w, h,
                                   max_per_tile=cap, max_big=big)
    assert csr.raster_tiles1.launches == before + 1
    for a, b in zip(on_card[:2], on_cpu[:2], strict=True):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(on_card[2]["dropped"]) == int(on_cpu[2]["dropped"])
    assert (int(on_cpu[2]["dropped"]) > 0) == (case != "light128")
    assert bool((want[1] >= 0).any())


@pytest.mark.cuda
def test_look_frame_on_card_equals_cpu(cuda_device):
    """traj_ball at 160x96 with every look pass (ss 2, the shadow map at
    128, ground_spec 0.5, gi 0.25): the card's frame == the CPU's bit for
    bit (rgb, depth, index), one csr1_raster launch per frame (the shadow
    map)."""
    pcl = np.concatenate(cloud(), axis=1)
    cfg = RasterConfig(supersample=2, shading=ShadingConfig(
        shadows=True, shadow_size=128, ground_spec=0.5, gi=0.25))
    pipes = [pipeline.FramePipeline(PRESETS["traj_ball"], cfg, width=160,
                                    height=96, device=dev)
             for dev in ("cpu", cuda_device)]
    for fi in (10, 120, 205):
        before = csr.raster_tiles1.launches
        fbs = [p.render_array(pcl, fi) for p in pipes]
        torch.cuda.synchronize()
        assert csr.raster_tiles1.launches == before + 1
        for field in ("index", "depth", "rgb"):
            np.testing.assert_array_equal(
                getattr(fbs[0], field).numpy().view(np.int32),
                getattr(fbs[1], field).cpu().numpy().view(np.int32))


STREAM_FILM = (256, 64)
STREAM_KERNELS = {"pallas6": csr6.raster_tiles, "pallas": csr4.raster_tiles4,
                  "tiled": csr.raster_tiles1}


def _stream(device, backend, scene):
    w, h = STREAM_FILM
    cam = tcam(w, h, device=device)
    rng = np.random.default_rng(17)
    pos = rng.uniform(-0.4, 0.4, (600, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (600, 3)).astype(np.float32)
    vel = (rng.normal(size=(600, 3)) * 2).astype(np.float32)
    kw = dict(chunk_points=256, radius_world=0.02, backend=backend,
              entry_capacity=1 << 16, device=device)
    if scene == "trail":
        kw.update(soup_fn=trail_soup_fn(cam, 0.01), max_big=4096)
        chunks = [(pos[k:k + 256], colors[k:k + 256], vel[k:k + 256])
                  for k in range(0, 600, 256)]
    else:
        chunks = [(pos[k:k + 256], colors[k:k + 256])
                  for k in range(0, 600, 256)]
    return StreamingRasterizer(cam, **kw).rasterize(chunks,
                                                    return_attrs=True)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["disc", "trail"])
@pytest.mark.parametrize("backend", ["pallas6", "pallas", "tiled"])
def test_stream_on_card_equals_cpu(cuda_device, backend, scene):
    """Each streaming backend's card stream (three chunks, the last short)
    == its CPU stream bit for bit (depth, index, attributes), its kernel
    launched once per chunk."""
    kernel = STREAM_KERNELS[backend]
    before = kernel.launches
    on_card = _stream(cuda_device, backend, scene)
    torch.cuda.synchronize()
    assert kernel.launches == before + 3
    on_cpu = _stream(torch.device("cpu"), backend, scene)
    for a, b in zip(on_card, on_cpu, strict=True):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert bool((on_cpu[1] >= 0).any())


# The walks held to their monolithic render while the host waits for a
# staging slot (ROADMAP C7): the discs_only walk on disc chunks, and the
# default v6 walk, cap_rows10, v4 and the capped tiled walk on trail chunks.
C7_WALKS = {
    "discs_only": dict(config=RasterConfig(discs_only=True)),
    "trail": dict(config=RasterConfig()),
    "cap_rows10": dict(config=RasterConfig(span=4, cap_rows10=True)),
    "pallas": dict(backend="pallas"),
    "tiled": dict(backend="tiled"),
}
# The walks whose chunk loop never lets the host run two chunks ahead of
# the card, which a staging wait needs: a trail chunk queues hundreds of
# small kernels (the soup build alone), CUDA's launch queue fills behind
# the spin and the next launch holds the host (a 0.5 s spin per chunk
# changes nothing); the tiled walk also synchronises in its binning.
# Their staging_waits stay 0, and their streams still equal the
# monolithic renders.
C7_HOST_HELD = {"trail", "cap_rows10", "pallas", "tiled"}


def _c7_monolithic(walk, soup, w, h):
    """The whole stream's soup through the stream's walk.  The tiled
    walk's caps are per soup, so the monolithic soup takes a table large
    enough to drop nothing (each chunk's soup drops nothing at the
    defaults, which the test checks)."""
    if walk == "pallas":
        d, i, diag = csr4.rasterize_csr4(soup, w, h, max_big=1 << 14)
        assert int(diag["big_overflow"]) == 0
    elif walk == "tiled":
        d, i, diag = tiles.rasterize_tiled(soup, w, h, max_per_tile=1 << 14,
                                           max_big=1 << 14)
        assert int(diag["dropped"]) == 0
    else:
        cfg = C7_WALKS[walk]["config"]
        d, i, diag = csr6.rasterize_csr6(
            soup, w, h, max_big=1 << 14, discs_only=cfg.discs_only,
            span=cfg.span, cap_rows10=cfg.cap_rows10)
        assert int(diag["big_overflow"]) == 0
    return d, i


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(C7_WALKS))
def test_stream_from_generator_equals_monolithic_on_card(cuda_device, walk):
    """Six chunks of distinct points from a generator that holds the card
    (a spin of ~0.05 s before each chunk), so that the host may run ahead
    of the copies and wait before it refills a staging slot: the stream
    == the monolithic render of the six chunk soups, concatenated, bit
    for bit.  A slot refilled before its last copy, or read after its
    next one, renders another chunk's points.  Disc chunks through the
    discs_only walk, where the host waits for a slot; trail chunks
    (``trail_soup_fn``) through the default v6 walk, cap_rows10, v4 and
    the capped tiled walk, where it never does (C7_HOST_HELD)."""
    w, h = STREAM_FILM
    cam = tcam(w, h, device=cuda_device)
    rng = np.random.default_rng(23)
    pos = rng.uniform(-0.5, 0.5, (1200, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (1200, 3)).astype(np.float32)
    vel = (rng.normal(size=(1200, 3)) * 2).astype(np.float32)
    discs = walk == "discs_only"
    kw = dict(C7_WALKS[walk], max_big=4096)
    if not discs:
        kw["soup_fn"] = trail_soup_fn(cam, 0.01)

    def part(k):
        s = slice(200 * k, 200 * (k + 1))
        return pos[s] if discs else (pos[s], colors[s], vel[s])

    def chunks():
        for k in range(6):
            torch.cuda._sleep(100_000_000)
            yield part(k)
    sr = StreamingRasterizer(cam, chunk_points=200, radius_world=0.02,
                             device=cuda_device, **kw)
    depth, index = sr.rasterize(chunks())
    soups = []
    for k in range(6):
        c = part(k)
        if discs:
            c = (c, np.broadcast_to(sr.color, (200, 3)))
        soup, _ = sr.build_soup(*(torch.tensor(np.asarray(a),
                                               device=cuda_device)
                                  for a in (c[0], c[1])),
                                tuple(torch.tensor(e, device=cuda_device)
                                      for e in c[2:]))
        if walk == "tiled":
            assert int(tiles.tile_overflow(soup, w, h)) == 0
        soups.append(soup)
    want = _c7_monolithic(walk, ScreenPrimitives.concatenate(soups), w, h)
    print(f"[C7] walk {walk}: staging_waits {sr.staging_waits} of 6 chunks")
    np.testing.assert_array_equal(_bits(depth), _bits(want[0]))
    np.testing.assert_array_equal(_bits(index), _bits(want[1]))
    assert int(index.max()) >= 5 * sr.prims_per_chunk
    assert (sr.staging_waits == 0) == (walk in C7_HOST_HELD), (
        f"staging_waits {sr.staging_waits} on the {walk} walk: C7_HOST_HELD "
        "lists the walks whose chunk loop never lets the host run ahead of "
        "the copies")


SHARDED_KERNELS = {"pallas6": csr6.raster_tiles, "pallas4": csr4.raster_tiles4,
                   "tiled": csr.raster_tiles1}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", list(SHARDED_KERNELS))
def test_sharded_world_of_one_equals_frame_on_card(cuda_device, backend):
    """render_scene_point_sharded on a world of one rank on the card (NCCL
    where present) == FramePipeline's frame on the same backend bit for
    bit (rgb, depth, index), one launch of the backend's kernel."""
    import torch.distributed as dist

    from pointcloud_render_tpu_torch.parallel import multihost
    from pointcloud_render_tpu_torch.parallel import render_parallel as rp

    pos, vel = cloud()
    cfg = RasterConfig(backend=backend)
    kernel = SHARDED_KERNELS[backend]
    multihost.initialize()
    try:
        before = kernel.launches
        out = rp.render_scene_point_sharded(
            PRESETS["traj_ball"], pos, cfg, rp.make_render_mesh(1, 1),
            velocities=vel, frame_index=120, width=160, height=96)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
    finally:
        dist.destroy_process_group()
    assert int(out.overflow) == 0
    fb = pipeline.FramePipeline(PRESETS["traj_ball"], cfg, width=160,
                                height=96, device=cuda_device).render_array(
        np.concatenate([pos, vel], axis=1), 120)
    for field in ("index", "depth", "rgb"):
        np.testing.assert_array_equal(_bits(getattr(out, field)),
                                      _bits(getattr(fb, field)))


@pytest.mark.cuda
def test_stream_camera_on_another_device_raises(cuda_device):
    with pytest.raises(ValueError, match="stream's device"):
        StreamingRasterizer(tcam(), chunk_points=10, radius_world=0.01,
                            device=cuda_device)


# The v6 walks on the adaptive trail soup: (kernel wrapper, knobs).
ADAPTIVE_WALKS = {
    "rows16_exit": (csr6.raster_tiles, dict()),
    "rows16_exit_off": (csr6.raster_tiles, dict(allow_exit=False)),
    "rows16_span4": (csr6.raster_tiles, dict(span=4)),
    "cap_rows10": (csr6.raster_tiles_cap10, dict(cap_rows10=True, span=4)),
    "rows9": (csr6.raster_tiles_rows9, dict(rows9=True, span=4)),
    "discs_only": (csr6.raster_tiles_disc8, dict(discs_only=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("walk", sorted(ADAPTIVE_WALKS))
def test_adaptive_and_cut_soups_match_plain_on_card(cuda_device, walk, cut):
    """Each v6 kernel on the adaptive trail soup built on the card, without
    a row_budget and with one at half the binned rows (the rows past it
    read the pad row), == its plain version on the same inputs bit for
    bit, one launch; the same row_overflow."""
    soup, _, _ = adaptive_soup(device=cuda_device)
    wrapper, kw = ADAPTIVE_WALKS[walk]
    budget = None
    if cut:
        _, n_small = csr6.bin_diagnostics6(
            soup, W, H, span=kw.get("span", 2),
            discs_only=kw.get("discs_only", False),
            kind_split=kw.get("rows9", False), return_binned=True)
        budget = int(n_small) // 2
    before = wrapper.launches
    got = csr6.rasterize_csr6(soup, W, H, row_budget=budget, **kw)
    want = csr6.rasterize_csr6(soup, W, H, row_budget=budget, plain=True,
                               **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(got[2]["row_overflow"]) == int(want[2]["row_overflow"])
    assert (int(got[2]["row_overflow"]) > 0) == cut
