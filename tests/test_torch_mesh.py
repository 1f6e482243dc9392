"""The mesh-LOD droplet slice of the port (binned triangles in the v6 walk,
the v4 walk of ``raster/csr4.py``), held against the JAX package on the
CPU.

* ``z_lower_bound(with_triangles=True)`` and ``build_table16(
  bin_triangles=True)`` are bit-equal to the JAX functions op by op.
* ``bin_csr4`` against ``pallas_csr4._bin_csr4`` op by op: starts, the
  (key, prim id) pairs (so every (tile, bucket) run holds the same set of
  prims in either unstable order), the big list, zmeta,
  ``true_entry_count4`` and ``bin_diagnostics4``; ``bin_csr6(
  bin_triangles=True)`` against ``_bin_csr6``'s ranges.
* Both plain walks against ``cpu_reference``: winners equal, disc and
  capsule depth bit-equal, triangle depth within TRI_DEPTH_RTOL (the JAX
  package's own bound for binned triangles); v6 plain == v4 plain bit for
  bit; the triangle windows of the plain walk are sound.
* The mesh-LOD soup: its triangles bit-equal to the JAX builders op by op
  given the same rotations, its layout equal to the JAX build's.
* A 160x96 mesh-LOD ``FramePipeline`` frame against the jitted JAX
  FramePipeline (tiled, its own rotations) within MESH_FLIPS,
  MESH_DEPTH_ULP and RGB_ATOL; ``auto`` == ``pallas4`` there.
* ``entry_capacity`` truncation, the pipelines' capacity error, the 2^24
  guard, and the validations that still raise.
The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.geometry import droplet as jdroplet
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr4 as jcsr4
from pointcloud_render_tpu.raster import pallas_csr6 as jcsr6
from pointcloud_render_tpu.raster import primitives as jprims
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.scene.camera import TARGETS
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import rotation
from pointcloud_render_tpu_torch.raster import csr4, csr6
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.run.trajectory import (
    TrajectoryScanRenderer,
    srgb_encode_u8,
)
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import jax_soup, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import H, W, cloud, make_soup, mesh_soup, tcam

FI = 120
FW, FH = 160, 96
# Triangle depth against the NumPy oracle, relative: the JAX package's
# bound for binned triangles (test_csr_v2_v3.py, edge-function
# cancellation near edges); winners are exact.
TRI_DEPTH_RTOL = 5e-5
# The mesh-LOD frame against the jitted JAX FramePipeline (tiled on CPU,
# its own rotations, which differ by ROADMAP queue C's "Batch rotations"):
# the droplets' vertices move by ulps, and the inverse-depth plane of a
# sub-pixel triangle amplifies that (measured: 0 flips, 4352 ulp, rgb
# 3.0e-6).
MESH_FLIPS = 4
MESH_DEPTH_ULP = 1 << 14
RGB_ATOL = 3e-5


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.fixture(scope="module")
def soup():
    return mesh_soup(tcam())


def test_z_lower_bound_and_table16_match_jax(soup):
    rgb, flag = csr6.preshade(soup, tcam(), ShadingConfig())
    js = jax_soup(soup)
    for tri in (False, True):
        with jax.disable_jit():
            jz = jcsr4._z_lower_bound(js, with_triangles=tri)
            jt = jcsr4._build_table16(js, jnp.asarray(rgb.numpy()),
                                      jnp.asarray(flag.numpy()),
                                      bin_triangles=tri)
        np.testing.assert_array_equal(
            _bits(csr6.z_lower_bound(soup, with_triangles=tri).numpy()),
            _bits(jz))
        table = csr6.build_table16(soup, rgb, flag, bin_triangles=tri)
        np.testing.assert_array_equal(_bits(table.numpy()), _bits(jt))
    tri_rows = (soup.kind == 2) & soup.valid
    zlb = csr6.z_lower_bound(soup, with_triangles=True)
    assert bool((zlb[tri_rows] > 0).all())
    # Gathered rows equal the table's at the same ids.
    ids = torch.tensor([0, 5, soup.count - 1, soup.count], dtype=torch.int32)
    np.testing.assert_array_equal(
        csr6.build_table16_rows(soup, rgb, flag, ids,
                                bin_triangles=True).numpy(),
        table.numpy()[ids.numpy()])


@pytest.mark.parametrize("bin_triangles", [False, True])
def test_bin_csr4_matches_jax(soup, bin_triangles):
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    num_tiles = tiles_x * tiles_y
    zq = csr4.zq_bits(num_tiles)
    assert zq == jcsr4._zq_bits(num_tiles) == 4
    assert csr4.zq_bits(60 * 34) == 4  # 1080p
    js = jax_soup(soup)
    with jax.disable_jit():
        keys, prims_sorted, big_list, big_count, zmeta = jcsr4._bin_csr4(
            js, 32, 32, num_tiles, tiles_x, tiles_y, max_big=4,
            bin_triangles=bin_triangles)
        tc = jcsr4.true_entry_count4(js, W, H, bin_triangles=bin_triangles)
        ovf = jcsr4.bin_diagnostics4(js, W, H, max_big=4,
                                     bin_triangles=bin_triangles)
    keys, prims_sorted = np.asarray(keys), np.asarray(prims_sorted)
    b = csr4.bin_csr4(soup, W, H, max_big=4, bin_triangles=bin_triangles)
    np.testing.assert_array_equal(b["keys"].numpy(), keys)
    jstarts = np.searchsorted(keys, np.arange(num_tiles + 1) << zq)
    np.testing.assert_array_equal(b["starts"].numpy(), jstarts)
    # Each (tile, bucket) run holds the same prims in either order.
    ours = np.lexsort((b["entries"].numpy(), keys))
    theirs = np.lexsort((prims_sorted, keys))
    np.testing.assert_array_equal(b["entries"].numpy()[ours],
                                  prims_sorted[theirs])
    big = np.where(np.asarray(big_list) >= 0, np.asarray(big_list),
                   soup.count)
    np.testing.assert_array_equal(b["big_ids"].numpy(), big)
    assert int(b["big_count"]) == int(big_count) > 4
    assert int(b["big_n"][0]) == 4
    np.testing.assert_array_equal(_bits(b["zmeta"].numpy()), _bits(zmeta))
    assert int(b["diag"]["true_entries"]) == int(tc) == int(jstarts[-1])
    assert int(csr4.true_entry_count4(soup, W, H, bin_triangles)) == int(tc)
    assert int(b["diag"]["big_overflow"]) == int(ovf) > 0
    assert int(csr4.bin_diagnostics4(soup, W, H, 4, bin_triangles)) \
        == int(ovf)
    # Buckets ascend inside every tile's run.
    assert (np.diff(keys[:jstarts[-1]]) >= 0).all()
    assert len(np.unique(keys[:jstarts[-1]] & ((1 << zq) - 1))) > 4


def test_bin_csr6_bin_triangles_matches_jax(soup):
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    num_tiles = tiles_x * tiles_y

    @jax.jit
    def jbin(s):
        keys, _, _, big_count, _, n_small = jcsr6._bin_csr6(
            s, 32, 32, num_tiles, tiles_x, tiles_y, max_big=8,
            bin_triangles=True, with_z=False)
        bounds = jnp.arange(num_tiles * 4 + 1, dtype=keys.dtype)
        return (jnp.searchsorted(keys, bounds).astype(jnp.int32), big_count,
                jcsr6.bin_diagnostics6(s, W, H, max_big=8,
                                       bin_triangles=True))

    jstarts, jbig, jovf = (np.asarray(x) for x in jbin(jax_soup(soup)))
    b = csr6.bin_csr6(soup, W, H, 8, bin_triangles=True)
    np.testing.assert_array_equal(b["starts"].numpy(), jstarts)
    assert int(b["big_count"]) == int(jbig)
    assert int(b["diag"]["big_overflow"]) == int(jovf) > 0
    assert int(csr6.bin_diagnostics6(soup, W, H, 8, bin_triangles=True)) \
        == int(jovf)
    # The v6 certificate counts the v4 entries.
    assert int(b["diag"]["true_entries"]) == int(
        csr4.true_entry_count4(soup, W, H, bin_triangles=True))
    # Without bin_triangles the droplets' triangles ride the big list.
    assert int(csr6.bin_csr6(soup, W, H, 8)["big_count"]) > 1000 > int(jbig)


def _v6_plain(s, bin_triangles, w=W, h=H, max_big=1 << 14):
    b = csr6.bin_csr6(s, w, h, max_big, bin_triangles=bin_triangles)
    assert int(b["diag"]["big_overflow"]) == 0
    zeros = torch.zeros((s.count, 3))
    table = csr6.build_table16(s, zeros, zeros[:, 0],
                               bin_triangles=bin_triangles)
    return csr6.raster_tiles_plain(table, b["order"], b["starts"],
                                   b["big_ids"], b["big_n"], w, h,
                                   bin_triangles)


def _v4_plain(s, bin_triangles, w=W, h=H, max_big=1 << 14, cap=None):
    return csr4.rasterize_csr4(s, w, h, entry_capacity=cap,
                               max_big=max_big, bin_triangles=bin_triangles,
                               plain=True)


@pytest.mark.parametrize("case", ["mesh", "near_clip", "mixed"])
def test_plain_walks_match_oracle(soup, case):
    s = soup if case == "mesh" else make_soup(case)
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(s), W, H)
    kind = s.kind.numpy()[np.maximum(i_o, 0)]
    hit = i_o >= 0
    tri = hit & (kind == 2)
    outs = [_v6_plain(s, True), _v4_plain(s, True)[:2],
            _v4_plain(s, False)[:2]]
    for depth, index in outs:
        np.testing.assert_array_equal(index.numpy(), i_o)
        d = depth.numpy()
        np.testing.assert_array_equal(_bits(d)[hit & ~tri],
                                      _bits(d_o)[hit & ~tri])
        rel = np.abs(d[tri] - d_o[tri]) / np.abs(d_o[tri])
        assert rel.max(initial=0.0) <= TRI_DEPTH_RTOL
    for depth, index in outs[1:]:
        np.testing.assert_array_equal(index.numpy(), outs[0][1].numpy())
        np.testing.assert_array_equal(_bits(depth.numpy()),
                                      _bits(outs[0][0].numpy()))
    if case == "mesh":
        ids = i_o[hit]
        kinds = s.kind.numpy()[ids]
        assert (kinds == 0).any() and (kinds == 2).sum() > 1000
        # Binned droplet triangles win (not only the ground and the wide
        # near-clip triangles on the big list), among them tied copies.
        b = csr6.bin_csr6(s, W, H, bin_triangles=True)
        big = set(b["big_ids"][:int(b["big_n"][0])].tolist())
        assert len(set(ids.tolist()) - big) > 300
        assert big & set(ids.tolist()) - set(range(4))


def test_plain_triangle_windows_are_sound(monkeypatch):
    """The plain walk's triangle windows lose no pair: with every
    triangle on its whole rectangle (binned: its tiles; big, as the
    ground and the near-clip triangles: the image) the frames are the
    same."""
    s = mesh_soup(tcam(), n=3, ties=1, near=1, discs=0)
    walks = (lambda: _v6_plain(s, True), lambda: _v4_plain(s, True)[:2])
    want = [walk() for walk in walks]
    monkeypatch.setattr(csr6, "_tri_window", lambda rows, rect: rect)
    for walk, (dw, iw) in zip(walks, want):
        d, i = walk()
        np.testing.assert_array_equal(i.numpy(), iw.numpy())
        np.testing.assert_array_equal(_bits(d.numpy()), _bits(dw.numpy()))
    assert (want[0][1] >= 4).sum() > 100


@pytest.fixture(scope="module")
def mesh_frame_inputs():
    pos, vel = cloud(n=20, seed=3)
    rot = rotation.rotation_matrices_from_velocities(vel, torch.tensor(pos))
    return pos, vel, rot


def test_mesh_soup_matches_jax_build(mesh_frame_inputs):
    """The mesh-LOD soup given the same rotations: the droplets'
    triangles bit-equal to the JAX instancing and triangle builders op by
    op, the layout equal to the JAX build_primitives', the ground and the
    trails the capsule-LOD soup's."""
    pos, vel, rot = mesh_frame_inputs
    preset = PRESETS["traj_vel"]
    cam = pipeline.frame_camera(preset, FI, FW, FH, "cpu")
    soup, layout = pipeline.build_primitives(
        preset, cam, pos, vel, FI, rotations=rot, droplet_lod="mesh",
        return_layout=True)
    n = pos.shape[0]
    f = jdroplet.droplet_mesh()[1].shape[0]
    assert layout == [(4, 0), (n * f, f), (n * f, f), (8 * n, 8)]
    jpreset = JAX_PRESETS["traj_vel"]
    jc = JCamera(origin=jnp.asarray(cam.origin.numpy()),
                 target=np.asarray(TARGETS["traj_vel"], np.float32),
                 fov_x_degrees=jpreset.fov_x_degrees, width=FW, height=FH)
    jlayout = []

    def jbuild(p, v, r):
        s, lay = jpipe.build_primitives(jpreset, jc, p, v, FI, rotations=r,
                                        droplet_lod="mesh",
                                        return_layout=True)
        jlayout[:] = lay
        return s

    jax.eval_shape(jbuild, pos, vel, rot.numpy())  # traces: the layout
    assert jlayout == layout
    with jax.disable_jit():
        verts, faces = jdroplet.instance_droplets(rot.numpy(), None)
        tris = jprims.triangles_from_mesh(
            verts, faces, jc, np.asarray(jpreset.point_color, np.float32))
    ours = convert.soup_to_numpy(soup)
    rows = slice(4, 4 + 2 * n * f)
    for name in ours:
        np.testing.assert_array_equal(
            ours[name][rows].view(np.uint8),
            np.asarray(getattr(tris, name)).view(np.uint8), err_msg=name)
    capsule = convert.soup_to_numpy(pipeline.build_primitives(
        preset, cam, pos, vel, FI, rotations=rot))
    for name in ours:
        np.testing.assert_array_equal(ours[name][:4], capsule[name][:4])
        np.testing.assert_array_equal(ours[name][-8 * n:],
                                      capsule[name][-8 * n:])
    assert ours["valid"][rows].sum() > 5000
    # The near clip's second block holds a triangle only where a clip
    # split one in two: all but a few rows there are invalid.
    assert ours["valid"][4 + n * f:4 + 2 * n * f].mean() < 0.05


def test_mesh_frame_matches_jax_pipeline(mesh_frame_inputs):
    """A 160x96 mesh-LOD traj_vel frame: ``auto`` (binned triangles) and
    ``pallas4`` render the same buffers, the winners are the NumPy
    oracle's, and the frame is within MESH_FLIPS, MESH_DEPTH_ULP and
    RGB_ATOL of the jitted JAX FramePipeline (its own rotations, tiled on
    CPU, ``max_per_tile`` 8192 as the JAX package's mesh-LOD test)."""
    pos, vel, _ = mesh_frame_inputs
    pcl = np.concatenate([pos, vel], axis=1)
    preset = PRESETS["traj_vel"]
    fbs = [pipeline.FramePipeline(preset, cfg, droplet_lod="mesh", width=FW,
                                  height=FH, device="cpu")
           .render_array(pcl, FI)
           for cfg in (RasterConfig(),
                       RasterConfig(backend="pallas4", bin_triangles=True))]
    for field in ("index", "depth", "rgb"):
        np.testing.assert_array_equal(_bits(getattr(fbs[0], field).numpy()),
                                      _bits(getattr(fbs[1], field).numpy()))
    ours = fbs[0]
    cam = pipeline.frame_camera(preset, FI, FW, FH, "cpu")
    soup = pipeline.build_primitives(preset, cam, pos, vel, FI,
                                     droplet_lod="mesh")
    _, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), FW, FH)
    np.testing.assert_array_equal(ours.index.numpy(), i_o)
    jp = jpipe.FramePipeline(JAX_PRESETS["traj_vel"],
                             JRasterConfig(max_per_tile=8192),
                             droplet_lod="mesh", width=FW, height=FH)
    jfb = jp.render_array(pcl, FI)
    index = ours.index.numpy()
    kinds = soup.kind.numpy()[np.maximum(index, 0)]
    # The droplets are 1-2 px at this film (measured: 19 pixels of
    # droplet triangles); the seeded soups above hold larger ones.
    assert ((kinds == 2) & (index >= 4)).sum() >= 10
    same = index == np.asarray(jfb.index)
    flips = int((~same).sum())
    hit = same & (index >= 0)
    ulp = np.abs(_bits(ours.depth.numpy()).astype(np.int64)
                 - _bits(np.asarray(jfb.depth)))[hit].max()
    rgb = np.abs(ours.rgb.numpy() - np.asarray(jfb.rgb))[same].max()
    print(f"mesh-LOD frame vs jitted JAX: {flips} flips, depth {ulp} ulp, "
          f"rgb {rgb:.3g}")
    assert flips <= MESH_FLIPS and ulp <= MESH_DEPTH_ULP and rgb <= RGB_ATOL


def test_mesh_scan_equals_pipeline_and_motion_color_refused():
    pos, vel = cloud(n=6, seed=4)
    preset = PRESETS["traj_vel"]
    ids = [20, 120]
    tr = TrajectoryScanRenderer(preset, droplet_lod="mesh",
                                frames_per_chunk=2, width=96, height=64,
                                device="cpu")
    frames, _ = tr.render_frames(pos, vel, ids)
    pipe = pipeline.FramePipeline(preset, droplet_lod="mesh", width=96,
                                  height=64, device="cpu")
    pcl = np.concatenate([pos, vel], axis=1)
    for fi, frame in zip(ids, frames):
        want = srgb_encode_u8(pipe.render_array(pcl, fi).rgb).numpy()
        np.testing.assert_array_equal(frame, want)
    # The scan's config: auto bins the triangles; its probe with it.
    assert tr._config().bin_triangles and tr.raster_config.max_big == 1024
    with pytest.raises(ValueError, match="mesh LOD unsupported"):
        TrajectoryScanRenderer(preset, droplet_lod="mesh", motion_color=True,
                               width=96, height=64, device="cpu"
                               ).render_frames(pos, vel, [20])


def test_config_policy():
    """scene_config: disc/capsule soups get no_triangles, mesh LOD under
    auto gets bin_triangles, an explicit backend keeps its config."""
    auto, v4 = RasterConfig(), RasterConfig(backend="pallas4")
    assert pipeline.scene_config(PRESETS["traj_vel"], auto,
                                 "mesh").bin_triangles
    assert not pipeline.scene_config(PRESETS["traj_vel"], v4,
                                     "mesh").bin_triangles
    for preset, lod in ((PRESETS["traj_vel"], "capsule"),
                        (PRESETS["traj_ball"], "mesh")):
        cfg = pipeline.scene_config(preset, auto, lod)
        assert cfg.no_triangles and not cfg.bin_triangles
    cfg = convert.raster_config_from_fields(JRasterConfig(
        backend="pallas4", bin_triangles=True,
        entry_capacity=np.int64(4096)))
    assert cfg.bin_triangles is True and cfg.entry_capacity == 4096
    assert type(cfg.entry_capacity) is int
    hash(cfg)


def test_entry_capacity_truncation(soup):
    """Entries past a finite entry_capacity are dropped: tiles whose
    range lies below the capacity render as without it, tiles past it
    keep only their big list; the certificate reports the true count, and
    the pipelines raise on it."""
    b = csr4.bin_csr4(soup, W, H, bin_triangles=True)
    true = int(b["diag"]["true_entries"])
    starts = b["starts"].numpy()
    full = _v4_plain(soup, True)
    np.testing.assert_array_equal(_v4_plain(soup, True, cap=true)[1].numpy(),
                                  full[1].numpy())
    cap = int(starts[7])  # tiles 0..6 whole, the rest empty
    depth, index, diag = _v4_plain(soup, True, cap=cap)
    assert int(diag["true_entries"]) == true > cap
    bins = csr6.bin_csr6(soup, W, H, bin_triangles=True)
    nb = int(bins["big_n"][0])
    only_big = ScreenPrimitives(
        kind=soup.kind, params=soup.params, color=soup.color,
        valid=soup.valid & torch.isin(
            torch.arange(soup.count), bins["big_ids"][:nb].long()),
        bbox=soup.bbox, normal=soup.normal)
    big_d, big_i = _v4_plain(only_big, True)[:2]
    tiles_x, _ = csr6.grid_shape(W, H)
    tile = (np.arange(H)[:, None] // 32) * tiles_x + np.arange(W)[None] // 32
    for got, whole, bigonly in ((index, full[1], big_i),
                                (depth, full[0], big_d)):
        got, whole, bigonly = (_bits(t.numpy()) for t in (got, whole,
                                                          bigonly))
        np.testing.assert_array_equal(got[tile < 7], whole[tile < 7])
        np.testing.assert_array_equal(got[tile >= 7], bigonly[tile >= 7])
    assert (index.numpy() != full[1].numpy()).any()
    pcl = np.concatenate(cloud(n=6, seed=4), axis=1)
    for cfg in (RasterConfig(backend="pallas4", bin_triangles=True,
                             entry_capacity=64),
                RasterConfig(entry_capacity=64)):
        with pytest.raises(RuntimeError, match="entry capacity violated"):
            pipeline.FramePipeline(
                PRESETS["traj_vel"], cfg, droplet_lod="mesh", width=96,
                height=64, device="cpu").render_array(pcl, FI)


def test_id_range_guard():
    """The 2^24 id limit: a soup of 2^24 rows raises the JAX package's
    ValueError in both binnings and the render, before any work (the
    rows are stride-0 views: no memory); 13,025 mesh-LOD droplets are the
    most a traj_vel frame holds."""
    n = 1 << 24
    big = ScreenPrimitives(
        kind=torch.zeros((), dtype=torch.int32).expand(n),
        params=torch.zeros(12).expand(n, 12),
        color=torch.zeros(3).expand(n, 3),
        valid=torch.ones((), dtype=torch.bool).expand(n),
        bbox=torch.zeros(4).expand(n, 4),
        normal=torch.zeros(3).expand(n, 3))
    for fn in (lambda: csr6.bin_csr6(big, W, H),
               lambda: csr4.bin_csr4(big, W, H),
               lambda: render(big, tcam(), RasterConfig(bin_triangles=True)),
               lambda: render(big, tcam(), RasterConfig(backend="pallas4"))):
        with pytest.raises(ValueError, match="2\\^24"):
            fn()
    cam = pipeline.frame_camera(PRESETS["traj_vel"], FI, 64, 48, "cpu")
    pos, vel = cloud(n=5, seed=1)
    layout = pipeline.build_primitives(PRESETS["traj_vel"], cam, pos, vel,
                                       FI, droplet_lod="mesh",
                                       return_layout=True)[1]
    fixed = sum(r for r, per in layout if per == 0)
    per_droplet = sum(per for _, per in layout)
    assert (fixed, per_droplet) == (4, 1288)
    assert 13025 * per_droplet + fixed < n <= 13026 * per_droplet + fixed


def test_knobs_that_still_raise_and_wrapper_dispatch(soup):
    # Backend "pallas" (v2) is ported: it renders.
    check_config(RasterConfig(backend="pallas"))
    fb = render(soup, tcam(), RasterConfig(backend="pallas"))
    assert bool((fb.index >= 0).any())
    # Ported since: discs_only at spans 4 and 8 renders.
    check_config(RasterConfig(discs_only=True, span=8))
    fb = render(soup, tcam(), RasterConfig(discs_only=True, span=8))
    assert bool((fb.index >= 0).any())
    check_config(RasterConfig(backend="pallas3"))
    check_config(RasterConfig(cap_rows10=True, span=4))
    for cfg, err in ((RasterConfig(cap_rows10=True, bin_triangles=True),
                      "triangle lanes"),
                     (RasterConfig(rows9=True, bin_triangles=True),
                      "bin_triangles"),
                     (RasterConfig(rows8=True, bin_triangles=True),
                      "bin_triangles")):
        with pytest.raises(ValueError, match=err):
            check_config(cfg)
    with pytest.raises(ValueError, match="kind_split"):
        csr6.bin_csr6(soup, W, H, kind_split=True, bin_triangles=True)
    check_config(RasterConfig(backend="pallas4", bin_triangles=True,
                              entry_capacity=1 << 20))
    # The v4 wrapper: CPU tensors take the plain walk without counting a
    # launch; a device with no kernel raises; malformed inputs raise.
    b = csr4.bin_csr4(soup, W, H)
    zeros = torch.zeros((soup.count, 3))
    args = (csr6.build_table16(soup, zeros, zeros[:, 0]), b["entries"],
            b["starts"], b["big_ids"], b["big_n"], b["zmeta"], W, H,
            b["zq_bits"])
    before = csr4.raster_tiles4.launches
    got = csr4.raster_tiles4(*args)
    want = csr4.raster_tiles4_plain(*args)
    assert csr4.raster_tiles4.launches == before
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    with pytest.raises(ValueError, match="no csr4 kernel"):
        csr4.raster_tiles4(*(a.to("meta") for a in args[:6]), *args[6:])
    with pytest.raises(ValueError, match="zmeta"):
        csr4.raster_tiles4(*args[:5], b["zmeta"][:2], *args[6:])
    with pytest.raises(ValueError, match="starts does not match"):
        csr4.raster_tiles4(*args[:2], b["starts"][:-1], *args[3:])
    # The plain walk has no exit: every tile walks its whole range.
    walked = torch.full((b["starts"].shape[0] - 1,), -1, dtype=torch.int32)
    csr4.raster_tiles4(*args, walked=walked)
    np.testing.assert_array_equal(
        walked.numpy(), (b["starts"][1:] - b["starts"][:-1]).numpy())
    with pytest.raises(ValueError, match="walked"):
        csr4.raster_tiles4(*args, walked=walked[:-1])
    before = csr6.raster_tiles_tri.launches
    d, i, _ = csr6.rasterize_csr6(soup, W, H, bin_triangles=True)
    assert csr6.raster_tiles_tri.launches == before
    assert bool((i >= 0).all())
