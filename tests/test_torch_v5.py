"""The v5 slice of the port (``raster/csr5.py``, chunk-binned discs over
Morton-ordered clouds, and ``scene/spatial.py``), held against the JAX
package on the CPU.

* ``morton_codes``, ``spatial_order`` and ``spatial_sort`` equal the JAX
  functions bit for bit (NaN/inf rows, a degenerate axis, companions).
* ``bin_chunks5`` against ``pallas_csr5._bin_chunks5`` under one jit (it
  holds integers, gathers and concatenations, no multiply-add): sorted
  keys, each key's set of chunk ids (the JAX sort is unstable, the
  port's stable), the big list, zmeta bits, ``binnable``, ``sok`` and
  ``srank``; ``build_table5`` and ``build_singletons5`` bit-equal.
* The plain walk (``rasterize_csr5`` on CPU tensors) against
  ``cpu_reference``: winners equal, disc depth bit-equal, triangle depth
  within TRI_DEPTH_RTOL; capacity at the true count equals the uncut
  render.  The JAX package's own v5 test holds the Pallas kernel to the
  same oracle, so no interpret-mode call runs here.
* ``render_shaded_csr5``'s rgb equals the port's ``shade_framebuffer``
  on its own buffers bit for bit, and the JAX ``shade_framebuffer``
  within RGB_ATOL; ``uniform_color`` keeps the winners.
* The slice: a 160x96 disc-lane frame against the JAX soup's oracle
  frame, and the port's v5 frame against its pallas6 frame.
* The kernels' warp cull, counted on the CPU (``block_slots5``), against
  a brute force over each warp block's pixels at tile widths 16, 32 and
  128, on discs tangent to the blocks' edges.
The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr5 as jcsr5
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.scene import spatial as jspatial
from pointcloud_render_tpu.scene.camera import TARGETS, camera_origin_jax
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu.shading import shade as jshade
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr5, csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    discs_from_points,
)
from pointcloud_render_tpu_torch.raster.render import ground_plane
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.scene import spatial
from pointcloud_render_tpu_torch.shading.shade import (
    ShadingConfig,
    shade_framebuffer,
)
from tests.torch_jax import jax_soup, jcam, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    H,
    W,
    _v5_cloud,
    block_soup,
    morton_soup,
    tcam,
    v5_soups,
)

GRAY = (0.3, 0.3, 0.3)
# Triangle depth against the NumPy oracle, relative (the JAX package's
# bound for v5's big-list triangles, test_csr_v5.py); disc depth is exact.
TRI_DEPTH_RTOL = 5e-7
# The jitted JAX shade_framebuffer on the same buffers: XLA contracts its
# multiply-adds (the JAX package's own bound against its XLA shade).
RGB_ATOL = 2e-6
# The slice frame against the jitted JAX build, oracle and shade (queue C
# of ROADMAP.md: XLA's contraction moves the soup by ulps; measured: 0
# flips, depth 1 ulp, rgb 3.8e-5).
FW, FH = 160, 96
FRAME_DEPTH_ULP = 4
FRAME_RGB_ATOL = 1e-4


def _bits(a):
    return np.asarray(a).view(np.int32)


def _discs(cam, pos, radius=0.02, colors=GRAY):
    n = pos.shape[0]
    return discs_from_points(torch.tensor(pos), cam,
                             torch.full((n,), radius), np.asarray(colors,
                                                                  np.float32))


SOUPS = v5_soups()
# (soup, bin_chunks5 knobs): an unsorted cloud's chunks span the 5x3-tile
# film, so at max_span 2 its discs spill to singleton rows; the spill cap
# past max_spill sends discs to the big list; the last two cases change
# the chunk and the tile shape.
CASES = {
    "sorted": ("sorted", {}),
    "unsorted_spill": ("unsorted", {"max_big": 64, "max_span": 2}),
    "spill_cap": ("unsorted", {"max_spill": 16, "max_big": 512,
                               "max_span": 2}),
    "mixed": ("mixed", {}),
    "k8_span2": ("sorted", {"k": 8, "max_span": 2}),
    "tile16x64": ("sorted", {"tile_h": 16, "tile_w": 64}),
}


def _knobs(kw):
    full = dict(tile_h=32, tile_w=32, max_big=csr5.DEFAULT_MAX_BIG,
                max_span=csr5.DEFAULT_MAX_SPAN,
                max_spill=csr5.DEFAULT_MAX_SPILL, k=csr5.DEFAULT_K)
    full.update(kw)
    return full


def test_spatial_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2.0, 3.0, (500, 3)).astype(np.float32)
    pos[:, 1] = 0.25  # a degenerate axis
    pos[7] = [np.nan, 0.0, 1.0]
    pos[11, 2] = np.inf
    pos[13, 0] = -np.inf
    pos[20:40] = pos[40:60]  # equal cells: the stable order decides
    for bits in (3, 10):
        np.testing.assert_array_equal(spatial.morton_codes(pos, bits),
                                      jspatial.morton_codes(pos, bits))
        np.testing.assert_array_equal(
            spatial.spatial_order(torch.tensor(pos), bits),
            jspatial.spatial_order(pos, bits))
    vel = rng.normal(0, 1, (500, 3)).astype(np.float32)
    ours = spatial.spatial_sort(pos, vel, None)
    theirs = jspatial.spatial_sort(pos, vel, None)
    assert ours[2] is None and theirs[2] is None
    for a, b in zip(ours[:2] + ours[3:], theirs[:2] + theirs[3:]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    # Tensors come back as tensors, permuted on their own device.
    tp, tv, order = spatial.spatial_sort(torch.tensor(pos),
                                         torch.tensor(vel))
    assert isinstance(tp, torch.Tensor) and isinstance(tv, torch.Tensor)
    np.testing.assert_array_equal(tv.numpy(), vel[order])


def _jax_bin(soup, kn):
    tiles_x, tiles_y = csr5.grid5(W, H, kn["tile_h"], kn["tile_w"])
    return jax.jit(lambda s: jcsr5._bin_chunks5(
        s, kn["tile_h"], kn["tile_w"], tiles_x * tiles_y, tiles_x, tiles_y,
        max_big=kn["max_big"], max_span=kn["max_span"],
        max_spill=kn["max_spill"], k=kn["k"]))(jax_soup(soup))


@pytest.mark.parametrize("case", list(CASES))
def test_bin_chunks5_matches_jax(case):
    name, kw = CASES[case]
    soup, kn = SOUPS[name], _knobs(kw)
    b = csr5.bin_chunks5(soup, W, H, **kn)
    keys, chunks, big_list, big_count, zmeta, binnable, (sok, srank) = \
        _jax_bin(soup, kn)
    keys, chunks = np.asarray(keys), np.asarray(chunks)
    np.testing.assert_array_equal(b["keys"].numpy(), keys)
    # Each key holds the same set of chunk ids: (key, chunk) pairs sorted.
    ours = np.lexsort((b["chunks"].numpy(), b["keys"].numpy()))
    theirs = np.lexsort((chunks, keys))
    np.testing.assert_array_equal(b["chunks"].numpy()[ours], chunks[theirs])
    np.testing.assert_array_equal(b["big_list"].numpy(), np.asarray(big_list))
    assert int(b["big_count"]) == int(big_count)
    np.testing.assert_array_equal(_bits(b["zmeta"]), _bits(zmeta))
    for mine, jax_arr in ((b["binnable"], binnable), (b["sok"], sok),
                          (b["srank"], srank)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(jax_arr))
    starts = b["starts"].numpy()
    want = np.searchsorted(keys, np.arange(starts.shape[0]) << csr5.ZQ_BITS)
    np.testing.assert_array_equal(starts, want)
    assert int(b["diag"]["true_entries"]) == starts[-1] > 0
    assert int(b["diag"]["big_overflow"]) == max(
        int(big_count) - kn["max_big"], 0)
    if case == "unsorted_spill":
        assert int(b["sok"].sum()) > 100  # the spill path is exercised
    if case == "spill_cap":
        assert bool((b["srank"] >= 16).any() & ~b["sok"].all())
    if case == "mixed":
        live = b["big_list"].numpy()
        kinds = soup.kind.numpy()[live[live >= 0]]
        assert {1, 2} <= set(kinds.tolist())  # capsules and triangles big


def test_tables_match_jax():
    soup = SOUPS["unsorted"]
    b = csr5.bin_chunks5(soup, W, H, max_span=2, max_spill=64)
    rgb, _ = csr6.preshade(soup, tcam(), ShadingConfig())
    assert int(b["sok"].sum()) > 0
    table, sing = jax.jit(lambda s, bn, so, sr, c: (
        jcsr5._build_table5(s, bn, c),
        jcsr5._build_singletons5(s, so, sr, 64, c)))(
        jax_soup(soup), jnp.asarray(b["binnable"].numpy()),
        jnp.asarray(b["sok"].numpy()), jnp.asarray(b["srank"].numpy()),
        jnp.asarray(rgb.numpy()))
    np.testing.assert_array_equal(
        _bits(csr5.build_table5(soup, b["binnable"], rgb)), _bits(table))
    np.testing.assert_array_equal(
        _bits(csr5.build_singletons5(soup, b["sok"], b["srank"], 64, rgb)),
        _bits(sing))
    tab = csr5.chunk_table5(soup, b, 64, rgb)
    c = -(-soup.count // csr5.DEFAULT_K)
    assert tab.shape == (c + 64 + 1, 128)
    np.testing.assert_array_equal(_bits(tab[-1]),
                                  _bits(np.tile(csr5.PAD8, 16)))


def _assert_oracle(soup, depth, index, what, w=W, h=H):
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), w, h)
    assert (i_o >= 0).mean() > 0.05, f"{what}: nearly empty render"
    np.testing.assert_array_equal(index.numpy(), i_o, err_msg=what)
    d = depth.numpy()
    hit = i_o >= 0
    tri = np.zeros_like(hit)
    tri[hit] = soup.kind.numpy()[i_o[hit]] == 2
    np.testing.assert_array_equal(_bits(d[~tri]), _bits(d_o[~tri]),
                                  err_msg=what)
    np.testing.assert_allclose(d[tri], d_o[tri], rtol=TRI_DEPTH_RTOL,
                               err_msg=what)


def _cross_chunk_tie_pixels(soup, index, k):
    """Pixels won by a disc whose exact depth twin from another k-prim
    chunk covers them too: the (depth, id) merge across superrows decides
    them."""
    p = soup.params.numpy()
    disc = np.flatnonzero(soup.kind.numpy() == 0)
    zbits = p[disc, 2].view(np.int32)
    qy, qx = np.mgrid[0:H, 0:W] + 0.5
    n = 0
    for a in range(disc.size):
        for b in np.flatnonzero(zbits[a + 1:] == zbits[a]) + a + 1:
            i, j = disc[a], disc[b]
            if i // k == j // k:
                continue
            both = np.ones((H, W), bool)
            for m in (i, j):
                both &= ((qx - p[m, 0]) ** 2 + (qy - p[m, 1]) ** 2
                         <= p[m, 3] ** 2)
            n += int((both & (index == i)).sum())
    return n


@pytest.mark.parametrize("case", list(CASES))
def test_plain_walk_matches_oracle(case):
    name, kw = CASES[case]
    soup, kn = SOUPS[name], _knobs(kw)
    depth, index, diag = csr5.rasterize_csr5(soup, W, H, return_diag=True,
                                             check_every=1, chunk_rows=8,
                                             **kn)
    _assert_oracle(soup, depth, index, case)
    if name == "sorted":
        assert _cross_chunk_tie_pixels(soup, index.numpy(), kn["k"]) > 0
    n = int(diag["true_entries"])
    if case in ("sorted", "tile16x64"):
        # A capacity at the true count drops nothing; below it the diag
        # still reports the true count.
        d2, i2, diag2 = csr5.rasterize_csr5(soup, W, H, entry_capacity=n,
                                            return_diag=True, **kn)
        np.testing.assert_array_equal(_bits(d2), _bits(depth))
        np.testing.assert_array_equal(i2.numpy(), index.numpy())
        _, _, diag3 = csr5.rasterize_csr5(soup, W, H, entry_capacity=n // 2,
                                          return_diag=True, **kn)
        assert int(diag3["true_entries"]) == int(diag2["true_entries"]) == n
        assert int(csr5.true_entry_count5(
            soup, W, H, kn["tile_h"], kn["tile_w"])) == n


@pytest.mark.parametrize("mode", ["lambert", "flat"])
def test_fused_shade_matches_shade_framebuffer(mode):
    cam = tcam()
    rng = np.random.default_rng(5)
    pos = spatial.spatial_sort(_v5_cloud(500, 9))[0]
    colors = rng.uniform(0.1, 0.9, (500, 3)).astype(np.float32)
    soup = ScreenPrimitives.concatenate([
        ground_plane(cam, 10.0, (0, 0, -0.5)),
        discs_from_points(torch.tensor(pos), cam, torch.full((500,), 0.02),
                          torch.tensor(colors)),
        _discs(cam, _v5_cloud(2, 6) * 0.2, 0.4, (0.8, 0.2, 0.2))])
    cfg = ShadingConfig(mode=mode)
    rgb, depth, index = csr5.render_shaded_csr5(soup, cam, cfg)
    _assert_oracle(soup, depth, index, f"shaded {mode}")
    ours = shade_framebuffer(soup, cam, depth, index, cfg)
    np.testing.assert_array_equal(_bits(rgb), _bits(ours))
    theirs = jax.jit(lambda s, d, i: jshade.shade_framebuffer(
        s, jcam(), d, i, JShading(mode=mode)))(
        jax_soup(soup), jnp.asarray(depth.numpy()),
        jnp.asarray(index.numpy()))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(theirs), atol=RGB_ATOL)


def test_uniform_color_keeps_winners():
    cam, cfg = tcam(), ShadingConfig()
    soup = SOUPS["mixed"]  # gray discs; capsules and triangles big
    rgb, depth, index = csr5.render_shaded_csr5(soup, cam, cfg, k=8)
    rgb_u, depth_u, index_u = csr5.render_shaded_csr5(
        soup, cam, cfg, k=8, uniform_color=GRAY)
    np.testing.assert_array_equal(_bits(depth_u), _bits(depth))
    np.testing.assert_array_equal(index_u.numpy(), index.numpy())
    np.testing.assert_array_equal(_bits(rgb_u), _bits(rgb))
    # A color that is not the discs' shows on binned disc winners only.
    rgb_r, _, _ = csr5.render_shaded_csr5(soup, cam, cfg, k=8,
                                          uniform_color=(1.0, 0.0, 0.0))
    changed = (rgb_r != rgb).any(dim=-1).numpy()
    hit = index.numpy() >= 0
    kinds = np.full(index.shape, -1)
    kinds[hit] = soup.kind.numpy()[index.numpy()[hit]]
    assert changed.any() and (kinds[changed] == 0).all()


def _jax_disc_frame(pos, fi):
    """The JAX frame: the jitted soup build, the NumPy oracle on that
    soup and the jitted shade."""
    preset = dataclasses.replace(JAX_PRESETS["traj_ball"],
                                 point_radius=0.01, point_color=GRAY)
    origin = camera_origin_jax(preset.camera_preset, fi, preset.total_frames)
    cam = JCamera(origin=origin, target=np.asarray(
        TARGETS["traj_ball"], np.float32), width=FW, height=FH)
    soup = jax.jit(lambda p: jpipe.build_primitives(preset, cam, p, None,
                                                    fi))(jnp.asarray(pos))
    d, i = cpu_reference.rasterize_reference(types.SimpleNamespace(
        **{f.name: np.asarray(getattr(soup, f.name))
           for f in dataclasses.fields(soup)}), FW, FH)
    rgb = jax.jit(lambda s, dd, ii: jshade.shade_framebuffer(
        s, cam, dd, ii, JShading()))(soup, jnp.asarray(d), jnp.asarray(i))
    return d, i, np.asarray(rgb)


def test_disc_lane_frame_matches_jax_and_pallas6():
    """The slice as a whole: ground + 3,000 gray splats (bench.py's disc
    lane, the radius scaled to the 160x96 film), Morton-sorted by each
    package's spatial_sort, frame 120."""
    pos = _v5_cloud(3000, 0)
    fi = 120
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.01,
                                 point_color=GRAY)
    cam = pipeline.frame_camera(preset, fi, FW, FH, "cpu")
    srt = spatial.spatial_sort(torch.tensor(pos))[0]
    soup = pipeline.build_primitives(preset, cam, srt, None, fi)
    rgb, depth, index, diag = csr5.render_shaded_csr5(
        soup, cam, ShadingConfig(), uniform_color=GRAY, return_diag=True)
    assert int(diag["big_overflow"]) == 0
    d_o, i_o, rgb_o = _jax_disc_frame(jspatial.spatial_sort(pos)[0], fi)
    assert (i_o >= 0).mean() > 0.5
    assert (soup.kind.numpy()[i_o[i_o >= 0]] == 0).mean() > 0.1
    np.testing.assert_array_equal(index.numpy(), i_o)
    ulp = np.abs(_bits(depth).astype(np.int64) - _bits(d_o).astype(np.int64))
    assert ulp.max() <= FRAME_DEPTH_ULP
    np.testing.assert_allclose(rgb.numpy(), rgb_o, atol=FRAME_RGB_ATOL)
    # The port's pallas6 disc walk renders the same frame.
    rgb6, depth6, index6, _ = csr6.render_shaded_csr6(
        soup, cam, ShadingConfig(), discs_only=True, max_big=256,
        uniform_look=(GRAY, (1.0, 1.0, 1.0)))
    np.testing.assert_array_equal(_bits(depth6), _bits(depth))
    np.testing.assert_array_equal(index6.numpy(), index.numpy())


def test_refusals_and_wrapper_dispatch():
    soup = SOUPS["sorted"]
    for th, tw in ((32, 48), (16, 32), (8, 256)):
        with pytest.raises(ValueError, match="tile_h \\* tile_w == 1024"):
            csr5.rasterize_csr5(soup, W, H, tile_h=th, tile_w=tw)
    with pytest.raises(ValueError, match="multiple of check_every"):
        csr5.rasterize_csr5(soup, W, H, chunk_rows=32, check_every=3)
    n = 1 << 24
    big = ScreenPrimitives(
        kind=torch.zeros((), dtype=torch.int32).expand(n),
        params=torch.zeros(12).expand(n, 12),
        color=torch.zeros(3).expand(n, 3),
        valid=torch.ones((), dtype=torch.bool).expand(n),
        bbox=torch.zeros(4).expand(n, 4),
        normal=torch.zeros(3).expand(n, 3))
    for fn in (lambda: csr5.rasterize_csr5(big, W, H),
               lambda: csr5.render_shaded_csr5(big, tcam(), ShadingConfig()),
               lambda: csr5.bin_chunks5(big, W, H)):
        with pytest.raises(ValueError, match="2\\^24"):
            fn()
    # CPU tensors take the plain walk and count no launch; walked gets the
    # whole runs; a device with no kernel raises; malformed inputs raise.
    b = csr5.bin_chunks5(soup, W, H)
    tab, bp, kinds, meta = csr5.tables5(soup, b, torch.zeros((soup.count, 3)),
                                        csr5.look5(soup))
    args = (tab, b["chunks"], b["starts"], bp, kinds, b["big_n"], meta, W, H)
    before = (csr5.raster_tiles5.launches, csr5.raster_tiles5_shaded.launches)
    walked = torch.full((b["starts"].shape[0] - 1,), -1, dtype=torch.int32)
    got = csr5.raster_tiles5(*args, walked=walked)
    want = csr5.raster_tiles5_plain(*args)
    shaded = csr5.raster_tiles5_shaded(*args)
    assert (csr5.raster_tiles5.launches,
            csr5.raster_tiles5_shaded.launches) == before
    for a, w in zip(got + shaded[:2], want + want):
        np.testing.assert_array_equal(_bits(a), _bits(w))
    np.testing.assert_array_equal(
        walked.numpy(), (b["starts"][1:] - b["starts"][:-1]).numpy())
    with pytest.raises(ValueError, match="no csr5 kernel"):
        csr5.raster_tiles5(*(a.to("meta") for a in args[:7]), W, H)
    with pytest.raises(ValueError, match="meta"):
        csr5.raster_tiles5(*args[:6], meta[:3], W, H)
    with pytest.raises(ValueError, match="starts does not match"):
        csr5.raster_tiles5(*args[:2], b["starts"][:-1], *args[3:])
    with pytest.raises(ValueError, match="chunk table"):
        csr5.raster_tiles5(*args, k=8)
    with pytest.raises(ValueError, match="walked"):
        csr5.raster_tiles5(*args, walked=walked[:-1])


@pytest.mark.parametrize("tile_w", [16, 32, 128])
def test_v5_cull_counter_matches_brute_force(tile_w):
    """csr5.block_slots5 (the v5 kernels' warp cull, counted on the CPU)
    keeps a (live slot, warp block) pair exactly when a pixel of the block
    inside the image passes the disc test (blocks of 16 columns x 8 rows
    at tile width 16, of 32 x 4 at the others), on discs tangent to the
    blocks' column and row boundaries and over the ragged edge tiles, in
    their own order (singleton rows) and in Morton order (chunk
    superrows).  The CPU wrappers report it as ``bands``."""
    th = 1024 // tile_w
    tiles_x, _ = csr5.grid5(W, H, th, tile_w)
    bw, bh = (16, 8) if tile_w == 16 else (32, 4)
    for soup in (block_soup(), morton_soup(block_soup())):
        b = csr5.bin_chunks5(soup, W, H, th, tile_w)
        tab, bp, kinds, meta = csr5.tables5(
            soup, b, torch.zeros((soup.count, 3)), csr5.look5(soup))
        starts = b["starts"].numpy().astype(np.int64)
        n = int(starts[-1])
        t = np.searchsorted(starts, np.arange(n), side="right") - 1
        slots = tab[b["chunks"][:n].long()].numpy().reshape(n, -1, 8)
        live = slots[..., 2] < np.inf  # the slots that can win a pixel
        t = np.broadcast_to(t[:, None], live.shape)[live]
        px, py, r = (slots[..., c][live] for c in (0, 1, 3))
        r2 = (r * r)[:, None, None]
        want = np.zeros(len(starts) - 1, np.int64)
        for c0 in range(0, tile_w, bw):
            for r0 in range(0, th, bh):
                col = (t % tiles_x)[:, None] * tile_w + c0 + np.arange(bw)
                row = (t // tiles_x)[:, None] * th + r0 + np.arange(bh)
                ok = (col < W)[:, :, None] & (row < H)[:, None, :]
                dx = (col.astype(np.float32) + np.float32(0.5)) - px[:, None]
                dy = (row.astype(np.float32) + np.float32(0.5)) - py[:, None]
                hit = ((dx[:, :, None] * dx[:, :, None]
                        + dy[:, None, :] * dy[:, None, :] <= r2)
                       & ok).any(axis=(1, 2))
                np.add.at(want, t, hit)
        got = csr5.block_slots5(tab, b["chunks"], b["starts"], W, H, th,
                                tile_w)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) > 0
        args = (tab, b["chunks"], b["starts"], bp, kinds, b["big_n"], meta,
                W, H, th, tile_w)
        for fn in (csr5.raster_tiles5, csr5.raster_tiles5_shaded):
            bands = torch.full((len(starts) - 1,), -1, dtype=torch.int32)
            fn(*args, bands=bands)
            np.testing.assert_array_equal(bands.numpy(), want)
