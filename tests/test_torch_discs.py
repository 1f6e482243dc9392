"""The ``discs_only`` lane of the port's v6 rasterizer (8-float disc rows,
the fused (u, v) shade, ``uniform_look``) and ``scene/dynamics.py``, held
against the JAX package on the CPU.

* Binning with ``discs_only`` (capsules ride the big list) matches
  ``pallas_csr6._bin_csr6`` / ``bin_diagnostics6``, with and without the
  exit's z-bucket keys.
* ``build_table8`` and ``build_table16_rows`` are bit-equal to the JAX rows,
  ``build_rows8`` (the sorted rows the walks take) to ``build_table8``'s
  rows in sorted order; the warp-band cull of the disc kernels is exact.
* The plain 8-float walks equal ``cpu_reference.rasterize_reference`` bit
  for bit (exact ties, wide discs and capsules on the big list) and the
  interpret-mode ``discs_only`` Pallas walk.
* The fused path (plain (u, v) walk + ``shade_uv``) against
  ``render_shaded_csr6(interpret=True, discs_only=True, uniform_look=...)``:
  index and depth equal, rgb within 2e-6 (the interpreted kernel runs as
  XLA CPU code, which contracts multiply-adds into FMAs).
* ``shade_by_id(uniform_look=...)`` is bit-equal to
  ``pallas_csr4._shade_by_id`` evaluated op by op, and to ``shade_uv``.
* ``advect`` and ``motion_colors`` are bit-equal to the JAX functions
  evaluated op by op.
* Spans 4 and 8: ``bin_csr6(discs_only=True)`` against ``_bin_csr6``
  under one jit, both 8-float walks against the oracle and the 16-float
  walk at the same span, and the fused render at span 4 against the
  ``shade_by_id`` path, on a film where wide discs reach 5-8 tiles.
The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr4 as jcsr4
from pointcloud_render_tpu.raster import pallas_csr6 as jcsr6
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.scene import dynamics as jdynamics
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.scene import dynamics
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import jax_soup, jcam, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    H,
    SPAN8_FILM,
    W,
    band_soup,
    disc_soup,
    make_soup,
    tcam,
    wide_disc_soup,
)

LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))
SMALL = 64  # film edge of the interpret-mode runs (2x2 tiles)


def _disc_walk_inputs(soup, w, h, max_big=256, flag=None, span=2):
    b = csr6.bin_csr6(soup, w, h, max_big, discs_only=True, span=span)
    zeros = torch.zeros((soup.count, 3))
    flag = torch.zeros(soup.count) if flag is None else flag
    rows8 = csr6.build_rows8(soup, flag, b["order"])
    big_rows = csr6.build_table16_rows(soup, zeros, flag, b["big_ids"])
    return (rows8, big_rows, b["starts"], b["big_n"], w, h), b


@functools.cache
def _jax_discs_overflow(max_big):
    """The JAX package's discs_only overflow count of the wide_big soup
    (the same with and without the exit keys)."""
    return jax.jit(lambda s: jcsr6.bin_diagnostics6(
        s, W, H, max_big=max_big, discs_only=True))(
            jax_soup(make_soup("wide_big")))


@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("max_big", [8, 256])
def test_discs_only_binning_matches_jax(max_big, with_z):
    """Big count, overflow and true_entries equal the JAX binning's; every
    valid capsule lands on the big list.  With ``with_z`` (the exit forced
    on): the int32 exit keys, ``zmeta`` bits and range starts equal
    ``_bin_csr6(discs_only=True, with_z=True)``'s, and every key holds the
    same prim ids."""
    soup = make_soup("wide_big")
    jsoup = jax_soup(soup)
    b = csr6.bin_csr6(soup, W, H, max_big, discs_only=True, with_z=with_z)
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    shift = jcsr6.ZQ if with_z else 0
    # Integer results and float32 reductions with no multiply-add to
    # contract: one jit each instead of op-by-op dispatch.
    keys, prims, _, jbig_count, zmeta, jn_small = jax.jit(
        lambda s: jcsr6._bin_csr6(
            s, 32, 32, tiles_x * tiles_y, tiles_x, tiles_y, max_big=max_big,
            discs_only=True, with_z=with_z))(jsoup)
    jovf = _jax_discs_overflow(max_big)
    n_small = int(np.asarray(jn_small))
    keys = np.asarray(keys).astype(np.int64)
    classes = np.bincount((keys[:n_small] >> shift) % 4, minlength=4)
    if with_z:
        assert b["keys"].dtype == torch.int32
        np.testing.assert_array_equal(b["zmeta"].numpy().view(np.int32),
                                      np.asarray(zmeta).view(np.int32))
        np.testing.assert_array_equal(
            b["starts"].numpy(), np.searchsorted(
                keys, np.arange(tiles_x * tiles_y * 4 + 1) << shift))
        ours = np.lexsort((b["order"].numpy(), b["keys"].numpy()))
        theirs = np.lexsort((np.asarray(prims), keys))
        np.testing.assert_array_equal(b["keys"].numpy()[ours], keys[theirs])
        np.testing.assert_array_equal(b["order"].numpy()[ours],
                                      np.asarray(prims)[theirs])
        assert len(np.unique(keys[:n_small] & ((1 << shift) - 1))) > 4
    assert int(b["big_count"]) == int(np.asarray(jbig_count))
    assert int(b["starts"][-1]) == n_small
    assert int(b["diag"]["big_overflow"]) == int(np.asarray(jovf))
    assert int(b["diag"]["true_entries"]) == int(classes @ [1, 2, 4, 2])
    assert int(csr6.bin_diagnostics6(soup, W, H, max_big, discs_only=True)) \
        == int(np.asarray(jovf))
    caps = np.flatnonzero((soup.kind.numpy() == 1) & soup.valid.numpy())
    assert len(caps) > 0
    if max_big == 256:
        big = b["big_ids"].numpy()[:int(b["big_n"][0])]
        assert set(caps) <= set(big)
        # Without the flag the capsules are binned: the probe must mirror it.
        assert int(csr6.bin_csr6(soup, W, H, max_big)["big_count"]) \
            < int(b["big_count"])
    else:
        assert int(b["diag"]["big_overflow"]) > 0


def test_disc_tables_match_jax():
    """table8 bit-equal to the JAX expressions (pallas_csr6.py:1286-1296);
    the big rows bit-equal to _build_table16_rows and to the rows of the
    full table.  Both packages get the same preshade values (held against
    _preshade in test_torch_raster.py); the row layouts hold no
    multiply-add, so the JAX side may run under jit."""
    soup = make_soup("invalid")
    jsoup = jax_soup(soup)
    rgb, flag = csr6.preshade(soup, tcam(), ShadingConfig())
    ids = torch.tensor([0, 1, 5, soup.count - 1, soup.count, 17, soup.count],
                       dtype=torch.int32)

    @jax.jit
    def jax_tables(jsoup, jrgb, jflag, jids):
        r = jsoup.params[:, 3]
        table8 = jnp.concatenate([
            jsoup.params[:, 0:3], (r * r)[:, None],
            jnp.arange(soup.count, dtype=jnp.float32)[:, None],
            jflag[:, None], jnp.zeros((soup.count, 2), jnp.float32)], axis=1)
        table8 = jnp.pad(jnp.where(jsoup.valid[:, None], table8, 0.0),
                         ((0, 1), (0, 0)))
        return table8, jcsr4._build_table16_rows(jsoup, jrgb, jflag, jids)

    jtable8, jrows = jax_tables(jsoup, jnp.asarray(rgb.numpy()),
                                jnp.asarray(flag.numpy()),
                                jnp.asarray(ids.numpy()))
    table8 = csr6.build_table8(soup, flag).numpy()
    assert not np.isnan(table8).any()  # invalid rows zeroed, NaN params too
    np.testing.assert_array_equal(table8.view(np.int32),
                                  np.asarray(jtable8).view(np.int32))
    rows = csr6.build_table16_rows(soup, rgb, flag, ids)
    np.testing.assert_array_equal(rows.numpy().view(np.int32),
                                  np.asarray(jrows).view(np.int32))
    np.testing.assert_array_equal(
        rows.numpy().view(np.int32),
        csr6.build_table16(soup, rgb, flag)[ids.long()].numpy().view(np.int32))


def test_sorted_disc_rows_and_band_cull():
    """build_rows8 == build_table8(...)[order] bit for bit (the rows the
    disc kernels stage, and the plain walks read, in sorted order); the
    warp-band cull (band_keeps, the kernels' test mirrored) keeps a (disc
    row, band) pair exactly when a pixel centre of the band passes the
    disc test at dx = 0, on band_soup's tangent, one-below and
    boundary-centred discs and NaN rows; band_rows counts the kept pairs
    of the bands inside the image, at most 8 per tile row; with bands of
    one row it counts the (row, pixel row) pairs that pass the exact dy
    test, between one and BAND_ROWS per kept band."""
    soup = band_soup()
    _, flag = csr6.preshade(soup, tcam(), ShadingConfig())
    b = csr6.bin_csr6(soup, W, H, 256, discs_only=True)
    rows = csr6.build_rows8(soup, flag, b["order"])
    np.testing.assert_array_equal(
        rows.numpy().view(np.int32),
        csr6.build_table8(soup, flag)[b["order"].long()].numpy()
        .view(np.int32))
    py = torch.cat([rows[:, 1], torch.tensor([np.nan, 40.0])])
    r2 = torch.cat([rows[:, 3], torch.tensor([4.0, np.nan])])
    tangent = 0
    for y0 in range(0, H + 4, 4):
        keep = csr6.band_keeps(py, r2, torch.tensor(y0 + 0.5))
        dy2 = [((y0 + k + 0.5) - py) ** 2 for k in range(csr6.BAND_ROWS)]
        cover = torch.stack([d <= r2 for d in dy2]).any(dim=0)
        np.testing.assert_array_equal(
            keep.numpy(), (cover | py.isnan() | r2.isnan()).numpy())
        tangent += int((torch.stack(dy2).amin(dim=0) == r2).sum())
    assert tangent > 50  # pairs kept at equality
    counts = csr6.band_rows(rows, b["starts"], W, H)
    tiles = csr6.tile_rows(b["starts"], W, H)
    assert bool((counts <= 8 * tiles).all()) and 0 < int(counts.sum()) \
        < 4 * int(tiles.sum())
    # The bottom tile row holds rows 64-89: band 7 (92-95) lies below.
    tiles_x, _ = csr6.grid_shape(W, H)
    assert bool((counts[-tiles_x:] <= 7 * tiles[-tiles_x:]).all())
    for y in (0, 37, 89):
        np.testing.assert_array_equal(
            csr6.band_keeps(py, r2, torch.tensor(y + 0.5), band=1).numpy(),
            ((((y + 0.5) - py) ** 2 <= r2) | py.isnan() | r2.isnan()).numpy())
    pixel_rows = csr6.band_rows(rows, b["starts"], W, H, band=1)
    assert bool((counts <= pixel_rows).all())
    assert bool((pixel_rows <= csr6.BAND_ROWS * counts).all())


@pytest.mark.parametrize("case", ["disc_ties", "wide_big", "invalid"])
def test_plain_disc8_matches_oracle_exactly(case):
    """Both plain 8-float walks against the NumPy oracle, bit for bit."""
    soup = disc_soup(tcam()) if case == "disc_ties" else make_soup(case)
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), W, H)
    assert (i_o >= 0).any(), "empty render — the comparison is vacuous"
    args, b = _disc_walk_inputs(soup, W, H)
    assert int(b["diag"]["big_overflow"]) == 0
    depth, index = csr6.raster_tiles_disc8(*args)
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  d_o.view(np.int32))
    d_uv, i_uv, _, _ = csr6.raster_tiles_disc8_uv(*args)
    np.testing.assert_array_equal(i_uv.numpy(), i_o)
    np.testing.assert_array_equal(d_uv.numpy().view(np.int32),
                                  d_o.view(np.int32))
    # The generic 16-float walk picks the same winners.
    d_g, i_g, _ = csr6.rasterize_csr6(soup, W, H)
    np.testing.assert_array_equal(i_g.numpy(), i_o)


@pytest.fixture(scope="module")
def small_scene():
    """The 64x64 two-tone scene (ground, two wide discs on the big list,
    300 discs with 40 exact depth ties) and its one interpret-mode Pallas
    render: discs_only with uniform_look, the fused walk, whose depth and
    id merge is _make_row_body8's with (u, v) carried along.  One jit
    around the whole call and ``unroll=1`` (one merge chain, the same
    winners) keep its compile small."""
    soup = disc_soup(tcam(SMALL, SMALL))
    jrgb, jdepth, jindex, jdiag = jax.jit(
        lambda s: jcsr6.render_shaded_csr6(
            s, jcam(SMALL, SMALL), JShading(), interpret=True,
            discs_only=True, uniform_look=LOOK, max_big=256, unroll=1,
            return_diag=True))(jax_soup(soup))
    return soup, dict(rgb=np.asarray(jrgb), depth=np.asarray(jdepth),
                      index=np.asarray(jindex),
                      diag={k: int(np.asarray(v)) for k, v in jdiag.items()})


def _assert_depth_matches_interpret(soup, depth, index, theirs):
    """Index equal; disc depth bits equal (the disc body has no
    multiply-add whose contraction could change a result); the ground's
    triangle depth goes through contracted multiply-adds in the
    interpreted kernel: within 4 ulp."""
    np.testing.assert_array_equal(index, theirs["index"])
    hit = index >= 0
    assert hit.any()
    disc = hit & (soup.kind.numpy()[np.maximum(index, 0)] == 0)
    np.testing.assert_array_equal(depth.view(np.int32)[disc],
                                  theirs["depth"].view(np.int32)[disc])
    ulp = np.abs(depth.view(np.int32).astype(np.int64)
                 - theirs["depth"].view(np.int32).astype(np.int64))
    assert ulp[hit].max() <= 4


def test_plain_disc8_matches_pallas_interpret(small_scene):
    """The plain 8-float walk == the interpret-mode discs_only Pallas
    walk: index and depth."""
    soup, theirs = small_scene
    depth, index, diag = csr6.rasterize_csr6(soup, SMALL, SMALL, max_big=256,
                                             discs_only=True)
    assert int(diag["big_overflow"]) == 0
    _assert_depth_matches_interpret(soup, depth.numpy(), index.numpy(),
                                    theirs)


def test_fused_uv_matches_pallas_interpret(small_scene):
    """The fused path against the interpret-mode fused Pallas render:
    index and depth as above, rgb within 2e-6; the wide discs on the big
    list are lit as lambert discs (tone 1), not flat tone 2."""
    soup, theirs = small_scene
    rgb, depth, index, diag = csr6.render_shaded_csr6(
        soup, tcam(SMALL, SMALL), ShadingConfig(), max_big=256,
        discs_only=True, uniform_look=LOOK)
    index = index.numpy()
    _assert_depth_matches_interpret(soup, depth.numpy(), index, theirs)
    np.testing.assert_allclose(rgb.numpy(), theirs["rgb"], rtol=0, atol=2e-6)
    assert int(diag["true_entries"]) == theirs["diag"]["true_entries"]
    assert int(diag["big_overflow"]) == theirs["diag"]["big_overflow"] == 0
    wide = (index >= 4) & (index < 6)  # the wide discs follow the ground
    assert wide.sum() > 50
    assert (rgb.numpy()[wide] < 0.999).all()  # lit gray, not the white tone
    oracle = cpu_reference.rasterize_reference(numpy_soup(soup), SMALL,
                                               SMALL)[1]
    np.testing.assert_array_equal(index, oracle)


def test_uniform_look_epilogues_match_jax():
    """shade_by_id(uniform_look) bit-equal to pallas_csr4._shade_by_id op
    by op; shade_uv over the plain (u, v) walk bit-equal to it (the same
    float32 expressions); the generic shade within 1e-6 (the ground's
    preshaded color is 1 - 6e-8, the second tone exactly 1)."""
    soup = disc_soup(tcam())
    jsoup = jax_soup(soup)
    shading, tc = ShadingConfig(), tcam()
    rgb_p, flag = csr6.preshade(soup, tc, shading)
    args, _ = _disc_walk_inputs(soup, W, H, flag=flag)
    depth, index, u, v = csr6.raster_tiles_disc8_uv(*args)
    ours = csr6.shade_by_id(soup, tc, shading, depth, index, rgb_p, flag,
                            uniform_look=LOOK)
    with jax.disable_jit():
        theirs, jindex = jcsr4._shade_by_id(
            jsoup, jcam(), JShading(), jnp.asarray(depth.numpy()),
            jnp.asarray(index.numpy().astype(np.float32)),
            jnp.asarray(rgb_p.numpy()), jnp.asarray(flag.numpy()),
            uniform_look=LOOK)
    np.testing.assert_array_equal(np.asarray(jindex), index.numpy())
    np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                  np.asarray(theirs).view(np.int32))
    fused = csr6.shade_uv(tc, shading, depth, u, v, LOOK)
    np.testing.assert_array_equal(fused.numpy().view(np.int32),
                                  ours.numpy().view(np.int32))
    # (u, v) mark exactly the disc winners; the ground carries +inf.
    kind = soup.kind.numpy()[np.maximum(index.numpy(), 0)]
    is_disc = (index.numpy() >= 0) & (kind == 0)
    np.testing.assert_array_equal(np.isfinite(u.numpy()), is_disc)
    np.testing.assert_array_equal(np.isfinite(v.numpy()), is_disc)
    generic = csr6.shade_by_id(soup, tc, shading, depth, index, rgb_p, flag)
    np.testing.assert_allclose(generic.numpy(), ours.numpy(), rtol=0,
                               atol=1e-6)
    # Flat mode ignores uniform_look, as in the JAX package.
    flat = ShadingConfig(mode="flat")
    rgb_f, flag_f = csr6.preshade(soup, tc, flat)
    np.testing.assert_array_equal(
        csr6.shade_by_id(soup, tc, flat, depth, index, rgb_f, flag_f,
                         uniform_look=LOOK).numpy(),
        csr6.shade_by_id(soup, tc, flat, depth, index, rgb_f,
                         flag_f).numpy())


FUSED_CASES = [
    (dict(discs_only=True, uniform_look=LOOK, max_big=256), True),
    (dict(discs_only=True, uniform_look=LOOK, max_big=511), True),
    (dict(discs_only=True, uniform_look=LOOK, max_big=512), False),
    (dict(discs_only=True, uniform_look=LOOK, max_big=256,
          allow_exit=True), False),
    (dict(discs_only=True, uniform_look=LOOK, max_big=256,
          allow_exit=False), True),
    (dict(uniform_look=LOOK, max_big=256), False),
    (dict(discs_only=True, max_big=256), False),
    (dict(discs_only=True, uniform_look=LOOK, max_big=256,
          shading=ShadingConfig(mode="flat")), False),
]


@pytest.mark.parametrize("kw,fused", FUSED_CASES)
def test_fused_path_taken_under_the_jax_condition(monkeypatch, kw, fused):
    """render() takes the fused walk exactly when the JAX package does
    (pallas_csr6.py:1717-1719) and every route gives the same winners."""
    calls = []
    real = csr6.shade_uv
    monkeypatch.setattr(csr6, "shade_uv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    soup = disc_soup(tcam())
    fb = render(soup, tcam(), RasterConfig(**kw))
    assert bool(calls) == fused
    ref = render(soup, tcam(), RasterConfig(max_big=256))
    np.testing.assert_array_equal(fb.index.numpy(), ref.index.numpy())
    np.testing.assert_array_equal(fb.depth.numpy(), ref.depth.numpy())
    if "shading" not in kw:
        np.testing.assert_allclose(fb.rgb.numpy(), ref.rgb.numpy(), rtol=0,
                                   atol=1e-6)


def test_disc_lane_knob_errors():
    soup = disc_soup(tcam())
    zeros = torch.zeros((soup.count, 3))
    with pytest.raises(ValueError, match="requires discs_only"):
        csr6._raster_core6(soup, W, H, 256, zeros, zeros[:, 0],
                           fused_uv=True)
    with pytest.raises(ValueError, match="resident big list"):
        csr6._raster_core6(soup, W, H, 512, zeros, zeros[:, 0],
                           discs_only=True, fused_uv=True)
    with pytest.raises(ValueError, match="exclusive"):
        check_config(RasterConfig(three_tone=(0, 1, 2), uniform_look=LOOK))
    with pytest.raises(ValueError, match="3 or 5"):
        check_config(RasterConfig(three_tone=(0, 1)))
    check_config(RasterConfig(three_tone=(0, 1, 2)))  # ported with droplets
    # A JAX config with array tones converts to a hashable port config.
    cfg = convert.raster_config_from_fields(JRasterConfig(
        discs_only=True, max_big=256,
        uniform_look=(np.float32([0.3] * 3), [1, 1, 1])))
    assert cfg == RasterConfig(discs_only=True, max_big=256,
                               uniform_look=((np.float32(0.3),) * 3,
                                             (1.0,) * 3))
    hash(cfg)


def test_disc8_wrapper_dispatch():
    """CPU tensors take the plain walks without counting a launch; a
    device with no kernel raises instead of falling back."""
    args, _ = _disc_walk_inputs(disc_soup(tcam()), W, H)
    for wrapper, plain in (
            (csr6.raster_tiles_disc8, csr6.raster_tiles_disc8_plain),
            (csr6.raster_tiles_disc8_uv, csr6.raster_tiles_disc8_uv_plain)):
        before = wrapper.launches
        got, want = wrapper(*args), plain(*args)
        assert wrapper.launches == before
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        with pytest.raises(ValueError, match="no csr6 kernel"):
            wrapper(*(a.to("meta") for a in args[:4]), W, H)
        with pytest.raises(ValueError, match="rows8"):
            wrapper(args[0][:, :4], *args[1:])
        with pytest.raises(ValueError, match="big_rows"):
            wrapper(args[0], args[1][:, :8], *args[2:])


def test_dynamics_match_jax():
    """advect and motion_colors bit-equal to the JAX functions evaluated
    op by op; the endpoints of the speed ramp."""
    rng = np.random.default_rng(8)
    pos = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    vel = rng.normal(0, 6, (200, 3)).astype(np.float32)
    vel[:2] = [[0, 0, 0], [20.0, 0, 0]]
    with jax.disable_jit():
        jadv = jdynamics.advect(jnp.asarray(pos), jnp.asarray(vel), 0.05)
        jcol = jdynamics.motion_colors(jnp.asarray(vel))
    adv = dynamics.advect(torch.tensor(pos), torch.tensor(vel), 0.05)
    col = dynamics.motion_colors(torch.tensor(vel))
    np.testing.assert_array_equal(adv.numpy(), np.asarray(jadv))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    np.testing.assert_allclose(col.numpy()[0], [0.2, 0.4, 1.0], atol=1e-6)
    np.testing.assert_allclose(col.numpy()[1], [1.0, 0.3, 0.1], atol=1e-6)


@pytest.mark.parametrize("span", [4, 8])
def test_discs_only_wide_span_binning_matches_jax(span):
    """The (key, prim) pairs of the binned prefix, the range starts and the
    big list equal _bin_csr6(discs_only=True) at spans 4 and 8."""
    soup = wide_disc_soup()
    w, h = SPAN8_FILM
    tiles_x, tiles_y = csr6.grid_shape(w, h)
    n_keys = tiles_x * tiles_y * span * span
    b = csr6.bin_csr6(soup, w, h, 1024, discs_only=True, span=span)
    keys, prims, big_ids, big_count, _, n_small = jax.jit(
        lambda s: jcsr6._bin_csr6(
            s, 32, 32, tiles_x * tiles_y, tiles_x, tiles_y, max_big=1024,
            discs_only=True, span=span, with_z=False))(jax_soup(soup))
    keys = np.asarray(keys).astype(np.int64)
    n_small = int(np.asarray(n_small))
    starts = b["starts"].numpy()
    np.testing.assert_array_equal(
        starts, np.searchsorted(keys[:n_small], np.arange(n_keys + 1)))
    ours = np.repeat(np.arange(n_keys), np.diff(starts))
    order = b["order"].numpy()[:n_small]
    theirs = np.asarray(prims)[:n_small]
    np.testing.assert_array_equal(
        np.stack([ours, order])[:, np.lexsort((order, ours))],
        np.stack([keys[:n_small], theirs])[
            :, np.lexsort((theirs, keys[:n_small]))])
    assert int(b["big_count"]) == int(np.asarray(big_count))
    nb = int(b["big_n"][0])
    assert set(b["big_ids"].numpy()[:nb]) == set(np.asarray(big_ids)[:nb])
    # The wider span bins discs that ride the big list one span down.
    narrower = csr6.bin_csr6(soup, w, h, 1024, discs_only=True,
                             span=span // 2)
    assert int(b["big_count"]) < int(narrower["big_count"])


@functools.cache
def _wide_disc_references():
    """(soup, flag, oracle depth, oracle index, span-2 (u, v)) of the
    wide-disc film, shared by the span-4 and span-8 cases."""
    soup = wide_disc_soup()
    w, h = SPAN8_FILM
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), w, h)
    _, flag = csr6.preshade(soup, tcam(w, h), ShadingConfig())
    args2, _ = _disc_walk_inputs(soup, w, h, 1024, flag)
    return soup, flag, d_o, i_o, csr6.raster_tiles_disc8_uv(*args2)[2:]


@pytest.mark.parametrize("span", [4, 8])
def test_plain_disc8_wide_spans_match_oracle(span):
    """Both plain 8-float walks at spans 4 and 8 equal the NumPy oracle
    bit for bit and the 16-float walk at the same span; (u, v) equal the
    span-2 walk's (the same winners, wide discs binned or big)."""
    soup, flag, d_o, i_o, (u2, v2) = _wide_disc_references()
    w, h = SPAN8_FILM
    assert (i_o >= 0).mean() > 0.5
    args, b = _disc_walk_inputs(soup, w, h, 1024, flag, span)
    assert int(b["diag"]["big_overflow"]) == 0
    depth, index = csr6.raster_tiles_disc8(*args, span=span)
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  d_o.view(np.int32))
    d_uv, i_uv, u, v = csr6.raster_tiles_disc8_uv(*args, span=span)
    np.testing.assert_array_equal(i_uv.numpy(), i_o)
    np.testing.assert_array_equal(d_uv.numpy().view(np.int32),
                                  d_o.view(np.int32))
    for a, b2 in ((u, u2), (v, v2)):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b2.numpy().view(np.int32))
    d16, i16, _ = csr6.rasterize_csr6(soup, w, h, 1024, span=span)
    np.testing.assert_array_equal(i16.numpy(), i_o)
    np.testing.assert_array_equal(d16.numpy().view(np.int32),
                                  d_o.view(np.int32))


def test_fused_render_at_span4_matches_shade_by_id():
    """render_shaded_csr6(discs_only, uniform_look, span=4) takes the fused
    walk (the JAX condition holds at any span) and equals the
    shade_by_id(uniform_look) epilogue on its own buffers, and render()
    with the same config."""
    soup = wide_disc_soup()
    w, h = SPAN8_FILM
    cam, shading = tcam(w, h), ShadingConfig()
    rgb, depth, index, diag = csr6.render_shaded_csr6(
        soup, cam, shading, max_big=256, discs_only=True, uniform_look=LOOK,
        span=4)
    assert int(diag["big_overflow"]) == 0
    rgb_p, flag = csr6.preshade(soup, cam, shading)
    by_id = csr6.shade_by_id(soup, cam, shading, depth, index, rgb_p, flag,
                             uniform_look=LOOK)
    np.testing.assert_array_equal(rgb.numpy().view(np.int32),
                                  by_id.numpy().view(np.int32))
    fb = render(soup, cam, RasterConfig(discs_only=True, uniform_look=LOOK,
                                        max_big=256, span=4))
    np.testing.assert_array_equal(fb.rgb.numpy().view(np.int32),
                                  rgb.numpy().view(np.int32))
    np.testing.assert_array_equal(fb.index.numpy(), index.numpy())
