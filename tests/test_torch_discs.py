"""The ``discs_only`` lane of the port's v6 rasterizer (8-float disc rows,
the fused (u, v) shade, ``uniform_look``) and ``scene/dynamics.py``, held
against the JAX package on the CPU.

* Binning with ``discs_only`` (capsules ride the big list) matches
  ``pallas_csr6._bin_csr6`` / ``bin_diagnostics6``.
* ``build_table8`` and ``build_table16_rows`` are bit-equal to the JAX rows.
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
The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``.
"""

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
from tests.torch_soups import H, W, disc_soup, make_soup, tcam

LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))
SMALL = 64  # film edge of the interpret-mode runs (2x2 tiles)


def _disc_walk_inputs(soup, w, h, max_big=256, flag=None):
    b = csr6.bin_csr6(soup, w, h, max_big, discs_only=True)
    zeros = torch.zeros((soup.count, 3))
    flag = torch.zeros(soup.count) if flag is None else flag
    table8 = csr6.build_table8(soup, flag)
    big_rows = csr6.build_table16_rows(soup, zeros, flag, b["big_ids"])
    return (table8, big_rows, b["order"], b["starts"], b["big_n"], w, h), b


@pytest.mark.parametrize("max_big", [8, 256])
def test_discs_only_binning_matches_jax(max_big):
    """Big count, overflow and true_entries equal the JAX binning's; every
    valid capsule lands on the big list."""
    soup = make_soup("wide_big")
    jsoup = jax_soup(soup)
    b = csr6.bin_csr6(soup, W, H, max_big, discs_only=True)
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    # Integer results: one jit each instead of op-by-op dispatch.
    keys, _, _, jbig_count, _, jn_small = jax.jit(
        lambda s: jcsr6._bin_csr6(
            s, 32, 32, tiles_x * tiles_y, tiles_x, tiles_y, max_big=max_big,
            discs_only=True, with_z=False))(jsoup)
    jovf = jax.jit(lambda s: jcsr6.bin_diagnostics6(
        s, W, H, max_big=max_big, discs_only=True))(jsoup)
    n_small = int(np.asarray(jn_small))
    classes = np.bincount(np.asarray(keys)[:n_small].astype(np.int64) % 4,
                          minlength=4)
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
            wrapper(*(a.to("meta") for a in args[:5]), W, H)
        with pytest.raises(ValueError, match="table8"):
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
