"""The look passes of the port (``shading/aa.py``, the GGX lobe, GI fill
and shadow scale of ``shading/shade.py``, ``raster/tiles.py``,
``shading/shadow.py`` and ``FramePipeline``'s look branch), held against
the JAX package on the CPU.

* AA: ``gaussian_kernel`` bit-equal at ss 1, 2 and 3; ``downsample``
  within AA_ATOL of the JAX convolution and of ``downsample_reference``
  (the port sums its taps in a fixed order of its own); ss 1 returns its
  input.
* Shading: ``shade_framebuffer`` with ``ground_spec`` 0.5 and ``gi`` 0.25,
  with and without a seeded shadow factor, and ``shade_winner_attrs``
  with the GI fill on and off and in flat mode, within SHADE_ATOL of the
  jitted JAX functions (XLA contracts their multiply-adds; the port
  evaluates one IEEE operation at a time, as the JAX functions do op by
  op).
* Tiles: ``bin_primitives`` (table, counts, big list, big count) and
  ``tile_overflow`` equal to the JAX functions under one jit (integers
  only), on a soup that overflows both caps and on one that does not.
* Shadow: ``light_camera`` equal to the JAX one; ``render_shadow_depth``
  at 64x64 on an overflowing light-view soup: the JAX ``tiled`` winners,
  depth within SHADOW_DEPTH_ULP; ``shadow_factor`` at taps 0 and 12
  against the jitted JAX function: equal at taps 0; at taps 12 equal but
  on at most SHADOW_FACTOR_PIXELS pixels, each within (1 - min_light) /
  taps.
* Frame: traj_ball, 300 points, 160x96 at ss 2 with the shadow map at 128,
  ``ground_spec`` 0.5 and ``gi`` 0.25, against the jitted JAX
  ``FramePipeline`` (one compile, frames 120 and 205): no winner flip,
  depth within DEPTH_ULP, rgb within the bounds below; depth and index
  equal the port's plain render of the 320x192 film sliced [::2, ::2].
* CLI: the four look flags parse to the configs of the JAX ``run``.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.cli import main as jmain
from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.raster import tiles as jtiles
from pointcloud_render_tpu.raster import xla_tiled
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.shading import aa as jaa
from pointcloud_render_tpu.shading import shade as jshade
from pointcloud_render_tpu.shading import shadow as jshadow
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu_torch.cli import main as tmain
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr6, tiles
from pointcloud_render_tpu_torch.raster.primitives import KIND_DISC
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.shading import aa, shadow
from pointcloud_render_tpu_torch.shading.shade import (
    ShadingConfig,
    shade_framebuffer,
    shade_winner_attrs,
)
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import jax_soup, jcam
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import H, W, cloud, make_soup, mixed_soup, tcam

# downsample: a sum of 16 ss^2 products in another order than XLA's
# convolution (measured: 2.4e-7 at ss 2, 4.8e-7 at ss 3 against it;
# 3e-7 and 7.2e-7 against the float64-accumulated NumPy oracle).
AA_ATOL = 1e-6
# Shading against the jitted JAX functions: the bound of
# test_torch_v5.test_fused_shade_matches_shade_framebuffer (measured:
# 1.2e-7 without the shadow factor, 1.8e-7 with it).
SHADE_ATOL = 2e-6
# shadow_factor at taps 12 against the jitted JAX function, whose
# contraction moves min_light + (1 - min_light) * vis by an ulp and may move
# a tap's re-projection across a texel edge: a pixel's factor then moves by
# at most (1 - min_light) / taps (measured: 129 pixels of 13,500, by 6e-8).
# At taps 0 the two are equal.
SHADOW_FACTOR_PIXELS = 400
# The light view's depth against the JAX tiled backend, whose evaluation
# XLA contracts (ROADMAP queue C: up to 3 ulp on the plain backends;
# measured 3 here).
SHADOW_DEPTH_ULP = 4
# The frame against the jitted JAX FramePipeline: the bounds of
# test_torch_pipeline.test_frame_matches_jax_pipeline for the winners;
# rgb within RGB_ATOL except on at most RGB_FAR_PIXELS pixels, where
# XLA's contraction of the shadow test's re-projection moves a poisson
# tap to a neighbouring texel: such a pixel's factor moves by a multiple
# of (1 - min_light) / taps, its diffuse term by at most that times
# diffuse, and the filter spreads it (measured: frame 120 2.2e-6 on every
# pixel; frame 205 27 pixels past RGB_ATOL, up to 0.0046).
DEPTH_ULP = 8
RGB_ATOL = 3e-5
RGB_FAR_PIXELS = 64
RGB_FAR_ATOL = (1 - 0.35) / 12 * 0.7
FRAME_W, FRAME_H = 160, 96
LOOK = dict(shadows=True, shadow_size=128, ground_spec=0.5, gi=0.25)


def _bits(t):
    return np.asarray(t).view(np.int32)


def _ulp(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b))


@functools.lru_cache(maxsize=None)
def _scene():
    """A soup on the tests' film, its exact winners (the plain v6 walk)
    and a seeded shadow factor."""
    cam = tcam()
    soup = mixed_soup(cam, n=300, trails=30, seed=7)
    depth, index, _ = csr6.rasterize_csr6(soup, W, H, plain=True)
    rng = np.random.default_rng(1)
    sf = rng.uniform(0.35, 1.0, (H, W)).astype(np.float32)
    return cam, soup, depth, index, sf


# --- AA --------------------------------------------------------------------

@pytest.mark.parametrize("ss", [1, 2, 3])
def test_gaussian_kernel_matches_jax(ss):
    np.testing.assert_array_equal(aa.gaussian_kernel(ss),
                                  jaa.gaussian_kernel(ss))


@pytest.mark.parametrize("ss", [2, 3])
def test_downsample_matches_jax(ss):
    rng = np.random.default_rng(5)
    hi = rng.uniform(0, 1, (11 * ss, 13 * ss, 3)).astype(np.float32)
    ours = aa.downsample(torch.tensor(hi), ss).numpy()
    assert ours.shape == (11, 13, 3)
    np.testing.assert_allclose(ours, np.asarray(jaa.downsample(
        jnp.asarray(hi), ss)), rtol=0, atol=AA_ATOL)
    np.testing.assert_allclose(ours, jaa.downsample_reference(hi, ss),
                               rtol=0, atol=AA_ATOL)


def test_downsample_at_ss1_is_the_identity():
    rgb = torch.rand(5, 7, 3, generator=torch.Generator().manual_seed(3))
    assert aa.downsample(rgb, 1) is rgb


# --- shading ---------------------------------------------------------------

@pytest.mark.parametrize("with_shadow", [False, True])
def test_shade_framebuffer_look_matches_jax(with_shadow):
    cam, soup, depth, index, sf = _scene()
    look = dict(ground_spec=0.5, gi=0.25)
    ours = shade_framebuffer(soup, cam, depth, index, ShadingConfig(**look),
                             shadow=torch.tensor(sf) if with_shadow else None)
    theirs = jax.jit(lambda s, d, i, f: jshade.shade_framebuffer(
        s, jcam(), d, i, JShading(**look), shadow=f))(
        jax_soup(soup), jnp.asarray(depth.numpy()),
        jnp.asarray(index.numpy()), jnp.asarray(sf) if with_shadow else None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=SHADE_ATOL)
    # Every term shows: the lobe on the ground, the fill on discs.
    plain = shade_framebuffer(soup, cam, depth, index, ShadingConfig())
    kind = soup.kind[torch.clamp(index, min=0).long()]
    changed = (ours != plain).any(-1) & (index >= 0)
    assert bool(changed[kind == 2].any()) and bool(changed[kind == 0].any())


@pytest.mark.parametrize("mode,gi", [("lambert", 0.0), ("lambert", 0.25),
                                     ("flat", 0.25)])
def test_shade_winner_attrs_matches_jax(mode, gi):
    cam, soup, depth, index, _ = _scene()
    safe = torch.clamp(index, min=0).long()
    kind = soup.kind[safe]
    # Discs carry their radius, capsules -1, triangles 0 (pre-lit).
    rflag = torch.where(kind == KIND_DISC, soup.params[safe, 3],
                        torch.where(kind == 1, torch.full_like(depth, -1.0),
                                    torch.zeros_like(depth)))
    px, py, rgb = soup.params[safe, 0], soup.params[safe, 1], soup.color[safe]
    hit = index >= 0
    cfg = dict(mode=mode, gi=gi)
    ours = shade_winner_attrs(px, py, rflag, rgb, hit, cam,
                              ShadingConfig(**cfg))
    theirs = jax.jit(lambda *a: jshade.shade_winner_attrs(
        *a, jcam(), JShading(**cfg)))(
        *(jnp.asarray(t.numpy()) for t in (px, py, rflag, rgb, hit)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=SHADE_ATOL)


# --- tiles -----------------------------------------------------------------

@pytest.mark.parametrize("caps", [(32, 1), (512, 64)], ids=["overflow",
                                                             "fits"])
def test_bin_primitives_matches_jax(caps):
    soup = make_soup("wide_big")  # wide discs: two on the big list
    kw = dict(max_per_tile=caps[0], max_big=caps[1])
    ours = tiles.bin_primitives(soup, W, H, **kw)
    theirs, drop = jax.jit(lambda s: (jtiles.bin_primitives(s, W, H, **kw),
                                      jtiles.tile_overflow(s, W, H, **kw)))(
        jax_soup(soup))
    for name in ("table", "counts", "big_list", "big_count"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    assert (ours.tiles_y, ours.tiles_x) == (theirs.tiles_y, theirs.tiles_x)
    dropped = int(tiles.tile_overflow(soup, W, H, **kw))
    assert dropped == int(drop) == int(ours.overflowed)
    assert (dropped > 0) == (caps[0] == 32)
    if caps[0] == 32:  # both caps overflow
        assert int(ours.big_count) > 1 and int(ours.counts.max()) > 32


# --- shadow ----------------------------------------------------------------

def test_light_camera_matches_jax():
    ours = shadow.light_camera(size=64, device="cpu")
    theirs = jshadow.light_camera(size=64)
    assert (ours.fov_x_degrees, ours.width, ours.height) == (
        theirs.fov_x_degrees, theirs.width, theirs.height)
    np.testing.assert_array_equal(
        _bits(ours.world_to_camera_matrix().numpy()),
        _bits(jax.jit(lambda c: c.world_to_camera_matrix())(theirs)))


def test_shadow_depth_matches_jax_tiled_past_the_cap():
    pos, vel = cloud(n=1500, seed=3)
    light = shadow.light_camera(size=64, device="cpu")
    soup = pipeline.build_primitives(PRESETS["traj_ball"], light,
                                     torch.tensor(pos), torch.tensor(vel), 120)
    depth, index, diag = tiles.rasterize_tiled(
        soup, 64, 64, max_per_tile=shadow.SHADOW_MAX_PER_TILE)
    dropped = int(diag["dropped"])
    assert dropped == int(tiles.tile_overflow(
        soup, 64, 64, max_per_tile=shadow.SHADOW_MAX_PER_TILE)) > 1000
    assert torch.equal(shadow.render_shadow_depth(soup, light), depth)
    jd, ji = jax.jit(lambda s: xla_tiled.rasterize_tiled(
        s, 64, 64, max_per_tile=1024))(jax_soup(soup))
    np.testing.assert_array_equal(index.numpy(), np.asarray(ji))
    hit = index.numpy() >= 0
    assert hit.sum() > 1000
    assert _ulp(depth.numpy(), np.asarray(jd))[hit].max() <= SHADOW_DEPTH_ULP
    # The cap drops occluders: the uncapped walk finds nearer winners.
    full, _, full_diag = tiles.rasterize_tiled(soup, 64, 64,
                                               max_per_tile=1 << 14,
                                               max_big=1 << 14)
    assert int(full_diag["dropped"]) == 0
    assert bool((full < depth).any())


@pytest.mark.parametrize("taps", [0, 12])
def test_shadow_factor_matches_jax(taps):
    cam, soup, depth, index, _ = _scene()
    light = shadow.light_camera(size=64, device="cpu")
    pos, vel = cloud(n=300, seed=0)
    sdepth = shadow.render_shadow_depth(pipeline.build_primitives(
        PRESETS["traj_ball"], light, torch.tensor(pos), torch.tensor(vel),
        120), light)
    ours = shadow.shadow_factor(cam, depth, index, light, sdepth, taps=taps)
    theirs = jax.jit(lambda d, i, s: jshadow.shadow_factor(
        jcam(), d, i, jshadow.light_camera(size=64), s, taps=taps))(
        jnp.asarray(depth.numpy()), jnp.asarray(index.numpy()),
        jnp.asarray(sdepth.numpy()))
    if taps == 0:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    else:
        gap = np.abs(ours.numpy() - np.asarray(theirs))
        assert (gap > 0).sum() <= SHADOW_FACTOR_PIXELS
        assert gap.max() <= (1 - 0.35) / taps
    assert bool((ours < 1).any())


# --- the frame -------------------------------------------------------------

def _cfg(look):
    return dict(supersample=2, shading=ShadingConfig(**look))


def test_look_frame_matches_jax_pipeline():
    pos, vel = cloud()
    pcl = np.concatenate([pos, vel], axis=1)
    ours = pipeline.FramePipeline(PRESETS["traj_ball"],
                                  RasterConfig(**_cfg(LOOK)), width=FRAME_W,
                                  height=FRAME_H, device="cpu")
    plain = pipeline.FramePipeline(PRESETS["traj_ball"],
                                   width=2 * FRAME_W, height=2 * FRAME_H,
                                   device="cpu")
    # max_per_tile sized for the 320x192 film, which the JAX pipeline would
    # otherwise heal by compiling a second time.
    theirs = jpipe.FramePipeline(
        JAX_PRESETS["traj_ball"], JRasterConfig(
            max_per_tile=4096, supersample=2, shading=JShading(**LOOK)),
        width=FRAME_W, height=FRAME_H)
    for fi in (120, 205):
        fb = ours.render_array(pcl, fi)
        ref = plain.render_array(pcl, fi)
        np.testing.assert_array_equal(fb.index.numpy(),
                                      ref.index[::2, ::2].numpy())
        np.testing.assert_array_equal(_bits(fb.depth.numpy()),
                                      _bits(ref.depth[::2, ::2].numpy()))
        assert fb.rgb.shape == (FRAME_H, FRAME_W, 3)
        jfb = theirs.render_array(pcl, fi)
        index = fb.index.numpy()
        assert int((np.asarray(jfb.index) != index).sum()) == 0, fi
        hit = index >= 0
        assert _ulp(fb.depth.numpy(),
                    np.asarray(jfb.depth))[hit].max() <= DEPTH_ULP
        gap = np.abs(fb.rgb.numpy() - np.asarray(jfb.rgb)).max(-1)
        assert (gap > RGB_ATOL).sum() <= RGB_FAR_PIXELS, fi
        assert gap.max() <= RGB_FAR_ATOL, fi


# --- the CLI ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--supersample", "2", "--shadows", "--ground-spec", "0.5", "--gi",
     "0.25"],
    ["--shadows", "--backend", "tiled"]])
def test_cli_look_flags_match_jax(argv, monkeypatch):
    """The port's parser and config against the JAX ``run``'s, whose
    pipeline and batch run are stubbed to capture its config."""
    captured = {}

    class Capture:
        def __init__(self, preset, raster_config=None, **kw):
            captured["config"] = raster_config

    monkeypatch.setattr(jmain, "FramePipeline", Capture)
    monkeypatch.setattr(jmain, "run_batch", lambda *a, **k: None)
    jmain.run(jmain.build_parser("traj_ball").parse_args(argv), "traj_ball")
    args = tmain.build_parser("traj_ball").parse_args(argv)
    assert isinstance(args, argparse.Namespace)
    assert tmain.raster_config(args) == convert.raster_config_from_fields(
        captured["config"])
    for flag in ("supersample", "shadows", "ground_spec", "gi"):
        assert getattr(args, flag) == getattr(
            jmain.build_parser("traj_ball").parse_args(argv), flag)
