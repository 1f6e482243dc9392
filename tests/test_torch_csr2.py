"""The plain backends (ROADMAP fault C1) and the strip-tiled ``pallas``
backend (v2, ``raster/csr2.py``, row 4 of the kernel table) with v1
(``raster/csr.py``, row 5), held against the JAX package on the CPU.

* C1: ``cpu``, ``tiled`` and ``bruteforce`` render ``rows9=True`` equal
  to ``cpu_reference`` bit for bit, shade through ``shade_framebuffer``
  (rgb equal to the JAX one under ``uniform_look`` too), and the configs
  that v6's checks rejected render under the backends that accept them.
* ``bin_csr`` against the JAX ``_bin_csr`` (keys, the stable order, the
  big list, its count) at ``max_tiles_per_prim`` 2 and 8 with the force
  flags, ``true_entry_count`` and ``bin_diagnostics``, under one jit.
* The plain v1, v2 and v2 disc walks against ``cpu_reference`` on mixed,
  disc-with-ties and wide-disc soups.
* One interpret-mode call each of ``rasterize_pallas_csr`` (a big list
  past ``max_big``) and ``rasterize_pallas_csr2`` (an ``entry_capacity``
  cut and a big overflow): index equal, depth within the interpret
  mode's contraction bound, disc depth bit for bit.
* ``FramePipeline(backend="pallas")`` against the JAX one at a traj_ball
  frame, and the mirrored ``RuntimeError`` past 1024 big prims; the
  wrappers' dispatch.
The CUDA kernels run only on a card: ``test_torch_cuda.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr as jcsr
from pointcloud_render_tpu.raster import pallas_csr2 as jcsr2
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu.shading.shade import shade_framebuffer
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr, csr2
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.run import pipeline
from tests.torch_jax import jax_soup, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    NEAR_ORIGIN,
    TARGET,
    H,
    W,
    cloud,
    droplet_soup,
    make_soup,
    tcam,
)

LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))
# Interpret mode runs the Pallas body as XLA CPU code, which contracts
# multiply-adds: capsule and triangle depth move by a few ulp (the bound
# of the v6 interpret test), disc depth not at all.
INTERPRET_ULP = 4
# test_torch_pipeline.test_frame_matches_jax_pipeline's bounds.
DEPTH_ULP = 8
RGB_ATOL = 3e-5
PLAIN = ("cpu", "tiled", "bruteforce")
# The interpret-mode calls render a crop of the soups' film: 2 x 6 strip
# tiles, the last column and row partial (interpret mode costs per tile).
IW, IH = 136, 44


def _bits(a):
    return np.asarray(a).view(np.int32)


def _ulp(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


@functools.cache
def _case(case):
    """(soup, oracle depth, oracle index) of a seeded case, made once."""
    soup = (droplet_soup(tcam(origin=NEAR_ORIGIN)) if case == "droplets"
            else make_soup(case))
    return (soup, *cpu_reference.rasterize_reference(numpy_soup(soup), W,
                                                     H))


def _assert_oracle(depth, index, case):
    _, d_o, i_o = _case(case)
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(_bits(depth.numpy()), _bits(d_o))
    assert (i_o >= 0).any()


def test_plain_backends_are_exact_and_shade_framebuffer():
    """C1: the plain backends ignore rows9 (their depth bits were 3 off the
    oracle when they took the rows9 walk) and shade through
    shade_framebuffer, which ignores uniform_look: rgb equals the JAX
    shade_framebuffer's bit for bit."""
    soup, d_o, i_o = _case("droplets")
    cam = tcam(origin=NEAR_ORIGIN)
    jcam_near = JCamera(origin=jnp.array(NEAR_ORIGIN, jnp.float32),
                        target=jnp.array(TARGET, jnp.float32), width=W,
                        height=H)
    with jax.disable_jit():
        want = np.asarray(shade_framebuffer(
            jax_soup(soup), jcam_near, jnp.asarray(d_o), jnp.asarray(i_o),
            JShading()))
    for backend in PLAIN:
        fb, diag = render(soup, cam, RasterConfig(backend=backend, rows9=True),
                          return_diag=True)
        _assert_oracle(fb.depth, fb.index, "droplets")
        assert int(diag["true_entries"]) == int(diag["big_overflow"]) == 0
        looked = render(soup, cam, RasterConfig(backend=backend,
                                                uniform_look=LOOK))
        for rgb in (fb.rgb, looked.rgb):
            np.testing.assert_array_equal(_bits(rgb.numpy()), _bits(want))


@pytest.mark.parametrize("cfg,v6_renders", [
    (RasterConfig(backend="tiled", rows9=True, bin_triangles=True), False),
    (RasterConfig(backend="cpu", discs_only=True, span=4), True),
    (RasterConfig(backend="pallas4", cap_rows10=True, discs_only=True),
     False),
    (RasterConfig(backend="pallas", rows9=True, span=3, cap_rows10=True,
                  uniform_look=LOOK, three_tone=(0, 1, 2)), False),
], ids=["tiled_rows9_bin_triangles", "cpu_discs_only_span4",
        "pallas4_cap10_discs_only", "pallas_v6_knobs"])
def test_configs_v6_rejects_render_elsewhere(cfg, v6_renders):
    """The JAX package renders these; only the v6 backends check v6's
    combinations (and still do).  discs_only at span 4 renders under
    pallas6 too since the 8-float disc walks take spans 4 and 8."""
    check_config(cfg)
    soup, _, _ = _case("droplets")
    fb = render(soup, tcam(origin=NEAR_ORIGIN), cfg)
    _assert_oracle(fb.depth, fb.index, "droplets")
    v6 = dataclasses.replace(cfg, backend="pallas6")
    if v6_renders:
        check_config(v6)
        fb = render(soup, tcam(origin=NEAR_ORIGIN), v6)
        _assert_oracle(fb.depth, fb.index, "droplets")
        return
    with pytest.raises((ValueError, NotImplementedError)):
        check_config(v6)


# (max_tiles_per_prim, force_tri_big, force_capsule_big, tile_h, tile_w)
BINNINGS = ((2, False, False, 8, 128), (8, False, False, 8, 128),
            (2, True, False, 8, 128), (8, True, True, 8, 128),
            (4, False, False, 16, 32))


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_binnings(js, max_big):
    out = []
    for mtp, ftri, fcap, th, tw in BINNINGS:
        tx, ty = -(-W // tw), -(-H // th)
        out.append(jcsr._bin_csr(js, W, H, th, tw, mtp, max_big, tx * ty, tx,
                                 ty, force_tri_big=ftri,
                                 force_capsule_big=fcap)[:4])
    diags = [jcsr2.true_entry_count(js, W, H, no_triangles=nt)
             for nt in (False, True)]
    diags += [jcsr.bin_diagnostics(js, W, H, max_big=max_big,
                                   no_triangles=nt, discs_only=do)
              for nt, do in ((False, False), (True, False), (False, True))]
    return out, diags


@pytest.mark.parametrize("case", ["invalid", "near_clip"])
def test_bin_csr_and_diagnostics_match_jax(case):
    """Keys, the stable (key, prim id) order, the big list by rank (-1
    empty) and its count bit for bit at spans of 2 and 8 tiles, with the
    force flags and a non-default tile shape; the certificates too (the
    soups hold invalid rows with NaN params, ground and near-clipped
    triangles, capsules)."""
    soup, _, _ = _case(case)
    max_big = 6
    jb, jd = _jax_binnings(jax_soup(soup), max_big)
    for (mtp, ftri, fcap, th, tw), (keys, prims, big, count) in zip(
            BINNINGS, jb):
        b = csr.bin_csr(soup, W, H, th, tw, mtp, max_big, ftri, fcap)
        np.testing.assert_array_equal(b["keys"].numpy(), np.asarray(keys))
        np.testing.assert_array_equal(b["prims"].numpy(), np.asarray(prims))
        np.testing.assert_array_equal(b["big_ids"].numpy(), np.asarray(big))
        assert int(b["big_count"]) == int(count)
        if not fcap:
            assert int(b["starts"][-1]) == int(
                csr.count_entries(soup, W, H, th, tw, mtp, ftri))
    ours = [csr2.true_entry_count(soup, W, H, no_triangles=nt)
            for nt in (False, True)]
    ours += [csr.bin_diagnostics(soup, W, H, max_big=max_big,
                                 no_triangles=nt, discs_only=do)
             for nt, do in ((False, False), (True, False), (False, True))]
    assert [int(x) for x in ours] == [int(x) for x in jd]
    assert int(ours[-1]) > 0  # discs_only big-lists capsules and triangles


@pytest.mark.parametrize("walk", ["v1", "v2", "v2_discs_only"])
@pytest.mark.parametrize("case", ["mixed", "ties", "wide_big", "droplets"])
def test_plain_walks_match_oracle(case, walk):
    """Winners and depth bits of the plain v1, v2 and v2 disc walks equal
    the oracle's (disc rows: capsules and triangles on the big list)."""
    soup = _case(case)[0]
    if walk == "v1":
        depth, index, diag = csr.rasterize_csr(soup, W, H)
    else:
        depth, index, diag = csr2.rasterize_csr2(
            soup, W, H, discs_only=walk == "v2_discs_only")
    _assert_oracle(depth, index, case)
    assert int(diag["big_overflow"]) == 0 and int(diag["true_entries"]) > 0


def _interpret_check(got, want, soup):
    (depth, index), (jd, ji) = got, (np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(index.numpy(), ji)
    hit = ji >= 0
    assert _ulp(depth.numpy(), jd)[hit].max() <= INTERPRET_ULP
    kind = soup.kind.numpy()[np.maximum(ji, 0)]
    disc = hit & (kind == 0)
    assert disc.any()
    np.testing.assert_array_equal(_bits(depth.numpy())[disc], _bits(jd)[disc])


def test_v1_matches_pallas_interpret_with_big_overflow():
    """v1 honours max_big: 33 big prims (wide discs past 4 tiles, the
    ground) on a big list of 16 drop the same 17 in both packages."""
    soup = _case("wide_big")[0]
    want = jcsr.rasterize_pallas_csr(jax_soup(soup), IW, IH,
                                     max_tiles_per_prim=4, max_big=16,
                                     interpret=True)
    depth, index, diag = csr.rasterize_csr(soup, IW, IH,
                                           max_tiles_per_prim=4, max_big=16)
    assert int(diag["big_overflow"]) > 0
    _interpret_check((depth, index), want, soup)


def test_v2_matches_pallas_interpret_with_capacity_cut():
    """v2 with entries cut to 2/3 of true_entries and a big list of 16:
    the same entries and big prims are dropped in both packages."""
    soup = _case("wide_big")[0]
    cap = 2 * int(csr2.true_entry_count(soup, IW, IH)) // 3
    want = jcsr2.rasterize_pallas_csr2(jax_soup(soup), IW, IH, max_big=16,
                                       entry_capacity=cap, interpret=True)
    depth, index, diag = csr2.rasterize_csr2(soup, IW, IH, max_big=16,
                                             entry_capacity=cap)
    assert int(diag["true_entries"]) > cap and int(diag["big_overflow"]) > 0
    _interpret_check((depth, index), want, soup)
    full = csr2.rasterize_csr2(soup, IW, IH)
    assert int((full[1] != index).sum()) > 0  # the cut dropped winners


def test_pallas_pipeline_matches_jax():
    """FramePipeline(backend="pallas") against the JAX package's at one
    traj_ball frame: 0 winner flips, depth and rgb within the bounds of
    test_frame_matches_jax_pipeline (the soups differ by XLA's
    contraction there)."""
    pos, vel = cloud()
    pcl = np.concatenate([pos, vel], axis=1)
    fw, fh = 160, 96
    fb = pipeline.FramePipeline(PRESETS["traj_ball"],
                                RasterConfig(backend="pallas"), width=fw,
                                height=fh, device="cpu").render_array(pcl, 120)
    jfb = jpipe.FramePipeline(JAX_PRESETS["traj_ball"],
                              JRasterConfig(backend="pallas"), width=fw,
                              height=fh).render_array(pcl, 120)
    index = fb.index.numpy()
    assert int((index != np.asarray(jfb.index)).sum()) == 0
    hit = index >= 0
    assert hit.any()
    assert _ulp(fb.depth.numpy(), np.asarray(jfb.depth))[hit].max() \
        <= DEPTH_ULP
    assert np.abs(fb.rgb.numpy() - np.asarray(jfb.rgb)).max() <= RGB_ATOL


def test_pallas_big_list_past_1024_raises():
    """v2 never receives max_big (the JAX package's render does not
    forward it): the pipeline's self-heal raises max_big to no effect and
    a frame of more than 1024 big prims fails with RuntimeError."""
    n = 1100
    rng = np.random.default_rng(8)
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    # Discs ~100 px tall on a 16 px wide film of 9 strip rows: each spans
    # more than max_tiles_per_prim (8) tiles and rides the big list.
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=8.0)
    pipe = pipeline.FramePipeline(preset, RasterConfig(backend="pallas"),
                                  width=16, height=72, device="cpu")
    with pytest.raises(RuntimeError, match="after capacity retries"):
        pipe.render_array(pos, 120)
    assert pipe.raster_config.max_big > 1024


def test_wrappers_dispatch_and_validate():
    """CPU tensors take the plain walk without counting a launch (and
    report each tile's whole range as walked); a device with no kernel
    and malformed inputs raise."""
    soup = _case("ties")[0]
    b = csr.bin_csr(soup, W, H, max_tiles_per_prim=4)
    n = int(b["starts"][-1])
    rows = csr.pack_rows_generic(soup, b["prims"][:n], b["keys"][:n],
                                 b["zmin"], b["span"])
    rows8 = csr2.pack_rows_disc(soup, b["prims"][:n], b["keys"][:n],
                                b["zmin"], b["span"])
    big = csr.pack_big_rows(soup, b["big_ids"])
    args = (b["starts"], big, b["big_n"], W, H)
    counters = (csr.raster_tiles1, csr2.raster_tiles2,
                csr2.raster_tiles2_disc8)
    before = [c.launches for c in counters]
    lengths = b["starts"][1:] - b["starts"][:-1]
    for wrapper, r in ((csr.raster_tiles1, rows), (csr2.raster_tiles2, rows),
                       (csr2.raster_tiles2, rows8)):
        walked = torch.full_like(lengths, -1)
        got = wrapper(r, *args, walked=walked)
        want = csr.raster_strips_plain(r, *args)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(w.numpy()))
        np.testing.assert_array_equal(walked.numpy(), lengths.numpy())
    assert [c.launches for c in counters] == before
    # 16- and 8-float rows walk the same winners here (discs only).
    np.testing.assert_array_equal(
        csr2.raster_tiles2(rows8, *args)[1].numpy(),
        csr2.raster_tiles2(rows, *args)[1].numpy())
    with pytest.raises(ValueError, match="no csr2_raster kernel"):
        csr2.raster_tiles2(rows.to("meta"), *(a.to("meta") for a in args[:3]),
                           W, H)
    with pytest.raises(ValueError, match="starts does not match"):
        csr.raster_tiles1(rows, b["starts"][:-1], *args[1:])
    with pytest.raises(ValueError, match="rows must be"):
        csr.raster_tiles1(rows8, *args)
    with pytest.raises(ValueError, match="walked"):
        csr2.raster_tiles2(rows, *args, walked=lengths[:-1].clone())
    with pytest.raises(ValueError, match="tile shape"):
        csr.bin_csr(soup, W, H, tile_h=0)
    with pytest.raises(ValueError, match="2\\^24"):
        big_soup = dataclasses.replace(
            soup, kind=torch.zeros((), dtype=torch.int32).expand(1 << 24))
        csr2.rasterize_csr2(big_soup, W, H)
