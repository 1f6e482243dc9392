"""The port's v6 rasterizer module (``raster/csr6.py``) against the JAX
package.

* The plain tile walk (the CPU path of the CUDA kernel's wrapper) must
  match ``cpu_reference.rasterize_reference`` exactly — depth bits and
  winner index — on mixed soups: discs, capsules and the ground, exact
  depth ties, wide prims sent to the big list, invalid rows, near-clipped
  triangles and partial edge tiles (a 150x90 film).
* The stages around the kernel (binning certificate, the 16-float table,
  preshade, the shade epilogue) match their JAX counterparts bit for bit
  when JAX evaluates op by op.
* One interpret-mode Pallas run (64x64) holds the whole shaded v6 path
  against ``pallas_csr6.render_shaded_csr6``.
* The CUDA kernel itself runs only on a card: ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr3 as jcsr3
from pointcloud_render_tpu.raster import pallas_csr4 as jcsr4
from pointcloud_render_tpu.raster import pallas_csr6 as jcsr6
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu.shading.shade import (
    shade_framebuffer as jshade_framebuffer,
)
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.render import RasterConfig, rasterize
from pointcloud_render_tpu_torch.shading.shade import (
    ShadingConfig,
    shade_framebuffer,
)
from pointcloud_render_tpu_torch.utils import convert

from tests.torch_jax import jax_soup, jcam, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import CASES, H, W, make_soup, mixed_soup, tcam


SMALL = 64  # film edge of the scene two tests below share (2x2 tiles)


def small_mixed_soup():
    return mixed_soup(tcam(SMALL, SMALL), n=80, trails=8, seed=23)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_oracle_exactly(case):
    soup = make_soup(case)
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), W, H)
    assert (i_o >= 0).any(), "empty render — the comparison is vacuous"
    depth, index, diag = csr6.rasterize_csr6(soup, W, H)
    assert int(diag["big_overflow"]) == 0
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  d_o.view(np.int32))


@pytest.mark.parametrize("backend", ["auto", "tiled", "cpu"])
def test_rasterize_dispatch_matches_oracle(backend):
    """render.rasterize with the backends that reach the csr6 walk."""
    soup = make_soup("wide_big")
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), W, H)
    depth, index = rasterize(soup, W, H, RasterConfig(backend=backend))
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(depth.numpy(), d_o)


def test_plain_chunking_is_invisible(monkeypatch):
    """Tiny pair chunks (rows larger than a chunk, many boundaries) give
    the same buffers as one big chunk."""
    soup = make_soup("spill")
    b = csr6.bin_csr6(soup, W, H)
    table = csr6.build_table16(soup, torch.zeros((soup.count, 3)),
                               torch.zeros(soup.count))
    args = (table, b["order"], b["starts"], b["big_ids"], b["big_n"], W, H)
    d1, i1 = csr6.raster_tiles_plain(*args)
    monkeypatch.setattr(csr6, "PLAIN_PAIR_CHUNK", 37)
    d2, i2 = csr6.raster_tiles_plain(*args)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())


@pytest.mark.parametrize("max_big", [4, 8, 64])
def test_big_overflow_matches_jax(max_big):
    soup = make_soup("wide_big")
    theirs = int(np.asarray(jax.jit(lambda s: jcsr6.bin_diagnostics6(
        s, W, H, max_big=max_big))(jax_soup(soup))))
    ours = int(csr6.bin_diagnostics6(soup, W, H, max_big=max_big))
    assert ours == theirs
    if max_big < 40:
        assert ours > 0


def test_binning_layout():
    """Every binned prim sits in exactly the (anchor, class) range its
    bbox names; the big list holds the valid unbinnable prims."""
    soup = make_soup("spill")
    b = csr6.bin_csr6(soup, W, H)
    starts = b["starts"].numpy()
    order = b["order"].numpy()
    assert (np.diff(starts) >= 0).all()
    tiles_x, _ = csr6.grid_shape(W, H)
    bbox = soup.bbox.numpy()
    for pos in range(0, int(starts[-1]), 7):
        j = np.searchsorted(starts, pos, side="right") - 1
        pid = order[pos]
        tx0 = int(np.clip(np.floor(bbox[pid, 0] / 32), 0, tiles_x - 1))
        ty0 = int(np.clip(np.floor(bbox[pid, 2] / 32), 0, 10))
        assert j // 4 == ty0 * tiles_x + tx0
    n_big = int(b["big_n"][0])
    big = b["big_ids"].numpy()[:n_big]
    assert set(big) <= set(np.flatnonzero(soup.valid.numpy()))
    assert (b["big_ids"].numpy()[n_big:] == soup.count).all()


def test_tables_and_shading_match_jax():
    """table16, preshade and the shade epilogue bit-equal to the JAX
    functions evaluated op by op; the epilogue equals shade_framebuffer.
    The 64x64 scene of the interpret-mode test below: elementwise
    functions show the same on it, and that test then finds JAX's
    op-by-op programs for these shapes compiled."""
    soup = small_mixed_soup()
    jsoup = jax_soup(soup)
    w = h = SMALL
    jc, tc = jcam(w, h), tcam(w, h)
    shading = ShadingConfig()
    for mode in ("lambert", "flat"):
        shading = ShadingConfig(mode=mode)
        jshading = JShading(mode=mode)
        with jax.disable_jit():
            jrgb, jflag = jcsr3._preshade(jsoup, jc, jshading)
            jtable = jcsr4._build_table16(jsoup, jrgb, jflag)
        rgb, flag = csr6.preshade(soup, tc, shading)
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
        np.testing.assert_array_equal(flag.numpy(), np.asarray(jflag))
        np.testing.assert_array_equal(
            csr6.build_table16(soup, rgb, flag).numpy(), np.asarray(jtable))
        depth, index, _ = csr6.rasterize_csr6(soup, w, h)
        ours = csr6.shade_by_id(soup, tc, shading, depth, index, rgb, flag)
        with jax.disable_jit():
            jours, jindex = jcsr4._shade_by_id(
                jsoup, jc, jshading, jnp.asarray(depth.numpy()),
                jnp.asarray(index.numpy().astype(np.float32)), jrgb, jflag)
            jfb = jshade_framebuffer(jsoup, jc, jnp.asarray(depth.numpy()),
                                     jnp.asarray(index.numpy()), jshading)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jours))
        np.testing.assert_array_equal(np.asarray(jindex), index.numpy())
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jfb))
        np.testing.assert_array_equal(
            ours.numpy(),
            shade_framebuffer(soup, tc, depth, index, shading).numpy())


def test_shaded_v6_matches_pallas_interpret():
    """The one interpret-mode run: the whole shaded v6 path at 64x64
    against pallas_csr6.render_shaded_csr6 — index, rgb and the
    certificate bit for bit; depth bit for bit on disc winners.  The
    interpreted kernel body runs as XLA CPU code, which contracts the
    capsule and triangle multiply-adds into FMAs, so their depths may
    differ by a few ulp (measured: capsules 1, triangles 3; bound 4)."""
    w = h = SMALL
    jc = jcam(w, h)
    jsoup = jax_soup(small_mixed_soup())
    jrgb, jdepth, jindex, jdiag = jcsr6.render_shaded_csr6(
        jsoup, jc, JShading(), interpret=True, return_diag=True)
    soup = convert.soup_from_fields(jsoup)
    rgb, depth, index, diag = csr6.render_shaded_csr6(
        soup, tcam(w, h), ShadingConfig())
    index = index.numpy()
    assert (index >= 0).any()
    np.testing.assert_array_equal(index, np.asarray(jindex))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    ulp = np.abs(depth.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jdepth).view(np.int32).astype(np.int64))
    kind = soup.kind.numpy()[np.maximum(index, 0)]
    assert ulp[(index >= 0) & (kind == 0)].max() == 0
    assert ulp[index >= 0].max() <= 4
    assert int(diag["true_entries"]) == int(np.asarray(jdiag["true_entries"]))
    assert int(diag["big_overflow"]) == int(np.asarray(jdiag["big_overflow"]))


def test_wrapper_dispatch():
    """CPU tensors take the plain walk without counting a launch; a
    device with no kernel raises instead of falling back."""
    soup = make_soup("mixed")
    b = csr6.bin_csr6(soup, W, H)
    table = csr6.build_table16(soup, torch.zeros((soup.count, 3)),
                               torch.zeros(soup.count))
    args = (table, b["order"], b["starts"], b["big_ids"], b["big_n"])
    before = csr6.raster_tiles.launches
    d1, i1 = csr6.raster_tiles(*args, W, H)
    d2, i2 = csr6.raster_tiles_plain(*args, W, H)
    assert csr6.raster_tiles.launches == before
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    with pytest.raises(ValueError, match="no csr6 kernel"):
        csr6.raster_tiles(*(a.to("meta") for a in args), W, H)
    with pytest.raises(ValueError, match="starts"):
        csr6.raster_tiles(*args, W + 64, H)
    with pytest.raises(ValueError, match="int32"):
        csr6.raster_tiles(table, b["order"].long(), *args[2:], W, H)
