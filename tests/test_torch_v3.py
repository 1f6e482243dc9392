"""The cap_rows10 walk and the 16-float walk at spans 4 and 8 (row 1e of
the kernel table) and the v3 disc fast path (``raster/csr3.py``, row 3),
held against the JAX package on the CPU.

* ``raster_tiles_cap10_plain`` equals ``cpu_reference`` (its default
  ``capsule_eval="cap10"``) bit for bit, and the 16-float plain walk, at
  spans 2, 4 and 8 on the seeded soups; ``build_table10`` equals the JAX
  rows (``params[:, 0:9]`` and the float id, zero where invalid).
* ``bin_csr_2x2`` against ``pallas_csr3._bin_csr_2x2`` run op by op:
  keys, the stable order, the big list and zmeta bit for bit;
  ``true_entry_count3`` and ``bin_diagnostics3``.
* ``raster_tiles3_plain`` (through ``rasterize_csr3``) equals the
  oracle's winners and depth bits on the seeded soups (big ids below the
  binned discs', the v3 precondition).
* One interpret-mode ``pallas_csr3.render_shaded_csr3`` run at 64x64
  (its cost is ~5-11 s): index, rgb and the certificate equal, disc depth
  bit for bit.
* A finite ``entry_capacity`` drops entries as the JAX package does; the
  wrappers' dispatch and the validations of the JAX package.
The CUDA kernels run only on a card: ``test_torch_cuda.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr3 as jcsr3
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr3, csr6
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from tests.torch_jax import jax_soup, jcam, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    CASES,
    H,
    W,
    band_soup,
    cloud,
    disc_soup,
    make_soup,
    pad_invalid,
    tcam,
)

SMALL = 64
LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))


def _bits(a):
    return np.asarray(a).view(np.int32)


@functools.cache
def _case(case):
    """(soup, oracle depth, oracle index) of a seeded case, made once."""
    soup = disc_soup(tcam()) if case == "discs" else make_soup(case)
    return (soup, *cpu_reference.rasterize_reference(numpy_soup(soup), W,
                                                     H))


@pytest.mark.parametrize("span", csr6.SPANS)
@pytest.mark.parametrize("case", CASES)
def test_plain_cap10_matches_oracle_and_16_float_walk(case, span):
    soup, d_o, i_o = _case(case)
    b = csr6.bin_csr6(soup, W, H, 1 << 14, span=span)
    zeros = torch.zeros((soup.count, 3))
    ranges = (b["order"], b["starts"])
    d16, i16 = csr6.raster_tiles_plain(
        csr6.build_table16(soup, zeros, zeros[:, 0]), *ranges, b["big_ids"],
        b["big_n"], W, H, False, span)
    d10, i10 = csr6.raster_tiles_cap10_plain(
        csr6.build_table10(soup),
        csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
        *ranges, b["big_n"], W, H, span)
    for d, i in ((d10, i10), (d16, i16)):
        np.testing.assert_array_equal(i.numpy(), i_o)
        np.testing.assert_array_equal(_bits(d.numpy()), _bits(d_o))
    assert (i_o >= 0).any()


def test_table10_matches_jax_rows():
    soup = make_soup("invalid")
    table = csr6.build_table10(soup).numpy()
    p = soup.count
    want = np.concatenate([soup.params[:, 0:9].numpy(),
                           np.arange(p, dtype=np.float32)[:, None]], axis=1)
    want = np.where(soup.valid.numpy()[:, None], want, 0.0)
    np.testing.assert_array_equal(_bits(table[:p]), _bits(want))
    assert not table[p].any() and table.shape == (p + 1, 10)


@pytest.mark.parametrize("case", ["discs", "ties", "dense_tile"])
def test_bin_csr_2x2_matches_jax_op_by_op(case):
    # Every case at the largest's 600 rows (invalid rows past its own),
    # so the cases share the op-by-op compiles of one shape.
    soup = pad_invalid(_case(case)[0], 600)
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    b = csr3.bin_csr_2x2(soup, W, H, max_big=64)
    with jax.disable_jit():
        keys, prims, big, count, zmeta = jcsr3._bin_csr_2x2(
            jax_soup(soup), 32, 32, tiles_x * tiles_y, tiles_x, tiles_y,
            max_big=64)
    np.testing.assert_array_equal(b["keys"].numpy(), np.asarray(keys))
    np.testing.assert_array_equal(b["entries"].numpy(), np.asarray(prims))
    np.testing.assert_array_equal(_bits(b["zmeta"].numpy()), _bits(zmeta))
    assert int(b["big_count"]) == int(count)
    nb = int(b["big_n"][0])
    np.testing.assert_array_equal(b["big_ids"][:nb].numpy(),
                                  np.asarray(big)[:nb])
    assert b["zq_bits"] == jcsr3._zq_bits(tiles_x * tiles_y) > 0
    assert int(b["starts"][-1]) > 0 and float(b["zmeta"][1]) > 0
    assert int(csr3.true_entry_count3(soup, W, H)) == int(b["starts"][-1])
    assert int(csr3.bin_diagnostics3(soup, W, H, max_big=1)) == max(
        int(count) - 1, 0)


@pytest.mark.parametrize("case", CASES + ["discs"])
def test_plain_v3_matches_oracle(case):
    """Binned discs and big-list prims of every kind: winners and depth
    bits equal the oracle's (every case's big ids sit below its binned
    discs' or meet them at no exact depth tie)."""
    soup, d_o, i_o = _case(case)
    depth, index, diag = csr3.rasterize_csr3(soup, W, H)
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(_bits(depth.numpy()), _bits(d_o))
    assert int(diag["big_overflow"]) == 0 and int(diag["true_entries"]) > 0


def test_shaded_v3_matches_pallas_interpret():
    """The one interpret-mode run: the shaded v3 path at 64x64 (ground, a
    wide disc on the big list, 300 discs with exact ties) against
    pallas_csr3.render_shaded_csr3: index, rgb and the certificate equal;
    disc depth bit for bit, the ground's triangle depth within 4 ulp (the
    interpreted body contracts its multiply-adds, ROADMAP queue C)."""
    cam = tcam(SMALL, SMALL)
    soup = disc_soup(cam, wide=1)
    jrgb, jdepth, jindex, jdiag = jcsr3.render_shaded_csr3(
        jax_soup(soup), jcam(SMALL, SMALL), JShading(), interpret=True,
        return_diag=True)
    rgb, depth, index, diag = csr3.render_shaded_csr3(soup, cam,
                                                      ShadingConfig())
    index = index.numpy()
    kind = soup.kind.numpy()[np.maximum(index, 0)]
    assert (kind == 0).sum() > 200 and (kind == 2).sum() > 200
    np.testing.assert_array_equal(index, np.asarray(jindex))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    ulp = np.abs(_bits(depth.numpy()).astype(np.int64) - _bits(jdepth))
    assert ulp[(index >= 0) & (kind == 0)].max() == 0
    assert ulp[index >= 0].max() <= 4
    for key in ("true_entries", "big_overflow"):
        assert int(diag[key]) == int(np.asarray(jdiag[key]))
    # uniform_look and flat against the port's own generic shade.
    two = csr3.render_shaded_csr3(soup, cam, ShadingConfig(),
                                  uniform_look=LOOK)[0]
    assert np.abs(two.numpy() - rgb.numpy()).max() <= 1e-6
    flat = csr3.render_shaded_csr3(soup, cam, ShadingConfig(mode="flat"))[0]
    assert flat.shape == (SMALL, SMALL, 3) and not torch.equal(flat, rgb)


def test_entry_capacity_drops_entries():
    """A capacity below true_entries keeps the first sorted entries (the
    stable runs' heads) and clamps the starts; the pipeline's certificate
    refuses such a frame; a capacity at true_entries changes nothing."""
    soup, d_o, i_o = _case("ties")
    b = csr3.bin_csr_2x2(soup, W, H)
    true = int(b["starts"][-1])
    cap = 2 * true // 3
    entries, starts = csr3.cut_entries(b, cap)
    assert entries.shape[0] == cap and int(starts[-1]) == cap
    np.testing.assert_array_equal(
        starts.numpy(), np.minimum(b["starts"].numpy(), cap))
    d_cut, i_cut, diag = csr3.rasterize_csr3(soup, W, H, entry_capacity=cap)
    assert int(diag["true_entries"]) == true
    assert (i_cut.numpy() != i_o).any()
    d_all, i_all, _ = csr3.rasterize_csr3(soup, W, H, entry_capacity=true)
    np.testing.assert_array_equal(i_all.numpy(), i_o)
    pos, vel = cloud(n=60, seed=2)
    pipe = pipeline.FramePipeline(
        PRESETS["traj_ball"], RasterConfig(backend="pallas3",
                                           entry_capacity=8),
        width=96, height=64, device="cpu")
    with pytest.raises(RuntimeError, match="entry capacity violated"):
        pipe.render_array(np.concatenate([pos, vel], axis=1), 120)


def test_pallas3_backend_renders_through_render():
    soup, d_o, i_o = _case("discs")
    fb, diag = render(soup, tcam(), RasterConfig(backend="pallas3"),
                      return_diag=True)
    np.testing.assert_array_equal(fb.index.numpy(), i_o)
    want = csr6.render_shaded_csr6(soup, tcam(), ShadingConfig())[0]
    np.testing.assert_array_equal(fb.rgb.numpy(), want.numpy())


def test_wrappers_dispatch_and_knob_errors():
    """CPU tensors take the plain walks without counting a launch; a
    device with no kernel raises; malformed inputs raise; the knob
    combinations the JAX package rejects raise ValueError."""
    soup = _case("mixed")[0]
    b = csr6.bin_csr6(soup, W, H, span=4)
    zeros = torch.zeros((soup.count, 3))
    args = (csr6.build_table10(soup),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["order"], b["starts"], b["big_n"], W, H, 4)
    before = csr6.raster_tiles_cap10.launches
    got = csr6.raster_tiles_cap10(*args)
    assert csr6.raster_tiles_cap10.launches == before
    for a, w in zip(got, csr6.raster_tiles_cap10_plain(*args)):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    with pytest.raises(ValueError, match="no csr6 kernel"):
        csr6.raster_tiles_cap10(*(a.to("meta") for a in args[:5]),
                                *args[5:])
    with pytest.raises(ValueError, match="table10"):
        csr6.raster_tiles_cap10(args[0][:, :9], *args[1:])
    with pytest.raises(ValueError, match="starts does not match"):
        csr6.raster_tiles_cap10(*args[:7], 2)
    with pytest.raises(ValueError, match="span must be"):
        csr6.raster_tiles(csr6.build_table16(soup, zeros, zeros[:, 0]),
                          b["order"], b["starts"], b["big_ids"], b["big_n"],
                          W, H, False, 3)

    b3 = csr3.bin_csr_2x2(soup, W, H)
    rows = csr3.pack_rows8(soup, b3["entries"], b3["big_ids"], zeros,
                           zeros[:, 0], (0.0, 0.0, 0.0))
    args3 = (rows[:b3["entries"].shape[0]],
             csr6.build_table16_rows(soup, zeros, zeros[:, 0],
                                     b3["big_ids"]),
             b3["starts"], b3["big_n"], b3["zmeta"], W, H, b3["zq_bits"])
    before = csr3.raster_tiles3.launches
    walked = torch.full((b3["starts"].shape[0] - 1,), -1, dtype=torch.int32)
    got = csr3.raster_tiles3(*args3, walked=walked)
    assert csr3.raster_tiles3.launches == before
    for a, w in zip(got, csr3.raster_tiles3_plain(*args3)):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    np.testing.assert_array_equal(
        walked.numpy(), (b3["starts"][1:] - b3["starts"][:-1]).numpy())
    ent = got[1].numpy()
    assert (ent == csr3.IMAX).sum() == np.isinf(got[0].numpy()).sum()
    assert (ent < 0).any() and (ent >= 0).any()  # big and binned winners
    with pytest.raises(ValueError, match="no csr3 kernel"):
        csr3.raster_tiles3(*(a.to("meta") for a in args3[:5]), *args3[5:])
    with pytest.raises(ValueError, match="zmeta"):
        csr3.raster_tiles3(*args3[:4], b3["zmeta"][:2], *args3[5:])
    with pytest.raises(ValueError, match="walked"):
        csr3.raster_tiles3(*args3, walked=walked[:-1])

    for cfg, err in (
            (RasterConfig(cap_rows10=True, discs_only=True), "discs_only"),
            (RasterConfig(cap_rows10=True, bin_triangles=True),
             "triangle lanes"),
            (RasterConfig(cap_rows10=True, rows9=True), "cap_rows10"),
            (RasterConfig(cap_rows10=True, rows8=True), "cap_rows10"),
            (RasterConfig(cap10_carry=True), "requires cap_rows10"),
            (RasterConfig(cap_rows10=True, allow_exit=True), "allow_exit")):
        with pytest.raises(ValueError, match=err):
            check_config(cfg)
    # Ported since: discs_only at spans 4 and 8.
    check_config(RasterConfig(discs_only=True, span=4))
    check_config(RasterConfig(cap_rows10=True, cap10_carry=True, span=8))
    check_config(RasterConfig(backend="pallas3", tile_h=32, tile_w=32,
                              unroll=8, chunk_rows=1024))


def test_v3_band_counter_matches_brute_force():
    """band_rows3 (the v3 walk's warp-band cull, counted on the CPU) keeps
    an (entry, band) pair of a band that starts inside the image exactly
    when a pixel centre of the band passes the disc test at dx = 0 (the
    ragged bottom band tests all its rows), on band_soup's tangent,
    one-below and boundary-centred discs; with bands of one row it counts
    the (entry, pixel row) pairs that pass.  The CPU wrapper reports those
    counts as ``bands``, and ``block`` outside 1..1024 raises."""
    soup = band_soup()
    b = csr3.bin_csr_2x2(soup, W, H)
    zeros = torch.zeros((soup.count, 3))
    rows = csr3.pack_rows8(soup, b["entries"], b["big_ids"], zeros,
                           zeros[:, 0], (0.0, 0.0, 0.0))
    n = int(b["starts"][-1])
    starts = b["starts"].numpy().astype(np.int64)
    tile = np.searchsorted(starts, np.arange(n), side="right") - 1
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    py, r2 = rows[:n, 1].numpy(), rows[:n, 3].numpy()
    for band in (csr6.BAND_ROWS, 1):
        want = np.zeros(tiles_x * tiles_y, np.int64)
        for bi in range(csr6.TILE // band):
            y0 = (tile // tiles_x) * csr6.TILE + bi * band
            hit = np.zeros(n, bool)
            for k in range(band):
                dy = ((y0 + k).astype(np.float32) + np.float32(0.5)) - py
                hit |= dy * dy <= r2
            np.add.at(want, tile, hit & (y0 < H))
        got = csr3.band_rows3(rows, b["starts"], W, H, band=band)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) > 0
    args = (rows[:n], csr6.build_table16_rows(soup, zeros, zeros[:, 0],
                                              b["big_ids"]),
            b["starts"], b["big_n"], b["zmeta"], W, H, b["zq_bits"])
    bands = torch.full((tiles_x * tiles_y,), -1, dtype=torch.int32)
    csr3.raster_tiles3(*args, bands=bands)
    np.testing.assert_array_equal(
        bands.numpy(), csr3.band_rows3(rows, b["starts"], W, H).numpy())
    for block in (0, csr3.MAX_BLOCK + 1):
        with pytest.raises(ValueError, match="block"):
            csr3.raster_tiles3(*args, block=block)
