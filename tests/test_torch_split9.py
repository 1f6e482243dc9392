"""The ``split_rows`` argument of the kind-split walk
(``csr6.raster_tiles_rows9``), of the disc walks
(``csr6.raster_tiles_disc8``, ``raster_tiles_disc8_uv``), of the v1 and
v2 strip walks (``csr.raster_tiles1``, ``csr2.raster_tiles2``,
``raster_tiles2_disc8``), of the
v3 walk (``csr3.raster_tiles3``), of the v4 walk (``csr4.raster_tiles4``
with and without ``bin_triangles``, and its plain version) and of the v5
walks (``csr5.raster_tiles5``, ``raster_tiles5_shaded`` and their plain
version), whose CUDA kernels cut dense tiles into work items: it must be
at least 1, and on CPU tensors, which take the plain walks, no split
changes a bit.  The judge is the NumPy oracle
(``cpu_reference``; its cap8 capsule evaluation for the kind-split rows).
No XLA compile and no interpret-mode call: these tests take a few
seconds.
"""

import functools

import numpy as np
import pytest
import torch

from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu_torch.raster import csr, csr2, csr3, csr4, csr5, csr6
from tests.torch_jax import numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    NEAR_ORIGIN,
    H,
    W,
    band_soup,
    droplet_soup,
    tcam,
)

SPAN = 4  # the droplet lane's span


def _bits(a):
    return np.asarray(a).view(np.int32)


@functools.cache
def _rows9_case():
    """(walk arguments, oracle depth, oracle index) of a droplet soup."""
    soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    b = csr6.bin_csr6(soup, W, H, 64, span=SPAN, kind_split=True)
    zeros = torch.zeros((soup.count, 3))
    args = (csr6.build_table9(soup, b["order"], b["starts"][-1]),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], W, H, SPAN)
    return (args, *cpu_reference.rasterize_reference(
        numpy_soup(soup), W, H, capsule_eval="cap8", span=SPAN))


@functools.cache
def _droplet_oracle():
    """(droplet soup, oracle depth, oracle index) with the 16-float
    capsule evaluation."""
    soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    return (soup, *cpu_reference.rasterize_reference(numpy_soup(soup), W,
                                                     H))


@functools.cache
def _strip_case():
    """(walk arguments, oracle depth, oracle index) of the same soup on
    8x128 strips (v1 and v2 walk the same rows)."""
    soup, d_o, i_o = _droplet_oracle()
    b = csr.bin_csr(soup, W, H, max_tiles_per_prim=4)
    n = int(b["starts"][-1])
    rows = csr.pack_rows_generic(soup, b["prims"][:n], b["keys"][:n],
                                 b["zmin"], b["span"])
    args = (rows, b["starts"], csr.pack_big_rows(soup, b["big_ids"]),
            b["big_n"], W, H)
    return args, d_o, i_o


@functools.cache
def _v4_case(bin_triangles=False):
    """The droplet soup through the v4 walk (per-tile entry runs with
    z-bucket keys; the exit's keys, which the plain walk ignores)."""
    soup, d_o, i_o = _droplet_oracle()
    b = csr4.bin_csr4(soup, W, H, 64, bin_triangles)
    zeros = torch.zeros((soup.count, 3))
    table = csr6.build_table16(soup, zeros, zeros[:, 0],
                               bin_triangles=bin_triangles)
    args = (table, b["entries"], b["starts"], b["big_ids"], b["big_n"],
            b["zmeta"], W, H, b["zq_bits"], bin_triangles)
    return args, d_o, i_o


@functools.cache
def _v5_case():
    """The cull's band soup through the v5 walk (chunk superrows of 16
    slots, 32x32 tiles)."""
    soup, d_o, i_o = _band_oracle()
    b = csr5.bin_chunks5(soup, W, H)
    tab, bp, kinds, meta = csr5.tables5(soup, b, torch.zeros((soup.count,
                                                              3)),
                                        csr5.look5(soup))
    args = (tab, b["chunks"], b["starts"], bp, kinds, b["big_n"], meta, W,
            H)
    return args, d_o, i_o


@functools.cache
def _band_oracle():
    """(band_soup, oracle depth, oracle index)."""
    soup = band_soup()
    return (soup, *cpu_reference.rasterize_reference(numpy_soup(soup), W,
                                                     H))


@functools.cache
def _disc_case():
    """(walk arguments, oracle depth, oracle index) of the cull's band
    soup through the disc walks (sorted 8-float rows, span 2)."""
    soup, d_o, i_o = _band_oracle()
    b = csr6.bin_csr6(soup, W, H, 64, discs_only=True)
    zeros = torch.zeros((soup.count, 3))
    args = (csr6.build_rows8(soup, zeros[:, 0], b["order"]),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], W, H)
    return args, d_o, i_o


@functools.cache
def _strip_disc_case():
    """The band soup through v2's discs_only walk (8-float rows on 8x128
    strips)."""
    soup, d_o, i_o = _band_oracle()
    b = csr.bin_csr(soup, W, H, max_tiles_per_prim=4, force_tri_big=True,
                    force_capsule_big=True)
    n = int(b["starts"][-1])
    rows = csr2.pack_rows_disc(soup, b["prims"][:n], b["keys"][:n],
                               b["zmin"], b["span"])
    args = (rows, b["starts"], csr.pack_big_rows(soup, b["big_ids"]),
            b["big_n"], W, H)
    return args, d_o, i_o


@functools.cache
def _v3_case():
    """The band soup through the v3 walk (entry-indexed rows; its big ids
    sit below its binned ones, so the resolved ids are the oracle's)."""
    soup, d_o, i_o = _band_oracle()
    b = csr3.bin_csr_2x2(soup, W, H)
    zeros = torch.zeros((soup.count, 3))
    rows = csr3.pack_rows8(soup, b["entries"], b["big_ids"], zeros,
                           zeros[:, 0], (0.0, 0.0, 0.0))
    args = (rows[:b["entries"].shape[0]],
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], b["zmeta"], W, H, b["zq_bits"])
    return args, d_o, i_o, b


def _ids(out):
    return out[:2]


def _v3_ids(out):
    b = _v3_case()[3]
    return out[0], csr3.resolve_ids(out[1], out[0], b["entries"],
                                    b["big_ids"])


# walk: (wrapper, case, (depth, index) of its output).
WALKS = {"rows9": (csr6.raster_tiles_rows9, _rows9_case, _ids),
         "v1": (csr.raster_tiles1, _strip_case, _ids),
         "v2": (csr2.raster_tiles2, _strip_case, _ids),
         "disc8": (csr6.raster_tiles_disc8, _disc_case, _ids),
         "disc8_uv": (csr6.raster_tiles_disc8_uv, _disc_case, _ids),
         "v2_disc8": (csr2.raster_tiles2_disc8, _strip_disc_case, _ids),
         "v3": (csr3.raster_tiles3, _v3_case, _v3_ids),
         "v4": (csr4.raster_tiles4, _v4_case, _ids),
         "v4_tri": (csr4.raster_tiles4, functools.partial(_v4_case, True),
                    _ids),
         "v4_plain": (csr4.raster_tiles4_plain, _v4_case, _ids),
         "v5": (csr5.raster_tiles5, _v5_case, _ids),
         "v5_shaded": (csr5.raster_tiles5_shaded, _v5_case, _ids),
         "v5_plain": (csr5.raster_tiles5_plain, _v5_case, _ids)}


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_split_rows_below_one_raises(walk):
    fn, case, _ = WALKS[walk]
    with pytest.raises(ValueError, match="split_rows"):
        fn(*case()[0], split_rows=0)


@pytest.mark.parametrize("split_rows", [1, 64, csr6.SPLIT_ROWS])
@pytest.mark.parametrize("walk", sorted(WALKS))
def test_cpu_walk_ignores_split_rows(walk, split_rows):
    """CPU tensors take the plain walk, whatever the split, and launch
    nothing: winners and depth bits equal the oracle's."""
    fn, case, ids = WALKS[walk]
    args, d_o, i_o = case()[:3]
    before = getattr(fn, "launches", 0)
    depth, index = ids(fn(*args, split_rows=split_rows))
    assert getattr(fn, "launches", 0) == before
    assert (i_o >= 0).any()
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(_bits(depth.numpy()), _bits(d_o))
