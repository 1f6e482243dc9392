"""The ``split_rows`` argument of the kind-split walk
(``csr6.raster_tiles_rows9``), of the disc walks
(``csr6.raster_tiles_disc8``, ``raster_tiles_disc8_uv``) and of the v2
strip walk (``csr2.raster_tiles2``), whose CUDA kernels cut dense tiles
into work items: it must be at least 1, and on CPU tensors, which take
the plain walks, no split changes a bit.  The judge is the NumPy oracle
(``cpu_reference``; its cap8 capsule evaluation for the kind-split rows).
No XLA compile and no interpret-mode call: these tests take a few
seconds.
"""

import functools

import numpy as np
import pytest
import torch

from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu_torch.raster import csr, csr2, csr6
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
def _strip_case():
    """(walk arguments, oracle depth, oracle index) of the same soup on v2's
    8x128 strips."""
    soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    b = csr.bin_csr(soup, W, H, max_tiles_per_prim=4)
    n = int(b["starts"][-1])
    rows = csr.pack_rows_generic(soup, b["prims"][:n], b["keys"][:n],
                                 b["zmin"], b["span"])
    args = (rows, b["starts"], csr.pack_big_rows(soup, b["big_ids"]),
            b["big_n"], W, H)
    return (args, *cpu_reference.rasterize_reference(numpy_soup(soup), W, H))


@functools.cache
def _disc_case():
    """(walk arguments, oracle depth, oracle index) of the cull's band
    soup through the disc walks (sorted 8-float rows, span 2)."""
    soup = band_soup()
    b = csr6.bin_csr6(soup, W, H, 64, discs_only=True)
    zeros = torch.zeros((soup.count, 3))
    args = (csr6.build_rows8(soup, zeros[:, 0], b["order"]),
            csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"]),
            b["starts"], b["big_n"], W, H)
    return (args, *cpu_reference.rasterize_reference(numpy_soup(soup), W, H))


WALKS = {"rows9": (csr6.raster_tiles_rows9, _rows9_case),
         "v2": (csr2.raster_tiles2, _strip_case),
         "disc8": (csr6.raster_tiles_disc8, _disc_case),
         "disc8_uv": (csr6.raster_tiles_disc8_uv, _disc_case)}


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_split_rows_below_one_raises(walk):
    fn, case = WALKS[walk]
    with pytest.raises(ValueError, match="split_rows"):
        fn(*case()[0], split_rows=0)


@pytest.mark.parametrize("split_rows", [1, 64, csr6.SPLIT_ROWS])
@pytest.mark.parametrize("walk", sorted(WALKS))
def test_cpu_walk_ignores_split_rows(walk, split_rows):
    """CPU tensors take the plain walk, whatever the split, and launch
    nothing: winners and depth bits equal the oracle's."""
    fn, case = WALKS[walk]
    args, d_o, i_o = case()
    before = fn.launches
    depth, index = fn(*args, split_rows=split_rows)[:2]
    assert fn.launches == before
    assert (i_o >= 0).any()
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(_bits(depth.numpy()), _bits(d_o))
