"""The z-bucket early exit of the port's 16-float v6 walk (``raster/csr6.py``
with ``allow_exit``), held against the JAX package on the CPU.

* ``bin_csr6(with_z=True)`` against ``pallas_csr6._bin_csr6(with_z=True)``
  under one ``jax.jit`` (integers and a few float32 reductions: no
  multiply-add to contract), on a small traj_ball soup and on a mesh-LOD
  soup with binned triangles (its zlb through the edge functions, taken op
  by op so that XLA contracts nothing): ``zmeta`` bit-equal, the same set
  of prim ids under every key, every range start (so the nine single-class
  segments of every tile), the same big ids.
* The plain walk over the exit binning against ``cpu_reference`` bit for
  bit (depth bits and index), ``walked`` the rows of every tile.
* ``render_shaded_csr6`` with ``allow_exit=None`` (on by the JAX policy)
  equals ``allow_exit=False`` bit for bit; the policy raises where the JAX
  one raises.  The ``discs_only`` walk with the exit forced on equals the
  exit-off frame and the oracle.
The CUDA kernel's exit and split run only on a card: ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr6 as jcsr6
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

from tests.torch_jax import jax_soup, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    CROSS_FILM,
    H,
    W,
    band_soup,
    cloud,
    cross_class_soup,
    make_soup,
    mesh_soup,
    split_soup,
    tcam,
)

FI = 120


def _traj_ball_soup():
    pos, vel = cloud()
    cam = pipeline.frame_camera(PRESETS["traj_ball"], FI, W, H, "cpu")
    return pipeline.build_primitives(PRESETS["traj_ball"], cam,
                                     torch.tensor(pos), torch.tensor(vel), FI)


def _jax_exit_binning(soup, max_big, bin_triangles, eager):
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    num_tiles = tiles_x * tiles_y

    def jbin(s):
        keys, prims, big_ids, big_count, zmeta, _ = jcsr6._bin_csr6(
            s, 32, 32, num_tiles, tiles_x, tiles_y, max_big=max_big,
            bin_triangles=bin_triangles, with_z=True)
        bounds = jnp.arange(num_tiles * 4 + 1, dtype=jnp.int32) << jcsr6.ZQ
        return (keys, prims, big_ids, big_count, zmeta,
                jnp.searchsorted(keys, bounds).astype(jnp.int32))

    if eager:
        with jax.disable_jit():
            out = jbin(jax_soup(soup))
    else:
        out = jax.jit(jbin)(jax_soup(soup))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case", ["traj_ball", "mesh"])
def test_exit_binning_matches_jax(case):
    mesh = case == "mesh"
    soup = mesh_soup(tcam()) if mesh else _traj_ball_soup()
    max_big = 64
    keys, prims, big_ids, big_count, zmeta, starts = _jax_exit_binning(
        soup, max_big, mesh, eager=mesh)
    b = csr6.bin_csr6(soup, W, H, max_big, bin_triangles=mesh, with_z=True)
    assert b["keys"].dtype == torch.int32
    np.testing.assert_array_equal(b["zmeta"].numpy().view(np.int32),
                                  zmeta.view(np.int32))
    assert float(zmeta[1]) > 0  # a real depth range: buckets in use
    np.testing.assert_array_equal(b["starts"].numpy(), starts)
    n_small = int(starts[-1])
    assert n_small > 0
    # Every key holds the same set of prim ids in either unstable order.
    ours = np.lexsort((b["order"].numpy(), b["keys"].numpy()))
    theirs = np.lexsort((prims, keys))
    np.testing.assert_array_equal(b["keys"].numpy()[ours], keys[theirs])
    np.testing.assert_array_equal(b["order"].numpy()[ours], prims[theirs])
    assert len(np.unique(keys[:n_small] & ((1 << jcsr6.ZQ) - 1))) > 4
    n_big = int(b["big_n"][0])
    assert n_big == min(int(big_count), max_big) == int(b["big_count"])
    assert set(b["big_ids"].numpy()[:n_big]) == set(big_ids[:n_big])
    # The nine single-class segments of a tile hold its rows.
    rows = csr6.tile_rows(b["starts"], W, H).numpy()
    seg = np.diff(starts).reshape(-1, 4)
    tiles_x, tiles_y = csr6.grid_shape(W, H)
    for t in range(tiles_x * tiles_y):
        ty, tx = divmod(t, tiles_x)
        want = seg[t].sum()
        if tx:
            want += seg[t - 1, 1] + seg[t - 1, 2]
        if ty:
            want += seg[t - tiles_x, 2] + seg[t - tiles_x, 3]
        if tx and ty:
            want += seg[t - tiles_x - 1, 2]
        assert rows[t] == want
    # Without the exit the key is the bare int16 ordinal, with the same
    # ranges.
    b0 = csr6.bin_csr6(soup, W, H, max_big, bin_triangles=mesh)
    assert b0["keys"].dtype == torch.int16
    np.testing.assert_array_equal(b0["starts"].numpy(), starts)


@pytest.mark.parametrize("case", ["traj_ball", "cross_class", "split",
                                  "ties"])
def test_plain_exit_walk_matches_oracle(case):
    film = CROSS_FILM if case == "cross_class" else (W, H)
    soup = {"traj_ball": _traj_ball_soup, "cross_class": cross_class_soup,
            "split": split_soup}.get(case, lambda: make_soup(case))()
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), *film)
    b = csr6.bin_csr6(soup, *film, 256, with_z=True)
    zeros = torch.zeros((soup.count, 3))
    table = csr6.build_table16(soup, zeros, zeros[:, 0])
    tiles_x, tiles_y = csr6.grid_shape(*film)
    walked = torch.full((tiles_x * tiles_y,), -1, dtype=torch.int32)
    depth, index = csr6.raster_tiles(
        table, b["order"], b["starts"], b["big_ids"], b["big_n"], *film,
        zmeta=b["zmeta"], walked=walked, split_rows=64)
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  d_o.view(np.int32))
    assert (i_o >= 0).any()
    np.testing.assert_array_equal(walked.numpy(),
                                  csr6.tile_rows(b["starts"], *film).numpy())
    assert int(walked.sum()) == int(b["diag"]["true_entries"])
    if case == "cross_class":
        assert i_o[80, 95] == soup.count - 1  # the near disc wins there


@pytest.mark.parametrize("case", ["traj_ball", "mesh"])
def test_default_exit_frames_equal_exit_off(case):
    mesh = case == "mesh"
    soup = mesh_soup(tcam()) if mesh else _traj_ball_soup()
    cam = tcam()
    outs = [csr6.render_shaded_csr6(soup, cam, ShadingConfig(),
                                    allow_exit=allow, bin_triangles=mesh)
            for allow in (None, False, True)]
    for got in outs[1:]:
        for a, b in zip(outs[0][:3], got[:3]):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          b.numpy().view(np.int32))
    assert bool((outs[0][2] >= 0).any())
    fb = render(soup, cam, RasterConfig(bin_triangles=mesh))
    np.testing.assert_array_equal(fb.rgb.numpy(), outs[0][0].numpy())


def test_discs_only_exit_frame_equals_exit_off_and_oracle():
    """The non-fused disc walk with the exit forced on (span 2): the
    binning takes the exit keys, and the frame equals the exit-off frame
    (rgb, depth, index) and the oracle bit for bit; the plain walk reports
    every tile's rows as walked."""
    soup = band_soup()
    cam = tcam()
    outs = [csr6.render_shaded_csr6(soup, cam, ShadingConfig(),
                                    discs_only=True, allow_exit=allow)
            for allow in (True, False)]
    for a, b in zip(*(o[:3] for o in outs)):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32))
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), W, H)
    np.testing.assert_array_equal(outs[0][2].numpy(), i_o)
    np.testing.assert_array_equal(outs[0][1].numpy().view(np.int32),
                                  d_o.view(np.int32))
    b = csr6.bin_csr6(soup, W, H, 256, discs_only=True, with_z=True)
    rows8 = csr6.build_rows8(soup, torch.zeros(soup.count), b["order"])
    big = csr6.build_table16_rows(soup, torch.zeros((soup.count, 3)),
                                  torch.zeros(soup.count), b["big_ids"])
    walked = torch.full((csr6.tile_rows(b["starts"], W, H).shape[0],), -1,
                        dtype=torch.int32)
    depth, index = csr6.raster_tiles_disc8(
        rows8, big, b["starts"], b["big_n"], W, H, zmeta=b["zmeta"],
        walked=walked, split_rows=64)
    np.testing.assert_array_equal(index.numpy(), i_o)
    np.testing.assert_array_equal(walked.numpy(),
                                  csr6.tile_rows(b["starts"], W, H).numpy())


def test_exit_policy_and_errors():
    soup = make_soup("mixed")
    cam = tcam()
    sh = ShadingConfig()
    assert csr6.resolve_exit(None)
    assert not csr6.resolve_exit(None, discs_only=True)
    assert not csr6.resolve_exit(None, span=4)
    assert not csr6.resolve_exit(None, cap_rows10=True)
    assert not csr6.resolve_exit(True, kind_split=True)
    with pytest.raises(ValueError, match="requires span=2"):
        csr6.render_shaded_csr6(soup, cam, sh, allow_exit=True, span=4)
    with pytest.raises(ValueError, match="requires span=2"):
        csr6.render_shaded_csr6(soup, cam, sh, allow_exit=True, span=8,
                                discs_only=True)
    with pytest.raises(ValueError, match="requires span=2"):
        check_config(RasterConfig(allow_exit=True, span=8))
    with pytest.raises(ValueError, match="cap_rows10 rows carry no zlb"):
        csr6.render_shaded_csr6(soup, cam, sh, allow_exit=True,
                                cap_rows10=True)
    with pytest.raises(ValueError, match="rows8/rows9 rows carry no zlb"):
        csr6.rasterize_csr6(soup, W, H, rows9=True, allow_exit=True)
    zeros = torch.zeros((soup.count, 3))
    with pytest.raises(ValueError, match="fused_uv carries"):
        csr6._raster_core6(soup, W, H, 256, zeros, zeros[:, 0],
                           discs_only=True, fused_uv=True, allow_exit=True)
    # The exit's int32 key holds 2^21 tiles at span 2 (JAX: the same).
    side = 32 * 1449
    with pytest.raises(ValueError, match="too large for the int32 v6 key"):
        csr6.rasterize_csr6(soup, side, side, allow_exit=True)
    with pytest.raises(ValueError, match="too large for the int32 v6 key"):
        csr6.bin_csr6(soup, side, side, with_z=True)
    for match, kw in (("allow_exit requires span=2", dict(span=4)),
                      ("allow_exit requires span=2",
                       dict(span=8, discs_only=True)),
                      ("too large for the int32 v6 key",
                       dict(width=side, height=side))):
        with pytest.raises(ValueError, match=match):
            jcsr6.rasterize_pallas_csr6(
                jax_soup(soup), kw.get("width", W), kw.get("height", H),
                allow_exit=True, span=kw.get("span", 2), interpret=True,
                discs_only=kw.get("discs_only", False))
    # The fused (u, v) walk carries no exit, in both packages.
    with pytest.raises(ValueError, match="fused_uv carries"):
        jcsr6._raster_core6(jax_soup(soup), W, H, 32, 32, 1, 256, True,
                            None, None, max_big=256, discs_only=True,
                            allow_exit=True, fused_uv=True)
    # The wrapper's own checks.
    b = csr6.bin_csr6(soup, W, H, 256, with_z=True, span=2)
    table = csr6.build_table16(soup, zeros, zeros[:, 0])
    args = (table, b["order"], b["starts"], b["big_ids"], b["big_n"], W, H)
    with pytest.raises(ValueError, match="zmeta must be"):
        csr6.raster_tiles(*args, zmeta=b["zmeta"][:2])
    with pytest.raises(ValueError, match="walked must be"):
        csr6.raster_tiles(*args, walked=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="split_rows"):
        csr6.raster_tiles(*args, split_rows=0)
    b4 = csr6.bin_csr6(soup, W, H, 256, span=4)
    with pytest.raises(ValueError, match="span must be 2"):
        csr6.raster_tiles(table, b4["order"], b4["starts"], b4["big_ids"],
                          b4["big_n"], W, H, span=4, zmeta=b["zmeta"])
