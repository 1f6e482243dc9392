"""The port's streaming slice (``parallel/streaming.py`` and
``trails.velocity_trails_sampled``), held against the JAX package and the
NumPy oracle on the CPU, at the 256x64 film of ``tests/test_features.py``'s
streaming tests.

* ``"tiled"``: 1,000 discs with per-point colours in chunks of 256 (the
  last short) against the JAX ``"tiled"`` stream of the same chunks:
  index equal, depth within DEPTH_ULP (the jitted JAX ``tiled`` depth,
  ROADMAP queue C), the attribute buffer within ATTR_ATOL and
  ``resolve_rgb`` within RGB_ATOL.
* ``"pallas6"`` and ``"pallas"`` (the plain v6 and v4 walks on CPU
  tensors): depth and index equal ``cpu_reference.rasterize_reference``
  of the concatenated chunk soups bit for bit; the attributes are the
  monolithic soup's at each winner.
* A ``soup_fn`` stream of the traj_ball soup (ground, discs, trails):
  one chunk gives the monolithic winners; two chunks the same depths and
  surfaces, the ground from the first chunk only.  The trail soup of
  ``velocity_trails_sampled``: capsule winners take the trail boost, and
  ``span=4, cap_rows10=True`` and ``allow_exit=False`` give the default
  stream's bits.  A traj_vel droplet soup in one chunk gives its
  monolithic winners.
* The attribute table of every kind (discs, capsules, pre-lit triangles;
  lambert and flat) bit-equal to the JAX stream's table built op by op,
  and ``resolve_rgb`` at disc, capsule and triangle winners bit-equal to
  the JAX ``shade_winner_attrs`` op by op.
* The certificates' errors (``max_big`` under ``"pallas"``,
  ``entry_capacity``), ``rows9`` dropped as the JAX package drops it, a
  soup whose size changes between chunks, no card for ``"cuda"``.
* ``velocity_trails_sampled`` bit-equal to the JAX function op by op and
  to the full ``velocity_trails`` columns.

No interpret-mode Pallas call; one jitted JAX stream.  The card's stream
is in ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.geometry import trails as jtrails
from pointcloud_render_tpu.parallel.streaming import (
    StreamingRasterizer as JStreamingRasterizer,
)
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.shading import shade as jshade
from pointcloud_render_tpu.shading.shade import (
    ShadingConfig as JShadingConfig,
)
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import trails
from pointcloud_render_tpu_torch.parallel.streaming import (
    PAD_POSITION,
    StreamingRasterizer,
)
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    KIND_TRIANGLE,
    ScreenPrimitives,
    discs_from_points,
)
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from tests.torch_jax import jax_soup, jcam, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import TRAIL_COLOR, cloud, tcam, trail_soup_fn

W, H = 256, 64
# The jitted JAX ``tiled`` depth against the port's IEEE-per-operation
# depth (ROADMAP queue C: XLA contracts the multiply-adds).
DEPTH_ULP = 4
# The attribute buffer against the JAX stream's: px and py come out of
# the same projection, which XLA contracts (measured: 1.5e-5 and 7.6e-6,
# one ulp at px ~ 200), r_px within ATTR_R_ULP (measured: 2); the
# colours are bit-equal.
ATTR_PX_ATOL = 3e-5
ATTR_R_ULP = 4
# resolve_rgb: on the same attribute buffer bit-equal to the JAX
# function (measured); on each package's own buffer within RGB_ATOL, the
# px/py difference through the sphere normal (measured: 1.8e-5).
RGB_ATOL = 5e-5


def _bits(a):
    return np.asarray(a).view(np.int32)


def _ulp(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b))


def _disc_chunks(n=1000, chunk=256, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return [(pos[k:k + chunk], colors[k:k + chunk])
            for k in range(0, n, chunk)]


def _padded_soups(sr, chunks):
    """Each chunk's soup as the stream builds it (padded to the chunk
    size), concatenated: the monolithic soup of the stream's ids."""
    soups = []
    for k, (pos, colors, *extras) in enumerate(chunks):
        n, c = pos.shape[0], sr.chunk_points
        pad = np.full((c - n, 3), PAD_POSITION, np.float32)
        p = torch.tensor(np.concatenate([pos, pad]))
        col = torch.tensor(np.concatenate([colors, np.zeros((c - n, 3),
                                                            np.float32)]))
        ext = [torch.tensor(np.concatenate([e, np.zeros((c - n,) + e.shape[1:],
                                                        np.float32)]))
               for e in extras]
        prims, layout = sr.build_soup(p, col, ext)
        if k and layout is not None:
            prims = dataclasses.replace(prims, valid=prims.valid.clone())
            loc = 0
            for rows, per in layout:
                if per == 0:
                    prims.valid[loc:loc + rows] = False
                loc += rows
        soups.append(prims)
    return ScreenPrimitives.concatenate(soups)


def _oracle(soup):
    return cpu_reference.rasterize_reference(numpy_soup(soup), W, H)


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_tiled_stream_matches_jax_stream():
    chunks = _disc_chunks()
    assert chunks[-1][0].shape[0] < 256  # a short last chunk
    jsr = JStreamingRasterizer(jcam(W, H), chunk_points=256,
                               radius_world=0.03, backend="tiled")
    jd, ji, ja = jsr.rasterize(chunks, return_attrs=True)
    jrgb = np.asarray(jsr.resolve_rgb(jd, ji, ja))
    jflat = np.asarray(jsr.resolve_rgb(jd, ji, ja, shaded=False))
    sr = StreamingRasterizer(tcam(W, H), chunk_points=256, radius_world=0.03,
                             backend="tiled", device="cpu")
    d, i, a = sr.rasterize(chunks, return_attrs=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    hit = i.numpy() >= 0
    assert 0.3 < hit.mean() < 0.95
    assert _ulp(d.numpy(), np.asarray(jd))[hit].max() <= DEPTH_ULP
    assert np.isinf(d.numpy()[~hit]).all()
    got, want = a.numpy()[hit], np.asarray(ja)[hit]
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0,
                               atol=ATTR_PX_ATOL)
    assert _ulp(got[:, 2], want[:, 2]).max() <= ATTR_R_ULP
    _assert_bits(torch.tensor(got[:, 3:]), want[:, 3:])
    np.testing.assert_allclose(sr.resolve_rgb(d, i, a).numpy(), jrgb,
                               rtol=0, atol=RGB_ATOL)
    _assert_bits(sr.resolve_rgb(torch.tensor(np.asarray(jd)),
                                torch.tensor(np.asarray(ji)),
                                torch.tensor(np.asarray(ja))), jrgb)
    np.testing.assert_array_equal(
        sr.resolve_rgb(d, i, a, shaded=False).numpy(), jflat)


@pytest.mark.parametrize("backend", ["pallas6", "pallas"])
def test_kernel_streams_match_the_oracle(backend):
    chunks = _disc_chunks(n=700, chunk=256, seed=1)
    sr = StreamingRasterizer(tcam(W, H), chunk_points=256, radius_world=0.03,
                             backend=backend, device="cpu",
                             entry_capacity=1 << 16)
    d, i, a = sr.rasterize(chunks, return_attrs=True)
    soup = _padded_soups(sr, chunks)
    d_o, i_o = _oracle(soup)
    _assert_bits(d, d_o)
    np.testing.assert_array_equal(i.numpy(), i_o)
    hit = i_o >= 0
    assert hit.mean() > 0.3 and i_o.max() >= 512  # the last chunk wins too
    # The attribute buffer is the monolithic soup's at each winner.
    table = sr.attribute_table(soup)[torch.tensor(i_o[hit]).long()]
    _assert_bits(a[torch.tensor(hit)], table.numpy())
    if backend == "pallas":
        assert sr._max_entries > 0


def _traj_ball_soup_fn(cam):
    preset = PRESETS["traj_ball"]

    def soup_fn(p, colors, v):
        return pipeline.build_primitives(preset, cam, p, v, 120,
                                         return_layout=True)
    return soup_fn


def test_soup_fn_stream_matches_monolithic_render():
    cam = tcam(W, H)
    pos, vel = cloud(n=300, seed=7)
    colors = np.full((300, 3), 0.3, np.float32)
    soup_fn = _traj_ball_soup_fn(cam)
    soup, _ = soup_fn(torch.tensor(pos), torch.tensor(colors),
                      torch.tensor(vel))
    d1, i1 = _oracle(soup)
    hit = i1 >= 0
    kinds = soup.kind.numpy()[i1[hit]]
    assert {KIND_DISC, KIND_CAPSULE, KIND_TRIANGLE} <= set(kinds.tolist())
    # One chunk: the monolithic winners.
    sr = StreamingRasterizer(cam, chunk_points=300, radius_world=0.01,
                             backend="pallas6", soup_fn=soup_fn,
                             device="cpu")
    d, i = sr.rasterize([(pos, colors, vel)])
    np.testing.assert_array_equal(i.numpy(), i1)
    _assert_bits(d, d1)
    # Two chunks: the same surfaces and depths; ids interleave per chunk,
    # and the ground (4 rows ahead of each chunk's points) renders once.
    sr2 = StreamingRasterizer(cam, chunk_points=150, radius_world=0.01,
                              backend="pallas6", soup_fn=soup_fn,
                              device="cpu")
    d2, i2 = sr2.rasterize([(pos[:150], colors[:150], vel[:150]),
                            (pos[150:], colors[150:], vel[150:])])
    _assert_bits(d2, d1)
    np.testing.assert_array_equal(i2.numpy() >= 0, hit)
    per_chunk = sr2.build_soup(torch.tensor(pos[:150]),
                               torch.tensor(colors[:150]),
                               (torch.tensor(vel[:150]),))[0].count
    ground = i1 < 4
    assert ground.any()
    np.testing.assert_array_equal(i2.numpy()[ground], i1[ground])
    second = i2.numpy() - per_chunk
    assert not ((second >= 0) & (second < 4)).any()


def _jax_attribute_table(soup, shading):
    """The JAX ``StreamingRasterizer._raster_local`` table, op by op."""
    prims = jax_soup(soup)
    m = jcam(W, H).world_to_camera_matrix()
    l_cam = jnp.stack([m[0, 2], m[1, 2], m[2, 2]])
    ndotl_tri = (prims.normal[:, 0] * l_cam[0]
                 + prims.normal[:, 1] * l_cam[1]
                 + prims.normal[:, 2] * l_cam[2])
    lit_tri = shading.ambient + shading.diffuse * jnp.maximum(ndotl_tri, 0.0)
    is_tri = prims.kind == KIND_TRIANGLE
    rflag = jnp.where(prims.kind == KIND_DISC, prims.params[:, 3],
                      jnp.where(is_tri, 0.0, -1.0))
    rgb = prims.color if shading.mode == "flat" else jnp.where(
        is_tri[:, None], prims.color * lit_tri[:, None], prims.color)
    return jnp.concatenate([prims.params[:, 0:2], rflag[:, None], rgb],
                           axis=1)


@pytest.mark.parametrize("preset,mode", [
    ("traj_ball", "lambert"), ("traj_ball", "flat"), ("traj_vel", "lambert"),
])
def test_attribute_table_and_resolve_rgb_match_jax(preset, mode):
    """The table of a soup with discs (traj_ball) or droplets (traj_vel),
    capsules and ground triangles, and the shaded winners of each kind:
    bit for bit against the JAX package op by op."""
    cam = tcam(W, H)
    pos, vel = cloud(n=300, seed=7)
    soup = pipeline.build_primitives(PRESETS[preset], cam, pos, vel, 120)
    shading = ShadingConfig(mode=mode)
    sr = StreamingRasterizer(cam, chunk_points=300, radius_world=0.01,
                             backend="pallas6", shading=shading, device="cpu")
    table = sr.attribute_table(soup)
    _assert_bits(table, np.asarray(_jax_attribute_table(
        soup, JShadingConfig(mode=mode))))
    d, i = _oracle(soup)
    hit = i >= 0
    kinds = set(soup.kind.numpy()[i[hit]].tolist())
    assert {KIND_CAPSULE, KIND_TRIANGLE} <= kinds
    attrs = table[torch.tensor(np.maximum(i, 0)).long()]
    rgb = sr.resolve_rgb(torch.tensor(d), torch.tensor(i), attrs)
    a = jnp.asarray(attrs.numpy())
    want = jshade.shade_winner_attrs(a[..., 0], a[..., 1], a[..., 2],
                                     a[..., 3:6], jnp.asarray(hit),
                                     jcam(W, H), JShadingConfig(mode=mode))
    _assert_bits(rgb, np.asarray(want))


def _trail_stream(config, chunks, cam):
    sr = StreamingRasterizer(cam, chunk_points=128, radius_world=0.01,
                             backend="pallas6",
                             soup_fn=trail_soup_fn(cam, 0.01), max_big=2048,
                             config=config, device="cpu")
    return sr, sr.rasterize(chunks, return_attrs=True)


@pytest.fixture(scope="module")
def trail_scene():
    cam = tcam(W, H)
    # A seed whose soup the rows9 walk renders with other depth bits.
    rng = np.random.default_rng(13)
    pos = rng.uniform(-0.4, 0.4, (256, 3)).astype(np.float32)
    vel = (rng.normal(size=(256, 3)) * 2).astype(np.float32)
    colors = np.full((256, 3), 0.3, np.float32)
    chunks = [(pos[:128], colors[:128], vel[:128]),
              (pos[128:], colors[128:], vel[128:])]
    sr, out = _trail_stream(None, chunks, cam)
    return cam, chunks, sr, out


def test_trail_stream_boosts_capsules_and_matches_the_oracle(trail_scene):
    cam, chunks, sr, (d, i, a) = trail_scene
    soup = _padded_soups(sr, chunks)
    d_o, i_o = _oracle(soup)
    _assert_bits(d, d_o)
    np.testing.assert_array_equal(i.numpy(), i_o)
    cap = (i_o >= 0) & (soup.kind.numpy()[np.maximum(i_o, 0)]
                        == KIND_CAPSULE)
    assert cap.sum() > 20
    assert (a.numpy()[cap][:, 2] == -1.0).all()
    rgb = sr.resolve_rgb(d, i, a).numpy()
    boost = np.clip(np.float32(TRAIL_COLOR) * np.float32(
        sr.shading.trail_boost), 0, 1)
    np.testing.assert_array_equal(rgb[cap], np.broadcast_to(boost,
                                                            rgb[cap].shape))


@pytest.mark.parametrize("config", [
    RasterConfig(backend="pallas6", span=4, cap_rows10=True),
    RasterConfig(backend="pallas6", allow_exit=False),
    # Dropped, as the JAX package drops it (ROADMAP queue C): the exact
    # walk renders.
    RasterConfig(backend="pallas6", rows9=True, span=4),
], ids=["span4_cap_rows10", "exit_off", "rows9_dropped"])
def test_trail_stream_knobs_bit_equal(trail_scene, config):
    cam, chunks, _, (d0, i0, a0) = trail_scene
    _, (d, i, a) = _trail_stream(config, chunks, cam)
    _assert_bits(d, d0.numpy())
    np.testing.assert_array_equal(i.numpy(), i0.numpy())
    _assert_bits(a, a0.numpy())


def test_rows9_differs_on_the_trail_soup(trail_scene):
    """The rows9 stream above is a real drop: on the same soup the rows9
    walk renders other depth bits than the exact walk."""
    cam, chunks, sr, _ = trail_scene
    soup = _padded_soups(sr, chunks)
    exact = csr6.rasterize_csr6(soup, W, H, max_big=2048, span=4)
    rows9 = csr6.rasterize_csr6(soup, W, H, max_big=2048, span=4, rows9=True)
    assert not torch.equal(exact[0], rows9[0])


def test_droplet_soup_one_chunk_matches_monolithic_render():
    cam = tcam(W, H)
    preset = PRESETS["traj_vel"]
    pos, vel = cloud(n=200, seed=3)
    colors = np.full((200, 3), 0.3, np.float32)

    def soup_fn(p, c, v):
        return pipeline.build_primitives(preset, cam, p, v, 120,
                                         return_layout=True)
    soup, _ = soup_fn(torch.tensor(pos), None, torch.tensor(vel))
    d1, i1 = _oracle(soup)
    assert (soup.kind.numpy()[i1[i1 >= 0]] == KIND_CAPSULE).any()
    sr = StreamingRasterizer(cam, chunk_points=200, radius_world=0.01,
                             soup_fn=soup_fn, backend="pallas6",
                             device="cpu")
    d, i = sr.rasterize([(pos, colors, vel)])
    np.testing.assert_array_equal(i.numpy(), i1)
    _assert_bits(d, d1)


def test_certificates_raise():
    cam = tcam(W, H)
    rng = np.random.default_rng(6)
    wide = rng.uniform(-0.4, 0.4, (300, 3)).astype(np.float32)
    sr = StreamingRasterizer(cam, chunk_points=300, radius_world=0.5,
                             backend="pallas", max_big=64, device="cpu")
    with pytest.raises(RuntimeError, match="max_big"):
        sr.rasterize([wide])
    pos = _disc_chunks(n=256, seed=2)[0][0]
    tiny = StreamingRasterizer(cam, chunk_points=256, radius_world=0.03,
                               backend="pallas", entry_capacity=64,
                               device="cpu")
    with pytest.raises(RuntimeError, match="entry_capacity"):
        tiny.rasterize([pos])


def test_stream_errors():
    cam = tcam(W, H)
    pos = np.zeros((10, 3), np.float32)

    def growing(p, c, *extras):
        n = p.shape[0] + len(growing.calls)
        growing.calls.append(n)
        return discs_from_points(torch.zeros((n, 3)), cam,
                                 torch.full((n,), 0.01), c[:1].expand(n, 3))
    growing.calls = []
    sr = StreamingRasterizer(cam, chunk_points=10, radius_world=0.01,
                             soup_fn=growing, device="cpu")
    with pytest.raises(ValueError, match="fixed soup size"):
        sr.rasterize([pos, pos])
    sr = StreamingRasterizer(cam, chunk_points=10, radius_world=0.01,
                             device="cpu")
    with pytest.raises(ValueError, match="form of the first"):
        sr.rasterize([pos, (pos, np.ones((10, 3), np.float32))])
    with pytest.raises(ValueError, match="exceeds chunk_points"):
        sr.rasterize([np.zeros((11, 3), np.float32)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingRasterizer(cam, chunk_points=10, radius_world=0.01)


def test_velocity_trails_sampled_matches_jax_and_full_build():
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(50, 3)).astype(np.float32)
    vel = (rng.normal(size=(50, 3)) * 3).astype(np.float32)
    vel[3] = 0.0  # below epsilon
    pos[7, 2] = np.inf  # non-finite
    for segs, fi, sched in ((4, 120, "ball"), (8, 10, "ball"),
                            (20, 205, "vel")):
        sub = np.round(np.linspace(0, trails.N_TRAIL_POINTS,
                                   segs + 1)).astype(np.int32)
        with jax.disable_jit():
            jpts, jvalid = jtrails.velocity_trails_sampled(
                pos, vel, jnp.int32(fi), sub, sched)
        pts, valid = trails.velocity_trails_sampled(
            torch.tensor(pos), torch.tensor(vel), fi, sub, sched)
        _assert_bits(pts, np.asarray(jpts))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        full, fvalid = trails.velocity_trails(torch.tensor(pos),
                                              torch.tensor(vel), fi, sched)
        _assert_bits(pts, full.numpy()[:, sub])
        np.testing.assert_array_equal(valid.numpy(), fvalid.numpy())
        assert not valid[3] and not valid[7]
