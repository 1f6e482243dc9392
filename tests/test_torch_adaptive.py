"""The adaptive velocity trails (``trail_segments="adaptive"``) and the v6
``row_budget`` of the PyTorch port, held against the JAX package on the
CPU.

* Trails: ``sampled_ts_table``, ``velocity_trail_lengths`` and
  ``velocity_trails_adaptive`` equal the JAX functions bit for bit, and
  ``_adaptive_trail_segment_counts`` equals the JAX heuristic evaluated op
  by op (every k of 1..4 occurs) and jitted.
* Soup: the adaptive soup has ``trail_segments=4``'s layout, rows past
  each trail's k invalid and the rows below k equal to the port's own
  k-segment build (which ``test_torch_pipeline.py`` holds to the JAX build
  op by op); against the jitted JAX ``build_primitives(...,
  trail_segments="adaptive")`` within the bounds of ROADMAP queue C's
  jitted-soup entry.
* Walks: the plain v6 walks (16-float with the exit, ``cap_rows10``,
  rows9) on the adaptive soup equal ``cpu_reference`` bit for bit.
* ``row_budget``: ``diag["row_overflow"]`` and ``bin_diagnostics6(...,
  return_binned=True)`` equal the JAX values; every walk's cut frame
  equals the oracle on the soup without the prims past the budget, and
  the JAX interpret-mode cut frame; the stream drops rows past the budget
  without a word, as the JAX stream does (ROADMAP queue C).
* ``PointCloud`` converts to and from the raw layout as the JAX one does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.geometry import trails as jtrails
from pointcloud_render_tpu.raster import cpu_reference, pallas_csr6
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu.scene.pointcloud import PointCloud as JPointCloud
from pointcloud_render_tpu_torch import PointCloud
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import trails
from pointcloud_render_tpu_torch.parallel.streaming import StreamingRasterizer
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import jax_soup, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    ADAPTIVE_ORIGIN,
    TARGET,
    H,
    W,
    adaptive_cloud,
    adaptive_soup,
    tcam,
)

B = pipeline.TRAIL_ADAPTIVE_BUDGET
FRAME = 120
# Against the jitted JAX soup: queue C's bounds (test_torch_pipeline.py),
# per kind as a fraction of each column's largest magnitude; trails whose
# k differs from the jitted heuristic's (measured: none) at most K_FLIPS.
SOUP_REL = {0: 2e-6, 1: 2e-6, 2: 2e-5}
CAPSULE_DELTA_REL = 1e-3
K_FLIPS = 2
# Pallas interpret mode against the oracle (queue C): index equal, depth
# within 4 ulp (capsules 1, triangles 3).
INTERPRET_ULP = 4


def _jcam():
    """The JAX twin of ``tcam(origin=ADAPTIVE_ORIGIN)``."""
    return JCamera(origin=np.asarray(ADAPTIVE_ORIGIN, np.float32),
                   target=np.asarray(TARGET, np.float32), width=W, height=H)


def _port_counts(preset, pos, vel, cam, frame=FRAME):
    d, tl, _ = trails.velocity_trail_lengths(
        torch.tensor(pos), torch.tensor(vel), frame, preset.trail_schedule)
    return pipeline._adaptive_trail_segment_counts(
        torch.tensor(pos), d, tl, cam, preset.trail_radius).numpy()


def _jax_counts(preset, pos, vel, cam, frame=FRAME):
    d, tl, _ = jtrails.velocity_trail_lengths(
        pos, vel, jnp.int32(frame), preset.trail_schedule)
    return jpipe._adaptive_trail_segment_counts(pos, d, tl, cam,
                                                preset.trail_radius)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("schedule,frame", [("ball", 120), ("vel", 210)])
def test_adaptive_trail_geometry_matches_jax(schedule, frame):
    for budget in (1, 4, 6):
        np.testing.assert_array_equal(
            _bits(trails.sampled_ts_table(budget)),
            _bits(jtrails.sampled_ts_table(budget)))
    pos, vel = adaptive_cloud()
    vel[7] = 0.0  # below the velocity epsilon: no trail
    rng = np.random.default_rng(11)
    k = rng.integers(-1, B + 3, pos.shape[0]).astype(np.int32)  # clipped
    with jax.disable_jit():
        want = jtrails.velocity_trail_lengths(jnp.asarray(pos),
                                              jnp.asarray(vel),
                                              jnp.int32(frame), schedule)
        want += jtrails.velocity_trails_adaptive(
            jnp.asarray(pos), jnp.asarray(vel), jnp.int32(frame),
            jnp.asarray(k), B, schedule)
    got = trails.velocity_trail_lengths(torch.tensor(pos), torch.tensor(vel),
                                        frame, schedule)
    got += trails.velocity_trails_adaptive(torch.tensor(pos),
                                           torch.tensor(vel), frame,
                                           torch.tensor(k), B, schedule)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))
    # Vertex j of a trail at k segments: the k-segment sampled build's.
    pts = got[3].numpy()
    kc = np.clip(k, 1, B)
    for kk in range(1, B + 1):
        sub = np.round(np.linspace(0, trails.N_TRAIL_POINTS,
                                   kk + 1)).astype(np.int64)
        ref, _ = trails.velocity_trails_sampled(
            torch.tensor(pos), torch.tensor(vel), frame, sub, schedule)
        m = kc == kk
        np.testing.assert_array_equal(_bits(pts[m, :kk + 1]),
                                      _bits(ref.numpy()[m]))


def test_adaptive_counts_match_jax():
    preset, jpreset = PRESETS["traj_ball"], JAX_PRESETS["traj_ball"]
    pos, vel = adaptive_cloud()
    cam, jcam = tcam(origin=ADAPTIVE_ORIGIN), _jcam()
    k = _port_counts(preset, pos, vel, cam)
    with jax.disable_jit():
        want = np.asarray(_jax_counts(jpreset, jnp.asarray(pos),
                                      jnp.asarray(vel), jcam))
    np.testing.assert_array_equal(k, want)
    assert k.dtype == np.int32 and set(np.unique(k)) == {1, 2, 3, 4}, \
        np.bincount(k)


@pytest.mark.parametrize("preset", ["traj_ball", "traj_vel"])
def test_adaptive_soup_matches_jax(preset):
    """The adaptive soup against the port's fixed-k builds (bit for bit;
    ``test_torch_pipeline.py`` holds those to the JAX builds op by op) and
    the jitted JAX adaptive build (queue C's bounds)."""
    soup, layout, cam = adaptive_soup(preset)
    fixed, layout4, _ = adaptive_soup(preset, segments=B)
    assert layout == layout4 and soup.count == fixed.count
    ours = convert.soup_to_numpy(soup)
    pos, vel = adaptive_cloud()
    n = pos.shape[0]
    # The trail part is the last: ground, splats, then trails.
    trail = slice(soup.count - B * n, soup.count)
    k = _port_counts(PRESETS[preset], pos, vel, cam)
    valid = ours["valid"][trail].reshape(n, B)
    assert not valid[np.arange(B)[None, :] >= k[:, None]].any()
    assert valid.sum() > 20
    for name, arr in ours.items():  # the parts before the trails
        np.testing.assert_array_equal(
            _bits(arr[:trail.start]),
            _bits(convert.soup_to_numpy(fixed)[name][:trail.start]))
    for kk in range(1, B + 1):
        ref = convert.soup_to_numpy(adaptive_soup(preset, segments=kk)[0])
        m = k == kk
        for name, arr in ours.items():
            a = arr[trail].reshape(n, B, -1)[m, :kk]
            b = ref[name][-kk * n:].reshape(n, kk, -1)[m]
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    # The jitted JAX build and its heuristic's k, in one compile.
    jpreset = JAX_PRESETS[preset]
    jitted, jk = jax.jit(lambda p, v: (jpipe.build_primitives(
        jpreset, _jcam(), p, v, jnp.int32(FRAME),
        trail_segments="adaptive"), _jax_counts(jpreset, p, v, _jcam())))(
        jnp.asarray(pos), jnp.asarray(vel))
    assert int((np.asarray(jk) != k).sum()) <= K_FLIPS
    # traj_vel's droplets rotate through arccos/cos/sin (queue C, "Batch
    # rotations", held by test_torch_droplets.py): its trails alone here.
    rows = slice(None) if preset == "traj_ball" else trail
    for name in ("kind", "color", "valid", "normal"):
        np.testing.assert_array_equal(
            ours[name][rows], np.asarray(getattr(jitted, name))[rows],
            err_msg=name)
    live = ours["valid"][rows]
    kinds = ours["kind"][rows][live]
    for name in ("params", "bbox"):
        a = ours[name][rows][live]
        b = np.asarray(getattr(jitted, name))[rows][live]
        for kind in np.unique(kinds):
            m = kinds == kind
            scale = np.abs(a[m]).max(axis=0)
            bound = np.full(a.shape[1], SOUP_REL[kind])
            if name == "params" and kind == 1:
                bound[4:9] = CAPSULE_DELTA_REL
            assert (np.abs(a[m] - b[m]) <= bound * scale).all(), (name, kind)


# The v6 walks on the adaptive soup: (rasterize_csr6 knobs, oracle knobs).
MODES = {
    "rows16_exit": (dict(), dict()),
    "cap_rows10": (dict(cap_rows10=True, span=4), dict()),
    "rows9": (dict(rows9=True, span=4), dict(capsule_eval="cap8", span=4)),
    "discs_only": (dict(discs_only=True), dict()),
}


def _oracle(soup, **kw):
    d, i = cpu_reference.rasterize_reference(numpy_soup(soup), W, H, **kw)
    return d, i


def _assert_frame(got, want):
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  want[0].view(np.int32))
    assert (want[1] >= 0).any()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_walks_and_row_budget_cut_match_oracle(mode):
    """The plain walk of each mode on the adaptive soup == the oracle; with
    a budget that cuts the binned rows in half, == the oracle on the soup
    without the binned prims past the budget, ``row_overflow`` their
    count; with a budget at the binned count, == the uncut frame."""
    soup, _, _ = adaptive_soup()
    walk_kw, oracle_kw = MODES[mode]
    d, i, diag = csr6.rasterize_csr6(soup, W, H, **walk_kw)
    assert int(diag["row_overflow"]) == 0
    if mode != "discs_only":  # its capsules ride the big list
        _assert_frame((d, i), _oracle(soup, **oracle_kw))
    # The prims past the budget: the walk's own binning (the exit keys of
    # the 16-float walk at span 2, the kind split of rows9).
    span = walk_kw.get("span", 2)
    b = csr6.bin_csr6(soup, W, H, span=span,
                      discs_only=walk_kw.get("discs_only", False),
                      kind_split=walk_kw.get("rows9", False),
                      with_z=mode == "rows16_exit")
    n_small = int(b["starts"][-1])
    ovf, binned = csr6.bin_diagnostics6(
        soup, W, H, discs_only=walk_kw.get("discs_only", False), span=span,
        kind_split=walk_kw.get("rows9", False), return_binned=True)
    assert int(binned) == n_small and int(ovf) == 0 and n_small > 40
    budget = n_small // 2
    valid = soup.valid.clone()
    valid[b["order"][budget:n_small].long()] = False
    cut = dataclasses.replace(soup, valid=valid)
    d, i, diag = csr6.rasterize_csr6(soup, W, H, row_budget=budget, **walk_kw)
    assert int(diag["row_overflow"]) == n_small - budget
    want = (_oracle(cut, **oracle_kw) if mode != "discs_only" else
            tuple(t.numpy() for t in csr6.rasterize_csr6(cut, W, H,
                                                         **walk_kw)[:2]))
    _assert_frame((d, i), want)
    assert (want[1] != _oracle(soup, **oracle_kw)[1]).any()  # it cut
    full = csr6.rasterize_csr6(soup, W, H, row_budget=n_small, **walk_kw)
    uncut = csr6.rasterize_csr6(soup, W, H, **walk_kw)
    assert int(full[2]["row_overflow"]) == 0
    _assert_frame(full[:2], tuple(t.numpy() for t in uncut[:2]))


def test_row_budget_matches_jax():
    """``bin_diagnostics6(return_binned=True)`` and ``row_overflow`` equal
    the JAX values, and the cut frame the JAX interpret-mode frame (the
    cut at a range start: both sorts are unstable within a key)."""
    soup, _, cam = adaptive_soup()
    js = jax_soup(soup)
    # The exit-off walk (its binning's keys; the exit changes no winner),
    # its interpreted kernel and the probes (integers) under one jit (the
    # kernel contracts its multiply-adds either way): one compile.
    b = csr6.bin_csr6(soup, W, H)
    starts = b["starts"].numpy()
    n_small = int(starts[-1])
    budget = int(starts[np.searchsorted(starts, n_small // 2)])
    assert 0 < budget < n_small
    d, i, diag = csr6.rasterize_csr6(soup, W, H, row_budget=budget,
                                     allow_exit=False)
    (jd, ji, jdiag), theirs = jax.jit(lambda s: (
        pallas_csr6.rasterize_pallas_csr6(
            s, W, H, row_budget=budget, allow_exit=False, interpret=True,
            return_diag=True),
        [pallas_csr6.bin_diagnostics6(s, W, H, span=span,
                                      return_binned=True)
         for span in (2, 4)]))(js)
    for span, want in zip((2, 4), theirs):
        ours = csr6.bin_diagnostics6(soup, W, H, span=span,
                                     return_binned=True)
        assert [int(x) for x in ours] == [int(x) for x in want]
    assert int(diag["row_overflow"]) == int(jdiag["row_overflow"]) \
        == n_small - budget
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    hit = i.numpy() >= 0
    ulp = np.abs(d.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jd).view(np.int32).astype(np.int64))
    assert ulp[hit].max() <= INTERPRET_ULP
    # render() forwards the knob.
    fb, rdiag = render(soup, cam, RasterConfig(row_budget=budget,
                                               allow_exit=False),
                       return_diag=True)
    assert int(rdiag["row_overflow"]) == n_small - budget
    np.testing.assert_array_equal(fb.index.numpy(), i.numpy())


def test_stream_drops_rows_past_the_budget_without_a_word():
    """ROADMAP queue C: the JAX stream forwards ``row_budget`` to the v6
    walk and reads only ``big_overflow``, so binned prims past the budget
    vanish from a chunk and the stream raises nothing.  The port mirrors
    it: the stream of one chunk == that chunk's cut render."""
    pos, vel = adaptive_cloud()
    cam = tcam(origin=ADAPTIVE_ORIGIN)
    chunk = len(pos)
    soup = StreamingRasterizer(cam, chunk, 0.01, device="cpu").build_soup(
        torch.tensor(pos), torch.full((chunk, 3), 0.3))[0]
    n_small = int(csr6.bin_csr6(soup, W, H)["starts"][-1])
    cfg = RasterConfig(row_budget=n_small // 2)
    sr = StreamingRasterizer(cam, chunk, 0.01, config=cfg, device="cpu")
    depth, index = sr.rasterize([pos])[:2]
    d, i, diag = csr6.rasterize_csr6(soup, W, H, row_budget=n_small // 2)
    assert int(diag["row_overflow"]) > 0
    np.testing.assert_array_equal(index.numpy(), i.numpy())
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  d.numpy().view(np.int32))
    full = csr6.rasterize_csr6(soup, W, H)[1]
    assert (full.numpy() != index.numpy()).any()


def test_pointcloud_matches_jax():
    rng = np.random.default_rng(5)
    for cols in (3, 6):
        raw = rng.normal(size=(7, cols))
        ours, theirs = PointCloud.from_array(raw), JPointCloud.from_array(raw)
        assert ours.num_points == theirs.num_points == 7
        assert ours.has_velocity == theirs.has_velocity == (cols == 6)
        assert isinstance(ours.positions, torch.Tensor)
        np.testing.assert_array_equal(ours.as_array(), theirs.as_array())
        np.testing.assert_array_equal(ours.as_array(), raw)
    for bad in (np.zeros((4, 4)), np.zeros(3)):
        with pytest.raises(ValueError, match="expected"):
            PointCloud.from_array(bad)
    full = PointCloud(positions=torch.zeros(2, 3), colors=torch.ones(2, 3),
                      radii=torch.ones(2))
    assert not full.has_velocity and full.as_array().shape == (2, 3)
