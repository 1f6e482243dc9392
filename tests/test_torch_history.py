"""The history-trail slice of the port (the traj preset: droplets with
Catmull-Rom history-fit trails), held against the JAX package on the CPU.

* ``catmull_rom_trails`` against the JAX function for m = 0, 1, 2, 3, 7
  and 20 history frames (and more than the window), with NaN rows, exact
  duplicates (the dedup) and closed curves (the trim): points bit-equal,
  valid and keep equal.
* ``capsules_from_polylines`` against the JAX builder run op by op
  (``jax.disable_jit``): every field bit-equal, with a scalar radius and
  with per-vertex radii and per-polyline colors.
* A 160x96 traj frame (``cloud()``, frame 23, 20 frames of history) of
  ``FramePipeline`` against the NumPy oracle on its own soup (bit-equal)
  and against the jitted JAX FramePipeline (tiled on CPU) within
  FRAME_FLIPS, DEPTH_ULP and RGB_ATOL (ROADMAP queue C); cap_rows10 at
  spans 2 and 4 renders the same frame.
* The batch runner's history windows against the JAX runner's.
* The scan's rolling history buffer against the JAX
  ``TrajectoryScanRenderer`` on a 64-point, 192x104 scan, and against
  ``FramePipeline`` frames with the same history.
* ``CameraPath`` against the JAX class; the traj, traj_b0, traj_b1 and
  traj_original CLI shims on the CPU; the traj frame's rows per point
  (the 2^24 id limit: 762,600 points at most).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_render_tpu.scene.camera as jcamera
from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.geometry import trails as jtrails
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import primitives as jprims
from pointcloud_render_tpu.raster.render import FrameBuffers as JFrameBuffers
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import batch as jbatch
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.run import trajectory as jtrajectory
from pointcloud_render_tpu.scene import camera_path as jcamera_path
from pointcloud_render_tpu_torch.cli import (
    traj_b0,
    traj_b1,
    traj_original,
    traj_renderer,
)
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import trails
from pointcloud_render_tpu_torch.io import ply
from pointcloud_render_tpu_torch.raster.primitives import (
    ScreenPrimitives,
    capsules_from_polylines,
)
from pointcloud_render_tpu_torch.raster.render import (
    FrameBuffers,
    RasterConfig,
    render,
)
from pointcloud_render_tpu_torch.run import batch, pipeline
from pointcloud_render_tpu_torch.run.trajectory import (
    TrajectoryScanRenderer,
    srgb_encode_u8,
)
from pointcloud_render_tpu_torch.scene import camera_path, dynamics
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import jcam, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import cloud, tcam

W, H = 160, 96
FI = 23
DT = 0.002
# The traj frame against the jitted JAX FramePipeline (tiled on CPU): the
# JAX soup drifts by XLA's multiply-add contraction and the batch
# rotations' rounding (ROADMAP queue C), which moves trail vertices by
# ulps (measured: 0 flips, 4 ulp, rgb 4.9e-6).
FRAME_FLIPS = 2
DEPTH_ULP = 8
RGB_ATOL = 3e-5
# Scan frames against the jitted JAX scan: u8 values off by one level
# (pow is correctly rounded in neither package; the soup drifts as
# above; measured: 0 of 419,328 values).  None may differ by more.
U8_DIFF_SHARE = 0.001


def _bits(a):
    return np.asarray(a).view(np.int32)


def _history_case(m, n=64, seed=5):
    """(history (m, n, 3), positions (n, 3)) random walks with the
    reference's edge cases: a NaN point, a point at rest (every vertex a
    duplicate), one that returns to its first position (a closed curve:
    the trim) and one NaN over its older half."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-0.5, 0.5, (n, 3))
    h = p0[None] + rng.normal(0, 0.02, (m + 1, n, 3)).cumsum(axis=0)
    h[:, 1] = np.nan
    h[:, 2] = h[0, 2]
    # The ring closes over the window the trail uses (the last 20).
    first = m - min(m, 20)
    ring = 2.0 * np.pi * np.clip(np.arange(m + 1) - first, 0, None) / max(
        m - first, 1)
    h[:, 4] = p0[4] + 0.05 * np.stack(
        [np.sin(ring), np.cos(ring) - 1.0, 0.0 * ring], axis=1)
    h[:m // 2, 5] = np.nan
    h = h.astype(np.float32)
    return h[:m], h[m]


@pytest.mark.parametrize("m", [0, 1, 2, 3, 7, 20, 25])
def test_catmull_rom_trails_match_jax(m):
    hist, pos = _history_case(m)
    pts, valid, keep = trails.catmull_rom_trails(torch.tensor(hist),
                                                 torch.tensor(pos))
    jpts, jvalid, jkeep = jtrails.catmull_rom_trails(jnp.asarray(hist),
                                                     jnp.asarray(pos))
    np.testing.assert_array_equal(_bits(pts.numpy()), _bits(jpts))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    k = keep.numpy()
    assert not valid[1] and (m < 2 or valid.numpy().sum() > 50)
    if m >= 2:
        assert k[2].sum() == 1  # every vertex a duplicate of the first
        assert not valid[2]
    if m >= 3:
        # The closed curve's last kept vertex (the current position, equal
        # to its first) is trimmed.
        assert k[4, 0] and not k[4, -1] and k[4].sum() >= 2


def test_capsules_from_polylines_match_jax_op_by_op():
    hist, pos = _history_case(20, n=48, seed=8)
    jpts, jvalid, jkeep = jtrails.catmull_rom_trails(jnp.asarray(hist),
                                                     jnp.asarray(pos))
    pts = torch.tensor(np.asarray(jpts))
    vkeep = np.asarray(jkeep) & np.asarray(jvalid)[:, None]
    rng = np.random.default_rng(3)
    radii = rng.uniform(0.001, 0.004, vkeep.shape).astype(np.float32)
    colors = rng.uniform(0, 1, (vkeep.shape[0], 3)).astype(np.float32)
    for radius, color in ((0.0007, np.array([0.2, 1.0, 0.4], np.float32)),
                          (radii, colors)):
        ours = convert.soup_to_numpy(capsules_from_polylines(
            pts, torch.tensor(vkeep), tcam(), radius, color))
        with jax.disable_jit():
            theirs = jprims.capsules_from_polylines(
                jnp.asarray(jpts), jnp.asarray(vkeep), jcam(), radius, color)
        for name, arr in ours.items():
            want = np.asarray(getattr(theirs, name))
            if arr.dtype == np.float32:
                # NaN lanes of invalid rows (NaN vertices) match as NaN:
                # their sign bits are each library's own.
                nan = np.isnan(arr)
                np.testing.assert_array_equal(nan, np.isnan(want))
                arr, want = np.where(nan, 0, arr), np.where(nan, 0, want)
            np.testing.assert_array_equal(
                arr.view(np.uint8), want.view(np.uint8), err_msg=name)
        assert ours["valid"].sum() > 200


def _frames(n_frames, n=300, seed=0):
    """Prepared (N, 6) arrays of frames 0..n_frames-1: ``cloud()`` moving
    with its velocities plus a wobble (the trails curve)."""
    pos, vel = cloud(n, seed)
    phase = np.random.default_rng(seed + 1).uniform(0, 6.3, (n, 3))
    out = []
    for k in range(n_frames):
        p = pos + vel * (DT * k) + 0.01 * np.sin(0.5 * k + phase)
        out.append(np.concatenate([p, vel], axis=1).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def traj_frame():
    """Frame FI of the traj preset with 20 frames of history, rendered by
    the port and by the jitted JAX FramePipeline (tiled on CPU)."""
    frames = _frames(FI + 1)
    pcl = frames[FI]
    history = np.stack([f[:, :3] for f in frames[FI - 20:FI]])
    ours = pipeline.FramePipeline(PRESETS["traj"], width=W, height=H,
                                  device="cpu").render_array(pcl, FI, history)
    jfb = jpipe.FramePipeline(
        JAX_PRESETS["traj"], JRasterConfig(max_per_tile=1 << 14), width=W,
        height=H).render_array(pcl, FI, history)
    return pcl, history, ours, jfb


def test_traj_frame_matches_jax_pipeline(traj_frame):
    pcl, history, ours, jfb = traj_frame
    cam = pipeline.frame_camera(PRESETS["traj"], FI, W, H, "cpu")
    soup, layout = pipeline.build_primitives(
        PRESETS["traj"], cam, pcl[:, :3], pcl[:, 3:], FI,
        torch.tensor(history), return_layout=True)
    n = pcl.shape[0]
    assert layout == [(4, 0), (n, 1), (n, 1), (20 * n, 20)]
    trail = soup.valid[4 + 2 * n:]
    assert int(trail.sum()) > 10 * n  # the history trails render
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), W, H)
    np.testing.assert_array_equal(ours.index.numpy(), i_o)
    np.testing.assert_array_equal(_bits(ours.depth.numpy()), _bits(d_o))
    index = ours.index.numpy()
    assert (index >= 4 + 2 * n).sum() > 200  # trail pixels win
    same = index == np.asarray(jfb.index)
    flips = int((~same).sum())
    hit = same & (index >= 0)
    ulp = np.abs(_bits(ours.depth.numpy()).astype(np.int64)
                 - _bits(jfb.depth))[hit].max()
    rgb = np.abs(ours.rgb.numpy() - np.asarray(jfb.rgb))[same].max()
    print(f"traj frame vs jitted JAX: {flips} flips, depth {ulp} ulp, rgb "
          f"{rgb:.3g}")
    assert flips <= FRAME_FLIPS and ulp <= DEPTH_ULP and rgb <= RGB_ATOL
    # cap_rows10 at spans 2 and 4 walks the same winners and depth bits.
    for span in (2, 4):
        fb = render(soup, cam, RasterConfig(cap_rows10=True, span=span))
        np.testing.assert_array_equal(fb.index.numpy(), i_o)
        np.testing.assert_array_equal(_bits(fb.depth.numpy()), _bits(d_o))
        np.testing.assert_array_equal(fb.rgb.numpy(), ours.rgb.numpy())


def test_batch_history_windows_match_jax(tmp_path, monkeypatch):
    """run_batch's preload and sliding windows (a missing frame, a frame
    that fails to load) against the JAX runner's, both recording the
    history each render receives."""
    frames = _frames(26, n=20)
    inp = tmp_path / "in"
    inp.mkdir()
    for k, f in enumerate(frames):
        if k == 5:
            continue  # missing: a warning, no window slot
        ply.write_ply(str(inp / f"frame_{k:04d}_b0.ply"), f[:, :3],
                      velocities=f[:, 3:])
    (inp / "frame_0009_b0.ply").write_bytes(b"not a ply")
    seen = {}

    def record(key, buffers, xp):
        def render_array(self, pcl, frame_index, history=None):
            seen.setdefault(key, {})[frame_index] = (
                None if history is None else np.asarray(history).copy(),
                np.asarray(pcl).copy())
            return buffers(rgb=xp.zeros((4, 4, 3)), depth=xp.zeros((4, 4)),
                           index=xp.zeros((4, 4)))
        return render_array

    monkeypatch.setattr(pipeline.FramePipeline, "render_array",
                        record("port", FrameBuffers, torch))
    monkeypatch.setattr(jpipe.FramePipeline, "render_array",
                        record("jax", JFrameBuffers, np))
    ids = list(range(26))
    sink = batch.run_batch(
        PRESETS["traj"], str(inp), str(tmp_path / "o1"), ids,
        pipeline.FramePipeline(PRESETS["traj"], device="cpu"))
    jsink = jbatch.run_batch(JAX_PRESETS["traj"], str(inp),
                             str(tmp_path / "o2"), ids,
                             jpipe.FramePipeline(JAX_PRESETS["traj"]))
    assert ([(r.frame_index, r.status) for r in sink.records]
            == [(r.frame_index, r.status) for r in jsink.records])
    rendered = [fi for fi in ids if fi not in (5, 9)]
    assert sorted(seen["port"]) == sorted(seen["jax"]) == rendered
    for fi in rendered:
        (h, p), (jh, jp) = seen["port"][fi], seen["jax"][fi]
        np.testing.assert_array_equal(p, jp)
        assert (h is None) == (jh is None)
        if h is not None:
            np.testing.assert_array_equal(h, jh)
    assert seen["port"][0][0] is None
    assert seen["port"][10][0].shape[0] == 8  # frames 0-9 less 5 and 9
    assert seen["port"][25][0].shape[0] == 18  # frames 5-24 less 5 and 9


def _jax_scan(preset, pos, vel, ids, w, h):
    """The JAX scan at a w x h film (its Camera takes the default film)."""
    mp = pytest.MonkeyPatch()
    orig = jcamera.Camera.__init__

    def patched(self, *a, **kw):
        kw.setdefault("width", w)
        kw.setdefault("height", h)
        orig(self, *a, **kw)

    mp.setattr(jcamera.Camera, "__init__", patched)
    try:
        return jtrajectory.TrajectoryScanRenderer(
            JAX_PRESETS[preset], JRasterConfig(backend="tiled",
                                               max_per_tile=1 << 13),
            dt=DT * 4, frames_per_chunk=3).render_frames(pos, vel, ids)
    finally:
        mp.undo()


def test_scan_history_buffer_matches_jax():
    """The rolling buffer: frames 0-6 from frame 0 (chunks of 3, the last
    short), so the buffer fills during the scan; u8 frames within one
    level of the jitted JAX scan's and final positions within 1e-6; each
    frame equals FramePipeline's given the buffer's history."""
    pos, vel = cloud(n=64, seed=4)
    w, h = 192, 104
    ids = list(range(7))
    jframes, jpos = _jax_scan("traj", pos, vel, ids, w, h)
    scan = TrajectoryScanRenderer(PRESETS["traj"], dt=DT * 4,
                                  frames_per_chunk=3, width=w, height=h,
                                  device="cpu")
    frames, final = scan.render_frames(pos, vel, ids)
    differing = 0
    for a, b in zip(frames, jframes):
        diff = np.abs(a.astype(int) - np.asarray(b).astype(int))
        assert diff.max() <= 1
        differing += int((diff > 0).sum())
    print(f"traj scan vs jitted JAX: {differing} u8 values differ by one")
    assert differing <= U8_DIFF_SHARE * len(ids) * w * h * 3
    np.testing.assert_allclose(final.numpy(), np.asarray(jpos), rtol=0,
                               atol=1e-6)
    pipe = pipeline.FramePipeline(PRESETS["traj"], width=w, height=h,
                                  device="cpu")
    states = [torch.tensor(pos)]
    for _ in ids[1:]:
        states.append(dynamics.advect(states[-1], torch.tensor(vel), DT * 4))
    states = [s.numpy() for s in states]
    for k in (1, 6):
        history = np.stack([states[0]] * (20 - k) + states[:k])
        want = pipe.render_array(np.concatenate([states[k], vel], axis=1),
                                 k, history)
        np.testing.assert_array_equal(frames[k],
                                      srgb_encode_u8(want.rgb).numpy())
    assert (frames[6].min(axis=2) < 250).mean() > 0.005


def test_camera_path_matches_jax():
    custom = dict(waypoints=((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 2)),
                  segment_frames=(10, 10, 10))
    paths = [(name, p, jcamera_path.REFERENCE_PATHS[name])
             for name, p in camera_path.REFERENCE_PATHS.items()]
    for interp in ("linear", "catmull"):
        paths.append((interp, camera_path.CameraPath(
            interpolation=interp, **custom), jcamera_path.CameraPath(
            interpolation=interp, **custom)))
    for name, p, jp in paths:
        assert p.total_frames == jp.total_frames
        for f in (0, 5, 15, 19, 30, 100, 199, 200, 210, 219):
            assert p.origin(f) == jp.origin(f), (name, f)
            got = p.origin_torch(torch.tensor(f, dtype=torch.float32))
            np.testing.assert_array_equal(
                _bits(got.numpy()), _bits(jp.origin_jax(jnp.int32(f))),
                err_msg=f"{name} {f}")
    cam = camera_path.CameraPath(waypoints=((2, 2, 2),),
                                 segment_frames=()).camera(0, 128, 64, "cpu")
    assert cam.width == 128
    np.testing.assert_array_equal(cam.origin.numpy(), (2, 2, 2))
    with pytest.raises(ValueError, match="positive"):
        camera_path.CameraPath(waypoints=((0, 0, 0), (1, 1, 1), (2, 2, 2)),
                               segment_frames=(0, 20))


def test_history_cli_shims_on_cpu(tmp_path):
    """The traj CLI renders a history window (records ok, PNGs); the other
    three shims render their presets."""
    frames = _frames(4, n=40)
    inp = tmp_path / "in"
    inp.mkdir()
    for k, f in enumerate(frames):
        for suffix in ("b0", "b1"):
            ply.write_ply(str(inp / f"frame_{k:04d}_{suffix}.ply"), f[:, :3],
                          velocities=f[:, 3:])
    film = ["--device", "cpu", "--width", "64", "--height", "48",
            "--input-folder", str(inp)]
    sink = traj_renderer.main(film + ["--output-folder", str(tmp_path / "t"),
                                      "--frames", "0:4"])
    assert [r.status for r in sink.records] == ["ok"] * 4
    for k in range(4):
        assert (tmp_path / "t" / f"frame_{k:04d}_b0.png").read_bytes()[:8] \
            == b"\x89PNG\r\n\x1a\n"
    for shim, name in ((traj_b0, "b0"), (traj_b1, "b1"),
                       (traj_original, "orig")):
        out = tmp_path / name
        sink = shim.main(film + ["--output-folder", str(out), "--frames",
                                 "3"])
        assert [r.status for r in sink.records] == ["ok"], name
        assert len(os.listdir(out)) >= 1


def test_traj_rows_per_point_and_id_limit():
    """A traj frame holds the ground's 4 rows and 22 per point (head disc,
    tail capsule, 20 trail capsules), so 762,600 points at most; a
    stride-0 soup of 2^24 rows raises the JAX package's ValueError in the
    cap_rows10 walk and in pallas3."""
    pos, vel = cloud(n=5, seed=1)
    cam = pipeline.frame_camera(PRESETS["traj"], FI, 64, 48, "cpu")
    hist = torch.tensor(np.stack([pos] * 20))
    layout = pipeline.build_primitives(PRESETS["traj"], cam, pos, vel, FI,
                                       hist, return_layout=True)[1]
    fixed = sum(r for r, per in layout if per == 0)
    per_point = sum(per for _, per in layout)
    assert (fixed, per_point) == (4, 22)
    assert 762600 * per_point + fixed < (1 << 24) <= 762601 * per_point \
        + fixed
    n = 1 << 24
    soup = pipeline.build_primitives(PRESETS["traj"], cam, pos, vel, FI)
    big = ScreenPrimitives(**{
        f.name: getattr(soup, f.name)[:1].expand(
            n, *getattr(soup, f.name).shape[1:])
        for f in dataclasses.fields(ScreenPrimitives)})
    for cfg in (RasterConfig(cap_rows10=True, span=4),
                RasterConfig(backend="pallas3")):
        with pytest.raises(ValueError, match="2\\^24"):
            render(big, cam, cfg)
