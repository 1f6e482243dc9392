"""The port's flythrough loop (``run/trajectory.py``), ``FramePipeline``'s
``process`` / ``load_stack`` and the example CLI shim, held against the
JAX package on the CPU.

* ``srgb_encode_u8`` against the JAX function: within 1 level (neither
  ``pow`` is correctly rounded), the differing values counted.
* ``TrajectoryScanRenderer`` on ``device="cpu"`` against the JAX renderer
  with ``backend="tiled"`` at 192x104, advected (dt != 0, trails) and
  static (a cloud at rest: the port runs dt = 0): u8 frames within 1
  level on all but a stated share of values (the jitted JAX soup drifts by
  FMA contraction, ROADMAP queue C), final positions within 1e-6.
* Chunking never shows: any ``frames_per_chunk`` gives identical frames
  and positions, on the bench's disc lane too; a forced overflow makes
  ``_certify_chunk`` raise.
* ``process`` iterates a 3-D ``.npy`` stack like the reference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_render_tpu.scene.camera as jcamera
from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.run import trajectory as jtrajectory
from pointcloud_render_tpu_torch.cli import example_renderer
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.io import png
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.run.trajectory import (
    TrajectoryScanRenderer,
    srgb_encode_u8,
)
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)

W, H = 192, 104
LOOK = ((0.3, 0.3, 0.3), (1.0, 1.0, 1.0))
DT = 0.05
FRAMES = [0, 60, 120, 199]
# Share of u8 values allowed to differ by one level from the jitted JAX
# scan: pow is not correctly rounded and the jitted soup drifts by FMA
# contraction (measured on these seeds: 0 of 239,616 values, advected and
# at rest).  No value may differ by more than one level.
U8_DIFF_SHARE = 0.001


def _cloud(n=64, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def test_srgb_encode_u8_matches_jax():
    rng = np.random.default_rng(1)
    rgb = np.concatenate([rng.uniform(-0.1, 1.1, 200_000),
                          np.linspace(0, 1, 4097), [0.0031308, 0.0, 1.0]]
                         ).astype(np.float32)
    ours = srgb_encode_u8(torch.tensor(rgb)).numpy()
    theirs = np.asarray(jtrajectory.srgb_encode_u8(jnp.asarray(rgb)))
    assert ours.dtype == np.uint8 and ours.min() == 0 and ours.max() == 255
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert diff.max() <= 1
    print(f"srgb_encode_u8: {int((diff > 0).sum())} of {diff.size} values "
          "differ by one level")
    assert (diff > 0).mean() < 1e-3


@pytest.fixture(scope="module")
def jax_scan():
    """One compiled JAX scan (traj_ball, tiled backend, dt = DT, 192x104)
    rendering FRAMES of a moving cloud and of the same cloud at rest."""
    mp = pytest.MonkeyPatch()
    orig = jcamera.Camera.__init__

    def patched(self, *a, **kw):
        kw.setdefault("width", W)
        kw.setdefault("height", H)
        orig(self, *a, **kw)

    mp.setattr(jcamera.Camera, "__init__", patched)
    try:
        pos, vel = _cloud()
        tr = jtrajectory.TrajectoryScanRenderer(
            JAX_PRESETS["traj_ball"],
            JRasterConfig(backend="tiled", max_per_tile=256), dt=DT,
            frames_per_chunk=3)
        moving = tr.render_frames(pos, vel, FRAMES)
        at_rest = tr.render_frames(pos, np.zeros_like(vel), FRAMES)
    finally:
        mp.undo()
    return pos, vel, moving, at_rest


def _assert_frames_close(ours, theirs):
    assert len(ours) == len(theirs)
    differing = total = 0
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.shape == b.shape == (H, W, 3) and a.dtype == np.uint8
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1
        differing += int((diff > 0).sum())
        total += diff.size
    print(f"u8 values differing by one level: {differing} of {total}")
    assert differing <= U8_DIFF_SHARE * total


def test_advected_scan_matches_jax(jax_scan):
    pos, vel, (jframes, jpos), _ = jax_scan
    tr = TrajectoryScanRenderer(PRESETS["traj_ball"], dt=DT,
                                frames_per_chunk=3, width=W, height=H,
                                device="cpu")
    frames, final = tr.render_frames(pos, vel, FRAMES)
    _assert_frames_close(frames, jframes)
    np.testing.assert_allclose(final.numpy(), np.asarray(jpos), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(final.numpy(), pos + vel * (DT * 4), rtol=0,
                               atol=1e-6)
    # The dolly-in makes the cloud occupy more pixels later.
    cover = [(f.min(axis=2) < 200).mean() for f in frames]
    assert cover[3] > cover[0]


def test_static_scan_matches_jax(jax_scan):
    pos, vel, _, (jframes, jpos) = jax_scan
    tr = TrajectoryScanRenderer(PRESETS["traj_ball"], frames_per_chunk=3,
                                width=W, height=H, device="cpu")
    frames, final = tr.render_frames(pos, np.zeros_like(vel), FRAMES)
    _assert_frames_close(frames, jframes)
    np.testing.assert_array_equal(final.numpy(), pos)  # dt = 0
    np.testing.assert_array_equal(np.asarray(jpos), pos)


@pytest.mark.parametrize("lane", ["trails", "motion_color", "disc"])
def test_chunking_never_shows(lane):
    """A short last chunk renders only its own frames: positions and
    frames are identical whatever the chunk size (7 % 3 != 0)."""
    pos, vel = _cloud(n=40, seed=7)
    if lane == "disc":  # the bench's disc lane: no trails, fused shade
        preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.02,
                                     point_color=LOOK[0])
        kw = dict(raster_config=RasterConfig(discs_only=True, max_big=256,
                                             uniform_look=LOOK))
        vel = None
    else:
        preset = PRESETS["traj_ball"]
        kw = dict(dt=DT, motion_color=lane == "motion_color")

    def run(fpc):
        tr = TrajectoryScanRenderer(preset, frames_per_chunk=fpc, width=96,
                                    height=64, device="cpu", **kw)
        return tr.render_frames(pos, vel, list(range(7)))

    f3, p3 = run(3)
    f7, p7 = run(7)
    np.testing.assert_array_equal(p3.numpy(), p7.numpy())
    if lane != "disc":
        np.testing.assert_allclose(p3.numpy(), pos + vel * (DT * 7), rtol=0,
                                   atol=1e-6)
    assert len(f3) == len(f7) == 7
    for a, b in zip(f3, f7):
        np.testing.assert_array_equal(a, b)
    assert any((f.min(axis=2) < 200).any() for f in f3)
    if lane == "motion_color":  # speed-mapped splats are not gray
        assert any((np.ptp(f.astype(int), axis=2) > 40).any() for f in f3)


def test_disc_lane_scan_equals_frame_pipeline():
    """Each frame of the disc-lane scan is the sRGB encoding of the frame
    FramePipeline renders with the same config: bit for bit."""
    pos, _ = _cloud(n=200)
    preset = dataclasses.replace(PRESETS["traj_ball"], point_radius=0.01,
                                 point_color=LOOK[0])
    cfg = RasterConfig(discs_only=True, max_big=256, uniform_look=LOOK)
    tr = TrajectoryScanRenderer(preset, cfg, frames_per_chunk=2, width=W,
                                height=H, device="cpu")
    frames, _ = tr.render_frames(pos, None, [10, 120, 219])
    pipe = pipeline.FramePipeline(preset, cfg, width=W, height=H,
                                  device="cpu")
    for frame, fi in zip(frames, (10, 120, 219)):
        fb = pipe.render_array(pos, fi)
        np.testing.assert_array_equal(frame, srgb_encode_u8(fb.rgb).numpy())
        assert (fb.index.numpy() >= 4).any()


def test_certificate_raises_on_overflow():
    """A big list the probe did not size (it ran on other frames) fails
    the chunk loudly instead of truncating."""
    pos, vel = _cloud()
    tr = TrajectoryScanRenderer(
        PRESETS["traj_ball"], RasterConfig(discs_only=True, max_big=8),
        frames_per_chunk=2, width=W, height=H, device="cpu")
    tr._probed = True  # as if an earlier call had probed a gentler range
    with pytest.raises(RuntimeError, match=r"overflow \(\d+ primitives\) in "
                                           r"frames 100\.\.101"):
        tr.render_frames(pos, vel, [100, 101])
    # The probe bins with the render's discs_only flag and sizes max_big.
    tr2 = TrajectoryScanRenderer(
        PRESETS["traj_ball"], RasterConfig(discs_only=True, max_big=8),
        frames_per_chunk=2, width=W, height=H, device="cpu")
    frames, _ = tr2.render_frames(pos, vel, [100, 101])
    assert tr2.raster_config.max_big % 512 == 0 and len(frames) == 2
    with pytest.raises(RuntimeError, match="entry capacity violated"):
        TrajectoryScanRenderer(
            PRESETS["traj_ball"], RasterConfig(entry_capacity=8),
            frames_per_chunk=2, width=W, height=H, device="cpu"
        ).render_frames(pos, vel, [0, 199])


def test_scan_refusals():
    with pytest.raises(ValueError, match="unknown droplet_lod"):
        TrajectoryScanRenderer(PRESETS["traj_vel"], droplet_lod="sphere",
                               device="cpu")
    # Ported since: discs_only at spans 4 and 8 renders in the scan.
    frames, _ = TrajectoryScanRenderer(
        PRESETS["traj_ball"], RasterConfig(discs_only=True, span=4),
        frames_per_chunk=1, width=64, height=48, device="cpu"
    ).render_frames(*_cloud(), [120])
    assert len(frames) == 1 and (frames[0].min(axis=2) < 250).any()
    with pytest.raises(ValueError, match="need velocities"):
        TrajectoryScanRenderer(PRESETS["traj_ball"], dt=DT, device="cpu") \
            .render_frames(_cloud()[0], None, [0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrajectoryScanRenderer(PRESETS["traj_ball"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example_renderer.main(["--input-folder", "nowhere"])


def test_process_iterates_stacks(tmp_path):
    """load_stack prepares every frame of a 3-D stack exactly as the JAX
    pipeline; process renders them in turn and the last frame's PNG
    survives under the input's stem; a 2-D file is a stack of one."""
    rng = np.random.default_rng(2)
    stack = rng.uniform(-1, 1, (3, 150, 6)).astype(np.float32)
    path = tmp_path / "pts_7.npy"
    np.save(path, stack)
    preset = convert.preset_from_fields(JAX_PRESETS["example"])
    assert preset == PRESETS["example"] and preset.iterate_stack
    pipe = pipeline.FramePipeline(preset, width=96, height=64, device="cpu")
    frames = pipe.load_stack(str(path))
    jframes = jpipe.FramePipeline(JAX_PRESETS["example"]).load_stack(str(path))
    assert len(frames) == 3 and frames[0].shape == (150, 3)
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    out = pipe.process(str(path), frame_index=7,
                       output_folder=str(tmp_path / "out"))
    assert out == str(tmp_path / "out" / "pts_7.png")
    with open(out, "rb") as f:
        written = f.read()
    png.write_png(str(tmp_path / "last.png"),
                  pipe.render_array(frames[-1], 7).rgb.numpy())
    png.write_png(str(tmp_path / "first.png"),
                  pipe.render_array(frames[0], 7).rgb.numpy())
    assert written == (tmp_path / "last.png").read_bytes()
    assert written != (tmp_path / "first.png").read_bytes()
    flat = tmp_path / "pts_8.npy"
    np.save(flat, stack[0])
    assert len(pipe.load_stack(str(flat))) == 1
    # A preset that does not iterate takes frame 0 of a stack.
    ball = pipeline.FramePipeline(PRESETS["traj_ball"], width=96, height=64,
                                  device="cpu")
    np.testing.assert_array_equal(ball.load_and_prepare(str(path))[:, :3],
                                  ball.load_stack(str(path))[0][:, :3])
    assert ball.process(str(path), 3, str(tmp_path / "o2")).endswith(
        "pts_7.png")


def test_example_cli_writes_outputs(tmp_path):
    from pointcloud_render_tpu_torch.io import ply

    rng = np.random.default_rng(6)
    inp, out = tmp_path / "ply", tmp_path / "render"
    inp.mkdir()
    for i in (0, 1):
        ply.write_ply(str(inp / f"pts_{i}.ply"),
                      rng.uniform(-1, 1, (120, 3)).astype(np.float32))
    sink = example_renderer.main(
        ["--input-folder", str(inp), "--output-folder", str(out), "--frames",
         "0,1", "--device", "cpu", "--width", "96", "--height", "64"])
    assert [r.status for r in sink.records] == ["ok", "ok"]
    for i in (0, 1):
        assert (out / f"pts_{i}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
