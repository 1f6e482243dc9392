"""The traj_ball slice of the PyTorch port end to end, held against the JAX
package on the CPU.

* Soup: the port's ``build_primitives`` equals the JAX ``build_primitives``
  evaluated op by op bit for bit on every field.  Under ``jit`` XLA's CPU
  compiler contracts multiply-adds into FMAs (the JAX package records the
  same drift for bbox), so against the jitted build kind/color/valid/normal
  are bit-equal and params/bbox agree within a stated relative bound.
* Frame: ``FramePipeline.render_array`` equals the op-by-op JAX
  composition (soup -> ``cpu_reference`` -> ``shade_framebuffer``) bit for
  bit, and the jitted JAX ``FramePipeline`` (``auto`` -> ``tiled`` on CPU)
  with zero winner flips and depth/rgb within stated bounds.
* The CLI writes the expected PNG names; the package imports without jax.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.scene.camera import TARGETS
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu.scene.camera import camera_origin_jax
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu.shading.shade import shade_framebuffer
from pointcloud_render_tpu_torch.cli import traj_ball_renderer
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.io import ply
from pointcloud_render_tpu_torch.raster.render import RasterConfig, render
from pointcloud_render_tpu_torch.run import pipeline, trajectory
from pointcloud_render_tpu_torch.run.metrics import profiler_trace
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import cloud

W, H = 160, 96
FRAMES = (10, 120, 205)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Bounds against the jitted JAX build and frame, as a fraction of each
# column's largest magnitude per kind (measured on this seed: discs and
# capsule endpoints 2e-7, ground triangles 4.7e-6, capsule deltas and
# 1/len^2 1.9e-4 — x1 - x0 cancels, amplifying the endpoints' drift),
# and for the frame (measured: 0 flips, depth 6 ulp, rgb 1.5e-5).
SOUP_REL = {0: 2e-6, 1: 2e-6, 2: 2e-5}
CAPSULE_DELTA_REL = 1e-3
DEPTH_ULP = 8
RGB_ATOL = 3e-5


def _jax_build(pos, vel, fi):
    preset = JAX_PRESETS["traj_ball"]
    origin = camera_origin_jax(preset.camera_preset, fi, preset.total_frames)
    cam = JCamera(origin=origin, target=np.asarray(
        TARGETS["traj_ball"], np.float32), width=W, height=H)
    return jpipe.build_primitives(preset, cam, pos, vel, fi), cam


# One compile serves every frame (the frame index is traced).
_jax_build_jitted = jax.jit(lambda p, v, f: _jax_build(p, v, f)[0])


@functools.lru_cache(maxsize=None)
def _jax_build_eager(fi):
    """The JAX soup and camera of ``cloud()`` at a frame, evaluated op by
    op; shared by the soup test and the frame test."""
    pos, vel = cloud()
    with jax.disable_jit():
        return _jax_build(jnp.asarray(pos), jnp.asarray(vel), jnp.int32(fi))


def _port_build(pos, vel, fi):
    cam = pipeline.frame_camera(PRESETS["traj_ball"], fi, W, H, "cpu")
    return pipeline.build_primitives(PRESETS["traj_ball"], cam,
                                     torch.tensor(pos), torch.tensor(vel), fi)


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("fi", FRAMES)
def test_soup_matches_jax_build_primitives(fi):
    pos, vel = cloud()
    ours = convert.soup_to_numpy(_port_build(pos, vel, fi))
    eager, _ = _jax_build_eager(fi)
    jitted = _jax_build_jitted(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.int32(fi))
    assert ours["valid"].sum() > 300  # discs and trail capsules render
    for name, arr in ours.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(eager, name)),
                                      err_msg=name)
    for name in ("kind", "color", "valid", "normal"):
        np.testing.assert_array_equal(ours[name],
                                      np.asarray(getattr(jitted, name)),
                                      err_msg=name)
    valid = ours["valid"]
    kinds = ours["kind"][valid]
    for name in ("params", "bbox"):
        a, b = ours[name][valid], np.asarray(getattr(jitted, name))[valid]
        for k in np.unique(kinds):
            m = kinds == k
            scale = np.abs(a[m]).max(axis=0)
            bound = np.full(a.shape[1], SOUP_REL[k])
            if name == "params" and k == 1:  # capsule deltas and 1/len^2
                bound[4:9] = CAPSULE_DELTA_REL
            assert (np.abs(a[m] - b[m]) <= bound * scale).all(), (name, k)


def test_frame_matches_jax_pipeline():
    pos, vel = cloud()
    pcl = np.concatenate([pos, vel], axis=1)
    # max_per_tile sized for this scene: the default overflows at frame 10
    # and the JAX pipeline would heal it by compiling a second time.
    jp = jpipe.FramePipeline(JAX_PRESETS["traj_ball"],
                             JRasterConfig(max_per_tile=2048), width=W,
                             height=H)
    tp = pipeline.FramePipeline(PRESETS["traj_ball"], width=W, height=H,
                                device="cpu")
    for fi in FRAMES:
        fb = tp.render_array(pcl, fi)
        index, depth, rgb = fb.index.numpy(), fb.depth.numpy(), fb.rgb.numpy()
        # Bit for bit against the op-by-op JAX composition.
        soup, cam = _jax_build_eager(fi)
        with jax.disable_jit():
            host = jax.tree_util.tree_map(np.asarray, soup)
            d_o, i_o = cpu_reference.rasterize_reference(host, W, H)
            rgb_o = shade_framebuffer(soup, cam, jnp.asarray(d_o),
                                      jnp.asarray(i_o), JShading())
        np.testing.assert_array_equal(index, i_o)
        np.testing.assert_array_equal(depth.view(np.int32), d_o.view(np.int32))
        np.testing.assert_array_equal(rgb, np.asarray(rgb_o))
        assert (index >= 5).any() and (index < 0).sum() < index.size
        # Against the jitted JAX FramePipeline (tiled backend on CPU).
        jfb = jp.render_array(pcl, fi)
        jindex = np.asarray(jfb.index)
        flips = int((jindex != index).sum())
        assert flips == 0, f"frame {fi}: {flips} winner flips"
        hit = index >= 0
        assert _ulp(depth, np.asarray(jfb.depth))[hit].max() <= DEPTH_ULP
        assert np.abs(rgb - np.asarray(jfb.rgb)).max() <= RGB_ATOL


def test_big_list_self_heal_is_exact():
    """A frame whose big list overflows is re-rendered with a larger list
    and comes out identical to a render that never overflowed."""
    pos, vel = cloud(n=120, seed=3)
    pcl = np.concatenate([pos, vel], axis=1)
    small = pipeline.FramePipeline(PRESETS["traj_ball"],
                                   RasterConfig(max_big=1), width=W,
                                   height=H, device="cpu")
    fb = small.render_array(pcl, 120)
    assert small.raster_config.max_big > 1
    ref = pipeline.FramePipeline(PRESETS["traj_ball"], width=W, height=H,
                                 device="cpu").render_array(pcl, 120)
    np.testing.assert_array_equal(fb.index.numpy(), ref.index.numpy())
    np.testing.assert_array_equal(fb.rgb.numpy(), ref.rgb.numpy())


def test_cli_writes_expected_outputs(tmp_path):
    pos, vel = cloud(n=200, seed=5)
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    for fi in (10, 120, 199):
        ply.write_ply(str(inp / f"frame_{fi:04d}_b0.ply"), pos + 0.01 * fi,
                      velocities=vel)
    args = ["--input-folder", str(inp), "--output-folder", str(out),
            "--frames", "10,120,205", "--device", "cpu",
            "--width", "96", "--height", "64"]
    sink = traj_ball_renderer.main(args)
    assert [r.status for r in sink.records] == ["ok"] * 3
    # Frames past 199 reuse frame 199's file under the renamed output.
    for name in ("frame_0010_b0", "frame_0120_b0", "frame_0205_b0"):
        with open(out / f"{name}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    again = traj_ball_renderer.main(args)  # manifest resume: all skipped
    assert again.records == []


def test_profiler_trace_writes_a_trace(tmp_path):
    pos, vel = cloud(n=50)
    trace_dir = str(tmp_path / "trace")
    with profiler_trace(trace_dir):
        pipeline.FramePipeline(PRESETS["traj_ball"], width=64, height=48,
                               device="cpu").render_array(
            np.concatenate([pos, vel], axis=1), 120)
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0


def test_unported_paths_raise():
    # Ported since: backend "pallas" (v2) renders.
    pos, vel = cloud(n=10)
    fb = pipeline.FramePipeline(PRESETS["traj_ball"],
                                RasterConfig(backend="pallas"), width=64,
                                height=48, device="cpu").render_array(
        np.concatenate([pos, vel], axis=1), 120)
    assert bool((fb.index >= 0).any())
    # Ported since: discs_only at spans 4 and 8 renders.
    fb = pipeline.FramePipeline(PRESETS["traj_ball"],
                                RasterConfig(discs_only=True, span=4),
                                width=64, height=48, device="cpu"
                                ).render_array(
        np.concatenate([pos, vel], axis=1), 120)
    assert bool((fb.index >= 0).any())
    # Ported since: pallas3, cap_rows10, span 4 and 8 on the 16-float walk.
    for cfg in (RasterConfig(backend="pallas3"), RasterConfig(cap_rows10=True),
                RasterConfig(span=4), RasterConfig(span=8, cap_rows10=True)):
        pipeline.FramePipeline(PRESETS["traj_ball"], cfg, device="cpu")
    # Ported since: FramePipeline takes the look knobs.  The scan raises
    # for shadows and supersample (the JAX scan drops them), and a fused
    # kernel backend's render() for the look passes it does not evaluate.
    look = RasterConfig(supersample=2, shading=ShadingConfig(
        shadows=True, ground_spec=0.5, gi=0.25))
    pipeline.FramePipeline(PRESETS["traj_ball"], look, device="cpu")
    for cfg in (look, RasterConfig(supersample=2),
                RasterConfig(shading=ShadingConfig(shadows=True))):
        with pytest.raises(NotImplementedError, match="ROADMAP queue C"):
            trajectory.TrajectoryScanRenderer(PRESETS["traj_ball"], cfg,
                                              device="cpu")
    cam = pipeline.frame_camera(PRESETS["traj_ball"], 120, 64, 48, "cpu")
    soup = pipeline.build_primitives(PRESETS["traj_ball"], cam, pos, vel,
                                     120)
    with pytest.raises(NotImplementedError, match="ROADMAP queue C"):
        render(soup, cam, RasterConfig(shading=ShadingConfig(
            ground_spec=0.5)))
    with pytest.raises(ValueError, match="unknown droplet_lod"):
        pipeline.FramePipeline(PRESETS["traj_vel"], droplet_lod="sphere",
                               device="cpu")
    for segs in (0, 21, "fixed"):
        with pytest.raises(ValueError, match="'adaptive' or in 1..20"):
            pipeline.build_primitives(
                PRESETS["traj_ball"], pipeline.frame_camera(
                    PRESETS["traj_ball"], 10, 64, 48, "cpu"), pos, vel, 10,
                trail_segments=segs)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.FramePipeline(PRESETS["traj_ball"], device="cuda")


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import pointcloud_render_tpu_torch.cli.traj_ball_renderer\n"
            "import pointcloud_render_tpu_torch.cli.traj_vel_renderer\n"
            "import pointcloud_render_tpu_torch.cli.example_renderer\n"
            "import pointcloud_render_tpu_torch.run.trajectory\n"
            "import pointcloud_render_tpu_torch.utils.convert\n"
            "import pointcloud_render_tpu_torch.utils.kernels\n"
            "import pointcloud_render_tpu_torch.utils.fidelity\n"
            "import pointcloud_render_tpu_torch.utils.tuned\n"
            "import pointcloud_render_tpu_torch.raster.csr5\n"
            "import pointcloud_render_tpu_torch.scene.spatial\n"
            "import pointcloud_render_tpu_torch.shading.shadow\n"
            "import pointcloud_render_tpu_torch.shading.aa\n"
            "import pointcloud_render_tpu_torch.raster.tiles\n"
            "import pointcloud_render_tpu_torch.raster.alpha\n"
            "import pointcloud_render_tpu_torch.raster.coverage\n"
            "import pointcloud_render_tpu_torch.parallel.streaming\n"
            "import pointcloud_render_tpu_torch.parallel.render_parallel\n"
            "import pointcloud_render_tpu_torch.parallel.multihost\n"
            "import pointcloud_render_tpu_torch.io.native\n"
            "import pointcloud_render_tpu_torch.run.video\n"
            "import pointcloud_render_tpu_torch.geometry.trails\n"
            "import pointcloud_render_tpu_torch.scene.pointcloud\n"
            "from pointcloud_render_tpu_torch import PointCloud\n"
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('pointcloud_render_tpu.') for m in sys.modules "
            "if sys.modules[m] is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
