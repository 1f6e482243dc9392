"""Host state layer of the PyTorch port, held against the JAX package.

The port carries its own NumPy copies of the host code (IO, normalize,
camera schedules, presets) and float32 torch twins of the traced state
(camera origin and axes, velocity trails).  Inputs are made from numpy
seeds and given to both packages.  Bit-equality is the contract: against
``tests/oracles.py`` and the JAX host functions, and — for the float32
torch twins — against the JAX functions evaluated op by op
(``jax.disable_jit``), which is IEEE float32 per operation as the port is.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.geometry import trails as jtrails
from pointcloud_render_tpu.io import loaders as jloaders
from pointcloud_render_tpu.io import ply as jply
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.scene import camera as jcamera
from pointcloud_render_tpu.scene import normalize as jnormalize
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShadingConfig
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import trails
from pointcloud_render_tpu_torch.io import loaders, ply, png
from pointcloud_render_tpu_torch.scene import camera, normalize
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(20261016)


class TestIO:
    @pytest.mark.parametrize("binary", [True, False])
    def test_ply_roundtrip_matches_jax_loader(self, tmp_path, binary):
        pos = RNG.normal(size=(64, 3)).astype(np.float32)
        vel = RNG.normal(size=(64, 3)).astype(np.float32)
        path = str(tmp_path / "cloud.ply")
        ply.write_ply(path, pos, velocities=vel, binary=binary)
        ours = loaders.load_point_cloud(path)
        theirs = jloaders.load_point_cloud(path)
        np.testing.assert_array_equal(ours, theirs)
        assert ours.shape == (64, 6)
        if binary:
            np.testing.assert_array_equal(ours[:, :3], pos)

    def test_jax_written_ply_normals_and_positions_only(self, tmp_path):
        pos = RNG.normal(size=(20, 3)).astype(np.float32)
        nrm = RNG.normal(size=(20, 3)).astype(np.float32)
        path = str(tmp_path / "n.ply")
        jply.write_ply(path, pos, normals=nrm)
        np.testing.assert_array_equal(loaders.load_point_cloud(path)[:, 3:],
                                      nrm)
        assert loaders.load_point_cloud(path, positions_only=True).shape \
            == (20, 3)

    def test_npy_npz_and_unsupported(self, tmp_path):
        arr = RNG.normal(size=(3, 10, 6)).astype(np.float32)
        np.save(tmp_path / "s.npy", arr)
        np.savez(tmp_path / "s.npz", pred=arr[0])
        np.testing.assert_array_equal(
            loaders.load_point_cloud(str(tmp_path / "s.npy"),
                                     positions_only=True), arr[..., :3])
        np.testing.assert_array_equal(
            loaders.load_point_cloud(str(tmp_path / "s.npz")), arr[0])
        with pytest.raises(ValueError):
            loaders.load_point_cloud(str(tmp_path / "s.xyz"))

    def test_png_pure_writer_decodes_to_srgb(self, tmp_path):
        import zlib

        img = RNG.uniform(0, 1, (6, 5, 3)).astype(np.float32)
        path = str(tmp_path / "a.png")
        png._write_png_pure(path, png.to_srgb_u8(img))
        with open(path, "rb") as f:
            data = f.read()
        idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(6, 16)
        np.testing.assert_array_equal(raw[:, 1:].reshape(6, 5, 3),
                                      png.to_srgb_u8(img))
        png.write_png(str(tmp_path / "b.png"), img)
        assert os.path.getsize(tmp_path / "b.png") > 0


class TestNormalize:
    @pytest.mark.parametrize("cols", [3, 6])
    @pytest.mark.parametrize("flip", [True, False])
    def test_matches_oracles_and_jax(self, cols, flip):
        pcl = RNG.normal(size=(200, cols)) * 5 + 2
        std = normalize.standardize_point_cloud(pcl)
        np.testing.assert_array_equal(std, oracles.ref_standardize(pcl))
        np.testing.assert_array_equal(
            std, jnormalize.standardize_point_cloud(pcl))
        out = normalize.transform_coordinates(std, flip_x=flip)
        np.testing.assert_array_equal(out, oracles.ref_transform(std, flip))
        np.testing.assert_array_equal(
            out, jnormalize.transform_coordinates(std, flip_x=flip))


class TestPresets:
    def test_all_presets_equal_jax(self):
        assert set(PRESETS) == set(JAX_PRESETS)
        for name, preset in PRESETS.items():
            assert dataclasses.asdict(preset) == dataclasses.asdict(
                JAX_PRESETS[name])
            assert convert.preset_from_fields(JAX_PRESETS[name]) == preset
        assert PRESETS["traj_ball"].frame_file(205) == "frame_0199_b0.ply"

    def test_config_conversion_keeps_every_field(self):
        jcfg = JRasterConfig(max_big=77, chunk_rows=512,
                             shading=JShadingConfig(ambient=0.25))
        cfg = convert.raster_config_from_fields(jcfg)
        assert cfg.max_big == 77 and cfg.chunk_rows == 512
        assert cfg.shading.ambient == 0.25
        jfields = {f.name for f in dataclasses.fields(JRasterConfig)}
        assert {f.name for f in dataclasses.fields(type(cfg))} == jfields


class TestCamera:
    @pytest.mark.parametrize("preset", ["traj", "traj_ball", "traj_vel",
                                        "traj_b0", "traj_b1",
                                        "traj_original", "example"])
    def test_host_origin_exact(self, preset):
        for f in range(0, 220, 7):
            assert camera.camera_origin(preset, f) == \
                jcamera.camera_origin(preset, f)
        if preset == "traj_ball":
            for f in (0, 19, 100, 199, 200, 210, 219):
                assert camera.camera_origin(preset, f) == \
                    oracles.ref_camera_two_phase(f, *camera._WAYPOINTS[preset])

    @pytest.mark.parametrize("preset", ["traj", "traj_ball", "traj_b0",
                                        "traj_original", "example"])
    def test_torch_origin_bit_equal_to_jax(self, preset):
        with jax.disable_jit():
            for f in (0, 10, 57, 120, 199, 200, 205, 219):
                ours = camera.camera_origin_torch(preset, f).numpy()
                theirs = np.asarray(jcamera.camera_origin_jax(
                    preset, jnp.int32(f)))
                np.testing.assert_array_equal(ours, theirs)

    def test_world_to_camera_bit_equal_to_jax(self):
        with jax.disable_jit():
            for f in (10, 120, 205):
                jo = jcamera.camera_origin_jax("traj_ball", jnp.int32(f))
                jcam = jcamera.Camera(origin=jo, target=jnp.asarray(
                    jcamera.TARGETS["traj_ball"], jnp.float32))
                cam = camera.Camera(
                    origin=camera.camera_origin_torch("traj_ball", f),
                    target=torch.tensor(camera.TARGETS["traj_ball"]))
                np.testing.assert_array_equal(
                    cam.world_to_camera_matrix().numpy(),
                    np.asarray(jcam.world_to_camera_matrix()))
        r, u, fw = camera.look_at_axes((2.0, 2.0, 2.0), (0.0, 0.0, -0.05))
        assert abs(float((r * fw).sum())) < 1e-6
        assert abs(float((u * fw).sum())) < 1e-6


class TestTrails:
    @pytest.mark.parametrize("schedule", ["ball", "vel", "fixed"])
    def test_length_scale_matches_jax(self, schedule):
        for f in range(0, 220):
            ours = trails.trail_length_scale(schedule, f).numpy()
            theirs = np.asarray(jtrails.trail_length_scale(schedule, f))
            np.testing.assert_array_equal(ours, theirs)
            assert float(ours) == pytest.approx(
                oracles.ref_trail_length_scale(schedule, f), abs=1e-7)

    def test_golden_21_point_trail(self):
        pos = np.array([0.1, -0.2, 0.3])
        vel = np.array([1.5, -2.0, 0.7])
        got = trails.velocity_trail_points(pos, vel, 1.0)
        np.testing.assert_array_equal(got, oracles.ref_velocity_trail(
            pos, vel, 1.0))
        np.testing.assert_array_equal(
            got, jtrails.velocity_trail_points(pos, vel, 1.0))
        assert got.shape == (21, 3)

    def test_batched_trails_bit_equal_to_jax(self):
        pos = RNG.normal(size=(60, 3)).astype(np.float32)
        vel = (RNG.normal(size=(60, 3)) * 3).astype(np.float32)
        vel[5] = 0.0  # below epsilon -> invalid
        pos[9, 1] = np.nan  # non-finite -> invalid
        sub = np.round(np.linspace(0, 20, 9)).astype(np.int32)
        for fi, sched in ((10, "ball"), (120, "ball"), (205, "vel")):
            with jax.disable_jit():
                jpts, jvalid = jtrails.velocity_trails(pos, vel, fi, sched)
                jcols, jcvalid = jtrails.velocity_trail_vertex_columns(
                    pos, vel, fi, sub, sched)
            pts, valid = trails.velocity_trails(torch.tensor(pos),
                                                torch.tensor(vel), fi, sched)
            np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
            np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
            cols, cvalid = trails.velocity_trail_vertex_columns(
                torch.tensor(pos), torch.tensor(vel), fi, sub, sched)
            for c, jc in zip(cols, jcols):
                np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(cvalid.numpy(), np.asarray(jcvalid))
            assert not cvalid[5] and not cvalid[9]
            # The columns are the full build's sampled vertices.
            np.testing.assert_array_equal(
                torch.stack(cols, 1).numpy(), pts.numpy()[:, sub])
        # Against the float64 golden trail, to float32 rounding.
        full, _ = trails.velocity_trails(torch.tensor(pos), torch.tensor(vel),
                                         50, "ball")
        np.testing.assert_allclose(full.numpy()[0], oracles.ref_velocity_trail(
            pos[0], vel[0], 1.0), atol=1e-5)


def test_const_cache_keeps_shape_and_shares_uploads():
    """utils.consts.const: scalars stay 0-d, arrays keep shape and dtype,
    equal values share one tensor per device."""
    from pointcloud_render_tpu_torch.utils.consts import const

    a = const(19.0, np.float32, "cpu")
    assert a.shape == () and a.dtype == torch.float32 and float(a) == 19.0
    assert const(19.0, np.float32, None) is a
    b = const(np.arange(6).reshape(2, 3).T, np.int32, "cpu")
    assert b.shape == (3, 2) and b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), np.arange(6).reshape(2, 3).T)
    assert const((1.0, 2.0), np.float32, "cpu") is not const(
        (1.0, 2.0), np.float64, "cpu")

