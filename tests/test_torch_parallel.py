"""The port's sharded renders (``parallel/render_parallel.py``,
``parallel/multihost.py`` and the stream's ``mesh=`` path) on a gloo
world of CPU ranks, held against the port's single-device renders and the
JAX package.

One world of four ranks is spawned for the module (``tests/torch_dist.py``
runs every case on every rank and writes each rank's results); the tests
here compare them, at 160x96 on the plain walks:

* every result is replicated: each rank holds rank 0's arrays;
* ``render_point_sharded`` at 1, 2 and 4 ranks == the single-device
  capped ``tiled`` render (shard-count invariance), and
  ``render_batch_sharded`` on a (2, 2) mesh == it per frame;
* ``render_scene_point_sharded`` == ``FramePipeline``'s frame on the
  same backend, rgb, depth and index bit for bit: traj_ball (velocity
  trails), traj (history trails), traj_vel (capsule-LOD droplets) and the
  mesh LOD (the split2 layout), under ``tiled``, ``pallas6`` and
  ``pallas4``; at 1, 2 and 4 ranks; ``rows9=True`` == the exact walk, as
  the JAX package drops rows9;
* ``render_scene_batch_sharded`` on a (2, 2) mesh == the per-frame
  point-sharded frames and ``FramePipeline``; ``render_frames_dp`` on a
  (4, 1) mesh == ``FramePipeline`` per frame;
* a small ``max_per_tile``: the overflow == the sum of ``tile_overflow``
  over the ranks' soups;
* ``make_render_mesh``'s and ``make_pod_mesh``'s layouts and errors,
  ``initialize`` (idempotent; a world of one without a coordinator);
* the 2-rank mesh stream == the 1-rank mesh stream == the stream without
  a mesh bit for bit (depth, index, attributes), and its two ValueErrors.

Against the JAX package (two jitted calls on the conftest's simulated
CPU devices, a (1, 4) mesh): ``render_point_sharded`` and
``render_scene_point_sharded(tiled)`` on the same seeded inputs: index
equal, depth within DEPTH_ULP and rgb within RGB_ATOL, the bounds of
``test_torch_pipeline.py::test_frame_matches_jax_pipeline`` (XLA contracts
the projection's multiply-adds; the port evaluates each operation).
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.parallel import render_parallel as jrp
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu_torch.parallel import multihost
from pointcloud_render_tpu_torch.parallel.render_parallel import (
    drop_furniture,
)
from pointcloud_render_tpu_torch.raster import tiles
from pointcloud_render_tpu_torch.raster.primitives import discs_from_points
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.run import pipeline
from tests import torch_dist as td
from tests.torch_jax import jcam
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import tcam

DEPTH_ULP = 8
RGB_ATOL = 3e-5
WORLD_TIMEOUT_S = 240
FIELDS = ("rgb", "depth", "index")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results (a dict of arrays per rank) of one spawned
    world of ``td.WORLD`` gloo ranks."""
    out = tmp_path_factory.mktemp("world")
    ctx = mp.spawn(td.run_rank, args=(_free_port(), str(out)),
                   nprocs=td.WORLD, join=False)
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the world did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(td.WORLD)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_frame(got, want, fields=FIELDS):
    """Bit equality of each field of two frames (dicts or FrameBuffers)."""
    for f in fields:
        w = want[f] if isinstance(want, dict) else getattr(want, f).numpy()
        np.testing.assert_array_equal(_bits(got[f]), _bits(w), err_msg=f)


def _get(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def pipeline_frames():
    """The single-device FramePipeline frame of each scene and backend."""
    out = {}
    for name in td.SCENES:
        s = td.scene(name)
        for b in td.BACKENDS:
            out[name, b] = pipeline.FramePipeline(
                s["preset"], td.scene_config(name, b),
                droplet_lod=s["droplet_lod"], width=td.W, height=td.H,
                device="cpu").render_array(s["pcl"], s["frame"],
                                           s["history"])
    return out


def test_world_results_are_replicated(ranks):
    assert [int(r["world/rank"]) for r in ranks] == list(range(td.WORLD))
    assert {int(r["world/size"]) for r in ranks} == {td.WORLD}
    for key, value in ranks[0].items():
        if key.startswith(("world/", "pod/")):
            continue
        for r, res in enumerate(ranks[1:], 1):
            if key in res:
                np.testing.assert_array_equal(_bits(res[key]), _bits(value),
                                              err_msg=f"{key} on rank {r}")


def test_meshes_and_their_errors(ranks):
    for r, res in enumerate(ranks):
        host = r // 2
        assert tuple(res["pod/shape"]) == (2, 2)
        assert list(res["pod/points"]) == [2 * host, 2 * host + 1]
        assert list(res["pod/frames"]) == [r % 2, r % 2 + 2]
        assert "must divide local devices 2" in str(res["errors/pod_points_3"])
        assert str(res["errors/mesh_too_big"]) == "need 8 devices, have 4"


def test_initialize_gives_a_world_of_one(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    try:
        multihost.initialize(device_type="cpu")
        multihost.initialize(device_type="cpu")  # a no-op
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
        mesh = multihost.make_pod_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()
    monkeypatch.setitem(multihost._AVAILABLE, "nccl", lambda: False)
    with pytest.raises(RuntimeError, match="'nccl' is not available"):
        multihost.initialize(device_type="cuda")
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize(num_processes=2, device_type="cpu")
    assert not dist.is_initialized()


def _disc_frame(pos, radii, colors):
    cam = tcam(td.W, td.H)
    prims = discs_from_points(torch.tensor(pos), cam, torch.tensor(radii),
                              torch.tensor(colors))
    cfg = td.disc_config()
    depth, index, diag = tiles.rasterize_tiled(
        prims, td.W, td.H, max_per_tile=cfg.max_per_tile)
    assert int(diag["dropped"]) == 0
    index = index.numpy()
    rgb = np.where(index[..., None] >= 0, colors[np.maximum(index, 0)], 1.0)
    return dict(rgb=rgb.astype(np.float32), depth=depth.numpy(), index=index)


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_point_sharded_equals_single_device(ranks, n_ranks):
    got = _get(ranks[0], f"disc/{n_ranks}")
    assert int(got["overflow"]) == 0
    want = _disc_frame(*td.disc_inputs())
    assert (want["index"] >= 0).mean() > 0.05
    _assert_frame(got, want)


def test_batch_sharded_equals_single_device(ranks):
    got = _get(ranks[0], "disc_batch")
    pos, radii, colors = td.disc_inputs()
    assert list(got["overflow"]) == [0, 0]
    for k, (p, c) in enumerate([(pos, colors), (pos[::-1], colors[::-1])]):
        _assert_frame({f: got[f][k] for f in FIELDS},
                      _disc_frame(p.copy(), radii, c.copy()))


@pytest.mark.parametrize("backend", td.BACKENDS)
@pytest.mark.parametrize("scene", td.SCENES)
def test_scene_point_sharded_equals_pipeline(ranks, pipeline_frames, scene,
                                             backend):
    got = _get(ranks[0], f"scene/{scene}/{backend}/4")
    assert int(got["overflow"]) == 0
    _assert_frame(got, pipeline_frames[scene, backend])


@pytest.mark.parametrize("n_ranks", [1, 2])
@pytest.mark.parametrize("backend", td.FEW_RANKS_BACKENDS)
def test_scene_point_sharded_at_fewer_ranks(ranks, pipeline_frames, backend,
                                            n_ranks):
    got = _get(ranks[0], f"scene/traj_ball/{backend}/{n_ranks}")
    assert int(got["overflow"]) == 0
    _assert_frame(got, pipeline_frames["traj_ball", backend])


def test_sharded_rows9_is_dropped(ranks, pipeline_frames):
    """The JAX sharded dispatch drops rows9 (ROADMAP queue C): the port's
    sharded rows9 frame is the exact pallas6 frame, where the
    single-device rows9 frame has other depth bits."""
    got = _get(ranks[0], "rows9")
    _assert_frame(got, pipeline_frames["traj_ball", "pallas6"])
    s = td.scene("traj_ball")
    rows9 = pipeline.FramePipeline(
        s["preset"], RasterConfig(backend="pallas6", rows9=True),
        width=td.W, height=td.H, device="cpu").render_array(s["pcl"],
                                                            s["frame"])
    assert (_bits(got["depth"]) != _bits(rows9.depth.numpy())).any()


def test_scene_batch_sharded_equals_point_sharded(ranks):
    got = _get(ranks[0], "batch")
    assert list(got["overflow"]) == [0, 0]
    s = td.scene("traj_ball")
    pcls = [s["pcl"], s["pcl"][::-1].copy()]
    pipe = pipeline.FramePipeline(s["preset"], RasterConfig(backend="tiled"),
                                  width=td.W, height=td.H, device="cpu")
    for j, fi in enumerate(td.BATCH_FRAMES):
        frame = {f: got[f][j] for f in FIELDS}
        _assert_frame(frame, _get(ranks[0], f"batch_ref/{j}"))
        _assert_frame(frame, pipe.render_array(pcls[j], fi))


def test_frames_dp_equals_pipeline(ranks):
    got = _get(ranks[0], "dp")
    s = td.scene("traj_ball")
    pipe = pipeline.FramePipeline(s["preset"], RasterConfig(backend="tiled"),
                                  width=td.W, height=td.H, device="cpu")
    assert got["index"].shape == (len(td.DP_FRAMES), td.H, td.W)
    for j, fi in enumerate(td.DP_FRAMES):
        _assert_frame({f: got[f][j] for f in FIELDS},
                      pipe.render_array(s["pcl"], fi))


def test_overflow_is_the_sum_over_the_shards(ranks):
    s = td.scene("traj_ball")
    n_local = s["pcl"].shape[0] // td.WORLD
    cam = pipeline.frame_camera(s["preset"], s["frame"], td.W, td.H, "cpu")
    want = 0
    for shard in range(td.WORLD):
        p = s["pcl"][shard * n_local:(shard + 1) * n_local]
        soup, layout = pipeline.build_primitives(
            s["preset"], cam, p[:, :3], p[:, 3:], s["frame"],
            return_layout=True)
        if shard:
            soup = drop_furniture(soup, layout)
        want += int(tiles.tile_overflow(soup, td.W, td.H,
                                        max_per_tile=td.OVERFLOW_CAP))
    assert want > 0
    assert int(ranks[0]["overflow/overflow"]) == want


@pytest.mark.parametrize("case", list(td.STREAM_CASES))
def test_mesh_stream_equals_one_rank(ranks, case):
    alone = td.stream(case, "cpu")
    assert (alone[1] >= 0).any()
    for k in (1, 2):
        got = _get(ranks[0], f"stream/{case}/{k}")
        for name, want in zip(("depth", "index", "attrs"), alone):
            np.testing.assert_array_equal(_bits(got[name]),
                                          _bits(want.numpy()),
                                          err_msg=f"{name} at {k} ranks")
    if case == "scene_pallas6":
        # The ground (ids 0-3) wins from the first chunk only.
        idx = ranks[0][f"stream/{case}/2/index"]
        assert ((idx >= 0) & (idx < 4)).any()


def test_mesh_stream_errors(ranks):
    for res in ranks[:2]:
        assert str(res["errors/stream_chunk_points"]) == \
            f"chunk_points {td.STREAM_CHUNK - 1} not divisible by 2 devices"
        assert "needs the soup's part layout" in \
            str(res["errors/stream_no_layout"])


def _jax_mesh():
    return jrp.make_render_mesh(1, td.WORLD)


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_point_sharded_matches_jax(ranks):
    pos, radii, colors = td.disc_inputs()
    cfg = JRasterConfig(backend="tiled", max_per_tile=256)
    cam = jcam(td.W, td.H)
    rgb, depth, index, overflow = jax.jit(
        lambda p, r, c: jrp.render_point_sharded(p, r, c, cam, cfg,
                                                 _jax_mesh()))(
        pos, radii, colors)
    got = _get(ranks[0], f"disc/{td.WORLD}")
    assert int(overflow) == int(got["overflow"]) == 0
    np.testing.assert_array_equal(got["index"], np.asarray(index))
    hit = got["index"] >= 0
    assert _ulp(got["depth"], np.asarray(depth))[hit].max() <= DEPTH_ULP
    assert np.abs(got["rgb"] - np.asarray(rgb)).max() <= RGB_ATOL


def test_scene_point_sharded_matches_jax(ranks):
    s = td.scene("traj_ball")
    pcl = s["pcl"]
    out = jax.jit(lambda p, v: jrp.render_scene_point_sharded(
        JAX_PRESETS["traj_ball"], p, JRasterConfig(backend="tiled"),
        _jax_mesh(), velocities=v, frame_index=s["frame"], width=td.W,
        height=td.H))(jnp.asarray(pcl[:, :3]), jnp.asarray(pcl[:, 3:]))
    got = _get(ranks[0], f"scene/traj_ball/tiled/{td.WORLD}")
    assert int(out.overflow) == int(got["overflow"]) == 0
    np.testing.assert_array_equal(got["index"], np.asarray(out.index))
    hit = got["index"] >= 0
    assert _ulp(got["depth"], np.asarray(out.depth))[hit].max() <= DEPTH_ULP
    assert np.abs(got["rgb"] - np.asarray(out.rgb)).max() <= RGB_ATOL
