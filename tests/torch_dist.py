"""The rank side of ``tests/test_torch_parallel.py``: one gloo world of
CPU ranks runs every sharded case of the port's ``parallel`` package and
writes each rank's results to ``rank{r}.npz``; the test process holds
them against the single-device renders and the JAX package.  Holds no
tests and imports no jax (the ranks are spawned, not forked, from a
process that holds JAX threads).

Seeded inputs (``scene``, ``disc_inputs``, ``stream_chunks``) are shared
with the test process, so both sides render the same arrays.
"""

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.parallel import multihost
from pointcloud_render_tpu_torch.parallel import render_parallel as rp
from pointcloud_render_tpu_torch.parallel.streaming import StreamingRasterizer
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.run import pipeline
from tests.torch_soups import cloud, tcam, trail_soup_fn

W, H = 160, 96
WORLD = 4
SCENES = ("traj_ball", "traj", "traj_vel", "mesh")
BACKENDS = ("tiled", "pallas6", "pallas4")
# The sharded frames at 1 and 2 ranks besides 4: traj_ball under these.
FEW_RANKS_BACKENDS = ("tiled", "pallas6")
BATCH_FRAMES = (10, 120)
DP_FRAMES = (10, 60, 120, 205)
OVERFLOW_CAP = 8  # max_per_tile small enough to drop entries
STREAM_CHUNK = 64


def scene(name):
    """-> dict(preset, pcl (N, 6), history (T, N, 3) or None, frame,
    droplet_lod) of a seeded scene: traj_ball (velocity trails), traj
    (droplets, history trails), traj_vel (capsule-LOD droplets) and mesh
    (mesh-LOD droplets: the split2 layout)."""
    n = 8 if name == "mesh" else 160
    pos, vel = cloud(n, seed=3)
    history = None
    if name == "traj":
        history = np.stack([pos - vel * np.float32(0.002 * (6 - k))
                            for k in range(6)]).astype(np.float32)
    preset = PRESETS["traj_vel" if name == "mesh" else name]
    return dict(preset=preset, pcl=np.concatenate([pos, vel], axis=1),
                history=history, frame=23 if name == "traj" else 120,
                droplet_lod="mesh" if name == "mesh" else "capsule")


def scene_config(name, backend, **kw):
    """The scene's RasterConfig under ``backend``: the mesh-LOD scene bins
    its triangles on the v6 and v4 walks (as ``FramePipeline`` does under
    ``auto``) and takes a tile table that drops none of them under the
    capped ``tiled`` walk."""
    if name == "mesh" and backend == "tiled":
        kw.update(max_per_tile=4096)
    elif name == "mesh":
        kw.update(bin_triangles=True)
    return RasterConfig(backend=backend, **kw)


def disc_inputs():
    """(positions (N, 3), radii (N,), colors (N, 3)) of the disc frame."""
    rng = np.random.default_rng(11)
    n = 400
    return (rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
            np.full(n, 0.03, np.float32),
            rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))


def disc_config():
    return RasterConfig(backend="tiled", max_per_tile=256)


def stream_chunks(kind):
    """The host chunks of a stream case: "trail" (positions, colours,
    velocities; three chunks, the last short), "scene" (traj_ball soups
    with the ground; two chunks), "disc" (bare positions; three)."""
    rng = np.random.default_rng(19)
    n = 3 * STREAM_CHUNK - 24 if kind != "scene" else 2 * STREAM_CHUNK
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    col = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    cut = range(0, n, STREAM_CHUNK)
    if kind == "disc":
        return [pos[k:k + STREAM_CHUNK] for k in cut]
    return [(pos[k:k + STREAM_CHUNK], col[k:k + STREAM_CHUNK],
             vel[k:k + STREAM_CHUNK]) for k in cut]


STREAM_CASES = {
    # name: (chunks, backend, soup kind)
    "trail_pallas6": ("trail", "pallas6", "trail"),
    "scene_pallas6": ("scene", "pallas6", "scene"),
    "disc_tiled": ("disc", "tiled", None),
    "disc_pallas": ("disc", "pallas", None),
}


def stream(case, device, mesh=None):
    """-> (depth, index, attrs) of a stream case on ``device``."""
    kind, backend, soup = STREAM_CASES[case]
    cam = tcam(W, H, device=device)
    kw = dict(chunk_points=STREAM_CHUNK, radius_world=0.02, backend=backend,
              max_big=4096, device=device, mesh=mesh)
    if soup == "trail":
        kw["soup_fn"] = trail_soup_fn(cam, 0.01)
    elif soup == "scene":
        preset = PRESETS["traj_ball"]

        def scene_soup(pos, colors, vel):
            return pipeline.build_primitives(preset, cam, pos, vel, 120,
                                             return_layout=True)
        kw["soup_fn"] = scene_soup
    return StreamingRasterizer(cam, **kw).rasterize(
        stream_chunks(kind), return_attrs=True)


def _frame(out):
    return {f.name: getattr(out, f.name).numpy()
            for f in dataclasses.fields(out)}


def _error(fn):
    """The ValueError text ``fn()`` raises ('' if it returns)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _run(rank, out):
    res = {}

    def put(prefix, arrays):
        for k, v in arrays.items():
            res[f"{prefix}/{k}"] = np.asarray(v)

    multihost.initialize()  # a no-op: the world exists
    put("world", dict(size=dist.get_world_size(), rank=dist.get_rank()))
    meshes = {k: rp.make_render_mesh(1, k, device_type="cpu")
              for k in (1, 2, 4)}
    m22 = rp.make_render_mesh(2, 2, device_type="cpu")
    m41 = rp.make_render_mesh(4, 1, device_type="cpu")
    res["errors/mesh_too_big"] = _error(
        lambda: rp.make_render_mesh(2, 4, device_type="cpu"))
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    pod = multihost.make_pod_mesh(device_type="cpu")
    put("pod", dict(
        shape=tuple(pod.shape),
        points=dist.get_process_group_ranks(pod.get_group("points")),
        frames=dist.get_process_group_ranks(pod.get_group("frames"))))
    res["errors/pod_points_3"] = _error(
        lambda: multihost.make_pod_mesh(3, device_type="cpu"))
    del os.environ["LOCAL_WORLD_SIZE"]

    cam = tcam(W, H)
    pos, radii, colors = disc_inputs()
    for k, mesh in meshes.items():
        if rank < k:
            put(f"disc/{k}", dict(zip(
                ("rgb", "depth", "index", "overflow"),
                rp.render_point_sharded(pos, radii, colors, cam,
                                        disc_config(), mesh))))
    batch = rp.render_batch_sharded(
        np.stack([pos, pos[::-1]]), np.stack([radii, radii]),
        np.stack([colors, colors[::-1]]), cam, disc_config(), m22)
    put("disc_batch", dict(zip(("rgb", "depth", "index", "overflow"),
                               batch)))

    def scene_frame(name, config, mesh):
        s = scene(name)
        return rp.render_scene_point_sharded(
            s["preset"], s["pcl"][:, :3], config, mesh,
            velocities=s["pcl"][:, 3:], frame_index=s["frame"],
            history=s["history"], width=W, height=H,
            droplet_lod=s["droplet_lod"])

    for name in SCENES:
        for b in BACKENDS:
            put(f"scene/{name}/{b}/4",
                _frame(scene_frame(name, scene_config(name, b), meshes[4])))
    for k in (1, 2):
        for b in FEW_RANKS_BACKENDS:
            if rank < k:
                put(f"scene/traj_ball/{b}/{k}", _frame(scene_frame(
                    "traj_ball", RasterConfig(backend=b), meshes[k])))
    put("rows9", _frame(scene_frame(
        "traj_ball", RasterConfig(backend="pallas6", rows9=True),
        meshes[4])))
    put("overflow", _frame(scene_frame(
        "traj_ball", RasterConfig(backend="tiled",
                                  max_per_tile=OVERFLOW_CAP), meshes[4])))

    s = scene("traj_ball")
    pcl = s["pcl"]
    two = np.stack([pcl, pcl[::-1]])
    put("batch", _frame(rp.render_scene_batch_sharded(
        s["preset"], two[..., :3], two[..., 3:], BATCH_FRAMES,
        RasterConfig(backend="tiled"), m22, width=W, height=H)))
    for j, fi in enumerate(BATCH_FRAMES):
        put(f"batch_ref/{j}", _frame(rp.render_scene_point_sharded(
            s["preset"], two[j, :, :3], RasterConfig(backend="tiled"), m22,
            velocities=two[j, :, 3:], frame_index=fi, width=W, height=H)))

    pipe = pipeline.FramePipeline(s["preset"], RasterConfig(backend="tiled"),
                                  width=W, height=H, device="cpu")
    put("dp", _frame(rp.render_frames_dp(
        lambda p, fi: pipe.render_array(p, int(fi)),
        (np.stack([pcl] * len(DP_FRAMES)), np.asarray(DP_FRAMES)), m41)))

    if rank < 2:
        for case in STREAM_CASES:
            for k in (1, 2):
                if rank < k:
                    put(f"stream/{case}/{k}", dict(zip(
                        ("depth", "index", "attrs"),
                        stream(case, "cpu", meshes[k]))))
        res["errors/stream_chunk_points"] = _error(
            lambda: StreamingRasterizer(cam, chunk_points=STREAM_CHUNK - 1,
                                        radius_world=0.02, device="cpu",
                                        mesh=meshes[2]))
        res["errors/stream_no_layout"] = _error(
            lambda: StreamingRasterizer(
                cam, chunk_points=STREAM_CHUNK, radius_world=0.02,
                device="cpu", mesh=meshes[2],
                soup_fn=lambda p, c, v: trail_soup_fn(cam, 0.01)(p, c, v)[0]
            ).rasterize(stream_chunks("trail")))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def run_rank(rank, port, out):
    """One rank of the world: its process group through
    ``multihost.initialize``, then every case."""
    torch.set_num_threads(1)
    try:
        multihost.initialize(f"127.0.0.1:{port}", WORLD, rank,
                             device_type="cpu")
        _run(rank, out)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
