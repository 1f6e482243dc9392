"""Multi-host setup on ``torch.distributed`` (the PyTorch twin of
``pointcloud_render_tpu.parallel.multihost``).

One process per rank.  The process group must exist before a mesh is
made; the mesh puts the FRAMES axis across hosts (frames are
embarrassingly parallel: only PNG paths leave each host) and the POINTS
axis within a host, so that the z-merge's all-reduces stay on the host's
NVLink.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pointcloud_render_tpu_torch.parallel.render_parallel import AXES

_AVAILABLE = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available,
              "mpi": dist.is_mpi_available}


def backend_for(device_type: str, backend: Optional[str] = None) -> str:
    """``backend``, else NCCL for ``"cuda"`` and gloo for ``"cpu"``;
    raises (RuntimeError) where this torch build lacks it."""
    name = backend or ("nccl" if device_type == "cuda" else "gloo")
    if name not in _AVAILABLE or not _AVAILABLE[name]():
        raise RuntimeError(f"torch.distributed backend {name!r} is not "
                           "available in this torch build")
    return name


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """Initialize the default process group (a no-op if one exists).

    The arguments default to the launcher's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator, ``host:port``), ``WORLD_SIZE`` and
    ``RANK``.  A single process with no coordinator gets a world of one
    rank on a ``HashStore`` (the JAX package's single-process run: callers
    proceed with one rank).  The backend is :func:`backend_for`'s; on
    CUDA the process takes card ``LOCAL_RANK`` modulo the cards present
    (ranks sharing one card all take it)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    name = backend_for(device_type, backend)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if coordinator_address is None and num_processes in (None, 1):
        dist.init_process_group(name, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("a world of several processes needs the "
                         "coordinator address, the process count and this "
                         "process's id")
    dist.init_process_group(name, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)


def make_pod_mesh(points_per_host_axis: Optional[int] = None,
                  device_type: str = "cuda") -> DeviceMesh:
    """``("frames", "points")`` mesh with ``"points"`` confined to each
    host.  Ranks are laid out host-major (as launchers number them), so
    taking ``points`` consecutive ranks per frames-row, with ``points``
    dividing the host's rank count (``LOCAL_WORLD_SIZE``, else the world),
    keeps every ``"points"`` collective on one host."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    points_axis = points_per_host_axis or per_host
    if per_host % points_axis or world % points_axis:
        raise ValueError(
            f"points axis {points_axis} must divide local devices {per_host}")
    grid = torch.arange(world, dtype=torch.int32).reshape(
        world // points_axis, points_axis)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)
