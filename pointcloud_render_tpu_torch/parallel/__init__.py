"""Rendering beyond one frame's soup on one device: the sharded renders
over a ``torch.distributed`` device mesh (``render_parallel``, with
``multihost`` for the process group and the pod mesh) and the chunked
stream (``streaming.StreamingRasterizer``)."""

from pointcloud_render_tpu_torch.parallel.render_parallel import (  # noqa: F401
    make_render_mesh,
    render_frames_dp,
    render_point_sharded,
)
