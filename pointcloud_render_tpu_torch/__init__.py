"""pointcloud_render_tpu_torch — the point-cloud renderer in PyTorch and CUDA.

The port of ``pointcloud_render_tpu`` (JAX, Pallas on a TPU) to PyTorch on
an NVIDIA Hopper GPU.  The host state layer (loaders, normalization,
camera schedules, presets) is a NumPy copy of the JAX package's; the
device side is float32 torch ops around hand-written CUDA kernels under
``csrc/`` (built with nvcc at first use, see ``utils/kernels.py``).  The
JAX package stays the reference the port is tested against; this package
never imports jax.

Public names here: ``PointCloud`` (``scene/pointcloud.py``) and
``Camera`` (``scene/camera.py``), as the JAX package exports them.
"""

__version__ = "0.1.0"

from pointcloud_render_tpu_torch.scene.pointcloud import PointCloud  # noqa: F401,E402
from pointcloud_render_tpu_torch.scene.camera import Camera  # noqa: F401,E402
