from pointcloud_render_tpu_torch.scene.camera import (  # noqa: F401
    Camera,
    camera_origin,
    camera_origin_torch,
    look_at_axes,
)
from pointcloud_render_tpu_torch.scene.pointcloud import PointCloud  # noqa: F401
from pointcloud_render_tpu_torch.scene.normalize import (  # noqa: F401
    standardize_point_cloud,
    transform_coordinates,
)
