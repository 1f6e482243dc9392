"""Entry point mirroring the reference script traj_vel_renderer.py (preset: traj_vel).

Droplets (capsule LOD: a head disc and a tapered tail capsule, oriented
by the velocities) with velocity trails.  Same input/output folder
conventions and frame schedule as the reference; all knobs overridable
via the unified CLI flags (cli.main), including ``--device`` (default
cuda) and ``--droplet-lod``.
"""

from pointcloud_render_tpu_torch.cli import main as _main


def main(argv=None):
    """Render the traj_vel preset; returns the metrics sink."""
    return _main.main(argv, preset_name="traj_vel")


if __name__ == "__main__":
    main()
