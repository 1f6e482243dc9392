"""Entry point mirroring the reference script traj_renderer.py (preset: traj).

Droplets (capsule LOD by default, oriented by the velocities, or by the
reference's seeded random rotations when a frame has none) with
Catmull-Rom history-fit trails through the last 20 frames, preloaded by
the batch runner.  Same input/output folder conventions and frame
schedule as the reference; all knobs overridable via the unified CLI
flags (cli.main), including ``--device`` (default cuda) and
``--backend``.
"""

from pointcloud_render_tpu_torch.cli import main as _main


def main(argv=None):
    """Render the traj preset; returns the metrics sink."""
    return _main.main(argv, preset_name="traj")


if __name__ == "__main__":
    main()
