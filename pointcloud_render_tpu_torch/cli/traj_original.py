"""Entry point mirroring the reference script traj_original.py (preset: traj_original).

Same input/output folder conventions and frame schedule as the reference;
all knobs overridable via the unified CLI flags (cli.main), including
``--device`` (default cuda).
"""

from pointcloud_render_tpu_torch.cli import main as _main


def main(argv=None):
    """Render the traj_original preset; returns the metrics sink."""
    return _main.main(argv, preset_name="traj_original")


if __name__ == "__main__":
    main()
