"""Unified CLI: render a preset with overridable folders/frames/backend.

Usage:
  python -m pointcloud_render_tpu_torch.cli.main --preset traj_ball \
      [--input-folder trajectory_ply] [--output-folder render] \
      [--frames 0:220] [--backend auto] [--droplet-lod capsule|mesh] \
      [--device cuda] [--no-resume] [--metrics-jsonl path] \
      [--supersample 2] [--shadows] [--ground-spec 0.5] [--gi 0.25]

The PyTorch twin of ``pointcloud_render_tpu.cli.main``.  ``--device``
defaults to ``cuda`` and never falls back to the CPU; ``--device cpu``
runs the plain PyTorch rasterizer.  ``--droplet-lod mesh`` renders the
droplets as the instanced teardrop mesh (binned triangles);
``--backend pallas4`` takes the v4 walk with its z-bucket early exit,
``--backend pallas3`` the v3 disc fast path (binned discs, every other
prim on its big list), ``--backend pallas`` the v2 strip-tile walk (its
big list fixed at 1024 prims, as in the JAX package: a frame that needs
more fails after the pipeline's retries), and ``cpu``/``tiled``/
``bruteforce`` the plain exact rasterizer.  The look passes:
``--supersample`` renders at that multiple of the film and filters the
rgb down, ``--shadows`` darkens the diffuse term under a shadow map
rasterized from the emitter (the ``csr1_raster`` kernel over the JAX
package's capped strips), ``--ground-spec`` adds the ground's GGX lobe
and ``--gi`` the ground-bounce fill; depth and index never change.  The
per-script entry points (``cli.traj_ball_renderer``,
``cli.traj_vel_renderer``, ``cli.traj_renderer``, ``cli.traj_b0``,
``cli.traj_b1``, ``cli.traj_original``, ``cli.example_renderer``) are thin
wrappers with the reference's defaults.
"""

from __future__ import annotations

import argparse

from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.run.batch import run_batch
from pointcloud_render_tpu_torch.run.metrics import MetricsSink
from pointcloud_render_tpu_torch.run.pipeline import FramePipeline
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig


def parse_frames(spec: str, default):
    """'': the preset's frames; 'lo:hi' a range with either bound
    optional ('100:' = from 100 to the preset's last frame); 'a,b,c'
    an explicit list."""
    if not spec:
        return default
    if ":" in spec:
        lo, hi = spec.split(":")
        end = int(hi) if hi else max(default) + 1
        return range(int(lo or 0), end)
    return [int(x) for x in spec.split(",")]


def build_parser(preset_name=None):
    p = argparse.ArgumentParser(description=__doc__)
    if preset_name is None:
        p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--input-folder", default=None)
    p.add_argument("--output-folder", default=None)
    p.add_argument("--frames", default="")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "bruteforce", "tiled", "pallas",
                            "pallas3", "pallas4", "pallas6", "cpu"])
    p.add_argument("--droplet-lod", default="capsule",
                   choices=["capsule", "mesh"])
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--write-depth", action="store_true",
                   help="also save per-frame depth buffers as .npy")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--supersample", type=int, default=1,
                   help="rfilter AA factor (1 = bit-exact single sample)")
    p.add_argument("--shadows", action="store_true",
                   help="shadow-map look pass (shading/shadow.py): "
                        "PCSS penumbra approximating the reference's "
                        "8x8 area-emitter shadows")
    p.add_argument("--ground-spec", type=float, default=0.0,
                   help="GGX specular strength on triangle winners "
                        "(the reference's roughplastic ground, "
                        "alpha=0.1 IOR 1.46; 0 = pure Lambert)")
    p.add_argument("--gi", type=float, default=0.0,
                   help="ground-bounce fill on splat undersides, "
                        "approximating the reference's path-traced "
                        "indirect light (0 = off, bit-pinned look; "
                        "try 0.25)")
    return p


def raster_config(args) -> RasterConfig:
    """The render config of parsed arguments (the JAX ``run``'s)."""
    return RasterConfig(
        backend=args.backend, supersample=args.supersample,
        shading=ShadingConfig(shadows=bool(args.shadows),
                              ground_spec=float(args.ground_spec),
                              gi=float(args.gi)))


def run(args, preset_name=None) -> MetricsSink:
    preset = PRESETS[preset_name or args.preset]
    pipeline = FramePipeline(
        preset,
        raster_config=raster_config(args),
        droplet_lod=args.droplet_lod, width=args.width, height=args.height,
        device=args.device,
    )
    sink = MetricsSink(jsonl_path=args.metrics_jsonl)
    run_batch(
        preset,
        input_folder=args.input_folder,
        output_folder=args.output_folder,
        frames=parse_frames(args.frames, preset.frames),
        pipeline=pipeline,
        resume=not args.no_resume,
        sink=sink,
        write_depth=args.write_depth,
    )
    return sink


def main(argv=None, preset_name=None) -> MetricsSink:
    """Parse ``argv`` and render; returns the metrics sink (one record
    per attempted frame, ``status`` "ok" or "error")."""
    args = build_parser(preset_name).parse_args(argv)
    return run(args, preset_name)


if __name__ == "__main__":
    main()
