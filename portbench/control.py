"""The control of a cell's comparison: the plain reference put in the
program's place, its soups stored in bfloat16 (the nearest precision
below the float32 that the configurations state), judged by the cell's
own comparison.  It has to come out as not correct on every seed:

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed: the control's px_mismatch beside the
cell's limit.  The benchmark's own runs do not run it.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds, root: str = ROOT, device: str = "cuda"):
    """[(seed, px_mismatch, limit)] of the control on ``seeds``."""
    import torch

    from portbench import harness

    bench = harness.read_json(os.path.join(root, "BENCHMARK.json"))
    _, wl, config, entry = harness.load_cell(root, bench, workload)
    out = []
    for seed in seeds:
        ctx = harness.Context(seed, torch.device(device), config, wl)
        out.append((seed, entry.control(ctx, torch.bfloat16),
                    wl["limits"]["px_mismatch"]))
    return out


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    for seed, value, limit in readings(args.workload, args.seeds):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_px_mismatch": value, "limit": limit,
                          "fails": value > limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
