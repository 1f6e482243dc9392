"""The rooflines' yardstick: the least time a tile walk could take for
the pairs and bytes the plain reference counted in the same frames,
over the walk's device time in the traced run.

Operations: the (primitive, pixel) pairs the exact coverage test
accepts, times the float32 operations of one pair test
(``reference.raster.OPS_PER_PAIR``).  Bytes: each drawn primitive's
fields that the test reads, read once, and the depth and id of every
pixel of every image the walk writes, written once.  The least time is
the larger of operations over the card's float32 peak and bytes over its
memory bandwidth (``lib/peaks.json``).  A better binning or walk lowers
the time and not the count.  The walk's time is that of its launches:
the plan, the walk and the merge of one call of the C entry, matched by
kernel name in the trace, one call per traced frame.
"""

from __future__ import annotations

import json
import os
import re

from portbench.reference.raster import FIELDS_READ, OPS_PER_PAIR

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lib", "peaks.json")
PLAN = re.compile(r"split_plan_kernel<\s*TileRows\s*>")
MERGE = re.compile(r"csr6_merge_kernel<\s*false\s*>")


def walk_pattern(mode: int, name: str):
    """The name of ``csr6_walk_kernel`` at one RowMode (``name`` its
    enumerator), as the trace spells a template argument."""
    return re.compile(r"csr6_walk_kernel<\s*(?:\(RowMode\)\s*)?(?:%d|%s)\s*>"
                      % (mode, name))


def peaks(kind: str):
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def calls(device_spans, walk) -> list:
    """Device seconds of each call of one walk: the walk's launch, the
    plan launched last before it and the merge launched next after it."""
    out, plan, pending = [], None, None
    for a, b, name in device_spans:
        if PLAN.search(name):
            plan = (b - a)
        elif walk.search(name):
            pending = len(out)
            out.append((b - a) + (plan or 0.0))
            plan = None
        elif pending is not None and MERGE.search(name):
            out[pending] += (b - a)
            pending = None
    return [t * 1e-6 for t in out]


def least_seconds(ref: dict, pk: dict) -> float:
    ops = sum(n * OPS_PER_PAIR[k] for k, n in ref["accepted"].items())
    nbytes = sum(n * FIELDS_READ[k] * 4 for k, n in ref["prims"].items())
    nbytes += ref["images"] * ref["pixels"] * 8
    return max(ops / pk["fp32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])


def share(record: dict, kernel: str, walk) -> float | None:
    """Percent of the walk's roofline in the counted calls, or None where
    the run has nothing to read."""
    prof, ref = record.get("profile"), record.get("reference")
    counted = record.get("roofline_calls", {}).get(kernel)
    pk = peaks(record.get("device_kind", ""))
    if prof is None or ref is None or counted is None or pk is None:
        return None
    times = calls(prof["device"], walk)
    if len(times) != record.get("units") or not times:
        return None
    seconds = sum(times[i] for i in counted)
    return 100.0 * least_seconds(ref, pk) / seconds if seconds > 0 else None
