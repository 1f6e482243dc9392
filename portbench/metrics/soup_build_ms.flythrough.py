"""Mean milliseconds of the program's soup build (``build_primitives``
and the frame's camera) at the checked frames, between CUDA events,
called outside the scan."""

import statistics


def read(record):
    spans = record.get("spans", {}).get("soup_build_ms")
    return statistics.fmean(spans) if spans else None
