"""The device's idle share of a whole flythrough call: 1 - busy / call,
busy the union of the device's kernel, copy and memset intervals in the
traced call, the call the median of the window's untraced calls of the
same work.  The traced call's own window is longer by the profiler's
cost, which is the host's and not the program's."""

import statistics


def read(record):
    prof, calls = record.get("profile"), record.get("window_calls_s")
    if prof is None or not calls or prof["busy_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / statistics.median(calls)
