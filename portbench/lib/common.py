"""Small pieces the entries share: seeds, timing by CUDA events, frame
comparison."""

from __future__ import annotations

import numpy as np


def seed_u64(seed: int) -> int:
    """Any whole number as a 64-bit unsigned seed."""
    return int(seed) % (1 << 64)


def event_ms(fn, reps: int, device) -> list:
    """Milliseconds of ``reps`` calls of ``fn``, each between two CUDA
    events on the current stream, after one warm call; on the CPU the
    host's clock (for the tests)."""
    import time

    import torch

    fn()
    if device.type != "cuda":
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in marks:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in marks]


def mismatched_pixels(got: np.ndarray, want: np.ndarray) -> int:
    """Pixels whose uint8 RGB differs in any channel."""
    if got.shape != want.shape:
        return int(np.prod(want.shape[:-1]))
    return int(np.any(got != want, axis=-1).sum())
