"""Small host constants as device tensors, uploaded once.

PyTorch's copy of pageable host memory to a CUDA device waits for the
stream (``cudaMemcpyAsync`` followed by ``cudaStreamSynchronize``), so a
frame loop that uploads a small constant per call (a color, a light
direction, a divisor) runs in lock-step with the device.  ``const`` keeps
each (value, dtype, device) on its device after the first upload; the
frame loop then queues work without waiting.  The tensors are shared:
callers must not write into them.

The cache hashes the value's bytes on every call and pins one device copy
per distinct value, so it is for fixed constants of a few elements only.
Data (a mesh, a cloud, an image-sized array) is uploaded once by its
owner instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def device_key(device) -> torch.device:
    """``device`` with its index spelled out ("cuda" -> the current
    card), so that two spellings of one device share their tensors and a
    cached tensor stays on the card it was asked for."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=256)
def _upload(data: bytes, dtype: str, shape: tuple,
            device: torch.device) -> torch.Tensor:
    host = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()
    return torch.as_tensor(host, device=device)


def const(value, dtype, device) -> torch.Tensor:
    """``value`` (a scalar or a short sequence) as a ``dtype`` tensor on
    ``device``; equal values share one tensor per device."""
    arr = np.asarray(value, dtype)
    return _upload(arr.tobytes(), arr.dtype.str, arr.shape,
                   device_key(device))


def as_f32(value, device) -> torch.Tensor:
    """float32 on ``device``: a tensor as it is (a frame index already on
    the device costs no upload), a host value through the constant
    cache."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return const(value, np.float32, device)
