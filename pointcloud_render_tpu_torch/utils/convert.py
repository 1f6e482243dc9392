"""Convert the JAX package's state into the port's types.

The inputs are read as plain attributes and NumPy arrays (``np.asarray``
of each field), so this module imports no jax: a JAX ``ScreenPrimitives``,
``ScenePreset``, ``RasterConfig`` or ``ShadingConfig`` — or any object
with the same field names — converts to its counterpart here.  The tests
use it to give both packages the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pointcloud_render_tpu_torch.configs import ScenePreset
from pointcloud_render_tpu_torch.raster.primitives import ScreenPrimitives
from pointcloud_render_tpu_torch.raster.render import RasterConfig
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig

_SOUP_DTYPES = dict(kind=np.int32, params=np.float32, color=np.float32,
                    valid=np.bool_, bbox=np.float32, normal=np.float32)


def soup_from_fields(soup, device=None) -> ScreenPrimitives:
    """A ScreenPrimitives soup from an object with kind/params/color/
    valid/bbox/normal array fields (bit-for-bit copies)."""
    return ScreenPrimitives(**{
        name: torch.as_tensor(np.array(getattr(soup, name), dtype=dt),
                              device=device)
        for name, dt in _SOUP_DTYPES.items()})


def soup_to_numpy(soup: ScreenPrimitives) -> dict:
    """The port's soup as a dict of NumPy arrays (field name -> array)."""
    return {f.name: getattr(soup, f.name).cpu().numpy()
            for f in dataclasses.fields(ScreenPrimitives)}


def _copy_fields(cls, obj, **override):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if hasattr(obj, f.name)}
    kw.update(override)
    return cls(**kw)


def preset_from_fields(preset) -> ScenePreset:
    """A ScenePreset with the same field values."""
    return _copy_fields(ScenePreset, preset)


def shading_from_fields(shading) -> ShadingConfig:
    """A ShadingConfig with the same field values."""
    return _copy_fields(ShadingConfig, shading)


def raster_config_from_fields(config) -> RasterConfig:
    """A RasterConfig with the same field values (shading converted; the
    ``uniform_look`` tones as plain float tuples, the ``three_tone`` prim
    ids and a finite ``entry_capacity`` as plain ints and
    ``bin_triangles`` as a bool, so the config hashes)."""
    look = config.uniform_look
    if look is not None:
        look = tuple(tuple(float(c) for c in tone) for tone in look)
    tones = config.three_tone
    if tones is not None:
        tones = tuple(int(r) for r in np.asarray(tones).reshape(-1))
    cap = config.entry_capacity
    return _copy_fields(RasterConfig, config, uniform_look=look,
                        three_tone=tones,
                        entry_capacity=None if cap is None else int(cap),
                        bin_triangles=bool(config.bin_triangles),
                        shading=shading_from_fields(config.shading))
