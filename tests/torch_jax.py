"""Bridges between the port's inputs and the JAX package's, shared by the
CPU tests that hold one against the other (``tests/test_torch_*.py``).
Holds no tests.  Imports jax: the card-only tests do not use it.
"""

import types

import jax.numpy as jnp
import pytest
import torch

from pointcloud_render_tpu.raster.primitives import (
    ScreenPrimitives as JScreenPrimitives,
)
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_soups import H, ORIGIN, TARGET, W


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Small torch ops interleaved with Python loops (the NumPy oracle,
    op-by-op JAX): one intra-op thread keeps idle torch threads from
    spinning on cores that the suite's other workers need.  A test module
    turns it on by importing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jcam(w=W, h=H):
    """The JAX twin of ``torch_soups.tcam``."""
    return JCamera(origin=jnp.array(ORIGIN, jnp.float32),
                   target=jnp.array(TARGET, jnp.float32), width=w, height=h)


def numpy_soup(soup):
    """The port's soup as a namespace of NumPy arrays (the oracle's input)."""
    return types.SimpleNamespace(**convert.soup_to_numpy(soup))


def jax_soup(soup):
    """The port's soup as the JAX package's ScreenPrimitives."""
    return JScreenPrimitives(**{k: jnp.asarray(v) for k, v in
                                convert.soup_to_numpy(soup).items()})
