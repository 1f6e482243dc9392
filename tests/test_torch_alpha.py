"""Alpha compositing of the port (``raster/alpha.py``, weighted-blended OIT
splats, BASELINE config 3) and ``raster/coverage.py``, held against the
JAX package on the CPU.

* ``pixel_centers`` equal to the JAX grids; ``eval_coverage_depth`` on
  discs, capsules and triangles against the jitted JAX function: the same
  coverage, depth within COVERAGE_ULP (XLA contracts the edge functions'
  and the capsule's multiply-adds; ROADMAP queue C).
* ``splat_gaussians`` within SPLAT_REL of the jitted JAX splats (valid,
  color and alpha equal); ``composite_bruteforce`` and
  ``composite_tiled`` on the port's splats within ALPHA_ATOL of the JAX
  functions on the same splats (sums in another order), tiled within
  ALPHA_ATOL of bruteforce.
* The gradient of a weighted image sum with respect to the positions
  within GRAD_RTOL of ``jax.grad``'s (relative to its largest component).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointcloud_render_tpu.raster import alpha as jalpha
from pointcloud_render_tpu.raster import coverage as jcoverage
from pointcloud_render_tpu_torch.raster import alpha, coverage
from tests.torch_jax import jcam
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import H, W, mixed_soup, tcam

# Coverage depth against the jitted JAX evaluator (measured: 4 ulp).
COVERAGE_ULP = 4
# The splats against the jitted JAX projection (as the soup's columns in
# test_torch_pipeline; measured: 1 ulp, 6.3e-8 of the column's largest).
SPLAT_REL = 2e-6
# Sums of weights in another order than XLA's (the JAX package's own
# tiled-vs-bruteforce bound is 2e-5; measured here: below 1e-6).
ALPHA_ATOL = 1e-5
# The gradient against jax.grad, as a share of its largest component.
GRAD_RTOL = 1e-4
BACKGROUND = (0.2, 0.3, 0.4)


def _splat_inputs(n, seed, radius):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    col = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    alphas = rng.uniform(0.2, 0.9, n).astype(np.float32)
    return pos, np.full(n, radius, np.float32), col, alphas


_jax_splats = jax.jit(lambda p, r, c, a: jalpha.splat_gaussians(
    p, jcam(), r, c, a))


def test_coverage_matches_jax():
    soup = mixed_soup(tcam(), n=40, trails=6, seed=3)
    qx, qy = coverage.pixel_centers(H, W, y0=2, x0=5)
    jqx, jqy = jcoverage.pixel_centers(H, W, y0=2, x0=5)
    np.testing.assert_array_equal(qx.numpy(), jqx)
    np.testing.assert_array_equal(qy.numpy(), jqy)
    cov, depth = coverage.eval_coverage_depth(soup.kind, soup.params, qx, qy)
    jcov, jdepth = jax.jit(jcoverage.eval_coverage_depth)(
        jnp.asarray(soup.kind.numpy()), jnp.asarray(soup.params.numpy()),
        jqx, jqy)
    cov = cov.numpy()
    np.testing.assert_array_equal(cov, np.asarray(jcov))
    assert cov.sum() > 1000
    ulp = np.abs(depth.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jdepth).view(np.int32))
    assert ulp[cov].max() <= COVERAGE_ULP


def test_composites_match_jax():
    pos, radii, col, alphas = _splat_inputs(400, 2, 0.04)
    ours = alpha.splat_gaussians(torch.tensor(pos), tcam(),
                                 torch.tensor(radii), col, alphas)
    jitted = _jax_splats(pos, radii, col, alphas)
    for name in ours:
        a, b = ours[name].numpy(), np.asarray(jitted[name])
        if a.dtype == np.float32:
            assert np.abs(a - b).max() <= SPLAT_REL * np.abs(a).max(), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # Both composites take the port's splats.
    theirs = {k: jnp.asarray(v.numpy()) for k, v in ours.items()}
    brute = alpha.composite_bruteforce(ours, W, H, background=BACKGROUND)
    np.testing.assert_allclose(brute.numpy(), np.asarray(
        jalpha.composite_bruteforce(theirs, W, H, background=BACKGROUND)),
        rtol=0, atol=ALPHA_ATOL)
    assert float((brute - torch.tensor(BACKGROUND)).abs().max()) > 0.1
    tiled = alpha.composite_tiled(ours, W, H, background=BACKGROUND)
    jtiled = jax.jit(lambda s: jalpha.composite_tiled(
        s, W, H, background=BACKGROUND))(theirs)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(jtiled), rtol=0,
                               atol=ALPHA_ATOL)
    np.testing.assert_allclose(tiled.numpy(), brute.numpy(), rtol=0,
                               atol=ALPHA_ATOL)


def test_gradient_to_positions_matches_jax_grad():
    pos, radii, col, alphas = _splat_inputs(50, 5, 0.05)
    rng = np.random.default_rng(6)
    weights = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)

    p = torch.tensor(pos, requires_grad=True)
    img = alpha.composite_bruteforce(
        alpha.splat_gaussians(p, tcam(), torch.tensor(radii), col, alphas),
        W, H, background=BACKGROUND)
    (img * torch.tensor(weights)).sum().backward()
    ours = p.grad.numpy()

    def loss(q):
        splats = jalpha.splat_gaussians(q, jcam(), jnp.asarray(radii), col,
                                        jnp.asarray(alphas))
        return jnp.sum(jalpha.composite_bruteforce(
            splats, W, H, background=BACKGROUND) * weights)

    theirs = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(pos)))
    assert np.isfinite(ours).all() and np.abs(ours).max() > 0
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=GRAD_RTOL * np.abs(theirs).max())
