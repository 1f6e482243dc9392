"""The droplet slice of the port (traj_vel: capsule-LOD droplets with
velocity trails, the kind-split rows9/rows8 walk at spans 2/4/8, the
three- and four-tone shade), held against the JAX package on the CPU.

* Host replays (``rotation_from_velocity``, ``random_rotation_matrix``,
  ``droplet_mesh``, the OBJ writer) are bit-equal; instancing, the capsule
  LOD and tapered capsules are bit-equal to the JAX builders evaluated op
  by op.
* The batch rotations differ from the JAX package's by the rounding of
  ``arccos``/``cos``/``sin`` (correctly rounded in neither package) and
  XLA's multiply-add contraction: within ROT_ATOL (ROADMAP queue C).
* The traj_vel soup: its layout, kinds, colors, validity and normals
  equal the jitted JAX build's given the same rotations, params and bbox
  within BUILD_REL (XLA's multiply-add contraction); with each package's
  own rotations only the tail capsules differ, within TAIL_REL.
* ``bin_csr6(span, kind_split)`` starts and big count equal
  ``pallas_csr6._bin_csr6``'s; ``build_table9`` equals the JAX rows9.
* ``raster_tiles_rows9_plain`` equals ``cpu_reference`` with
  ``capsule_eval="cap8"`` bit for bit at spans 2, 4 and 8; rows8 renders
  through the same walk.
* One 64x64 droplet soup against ``render_shaded_csr6(interpret=True,
  rows9=True, three_tone=<four tones>)``: index equal, depth within 4 ulp
  and rgb within 1e-6 (the interpreted kernel runs as XLA CPU code with
  FMA contraction, ROADMAP queue C).
* ``derive_three_tone``/``derive_four_tone`` equal the JAX functions; the
  three- and four-tone ``shade_by_id`` are bit-equal to
  ``pallas_csr4._shade_by_id`` op by op.
* A 160x96 traj_vel frame of ``FramePipeline`` against the JAX pipeline,
  the scan's frames against ``FramePipeline``'s, and the traj_vel CLI.
The CUDA kernel itself runs only on a card: ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_render_tpu.configs import PRESETS as JAX_PRESETS
from pointcloud_render_tpu.geometry import droplet as jdroplet
from pointcloud_render_tpu.geometry import rotation as jrotation
from pointcloud_render_tpu.io import obj as jobj
from pointcloud_render_tpu.raster import cpu_reference
from pointcloud_render_tpu.raster import pallas_csr4 as jcsr4
from pointcloud_render_tpu.raster import pallas_csr6 as jcsr6
from pointcloud_render_tpu.raster import primitives as jprims
from pointcloud_render_tpu.raster.render import RasterConfig as JRasterConfig
from pointcloud_render_tpu.run import pipeline as jpipe
from pointcloud_render_tpu.scene.camera import TARGETS
from pointcloud_render_tpu.scene.camera import Camera as JCamera
from pointcloud_render_tpu.scene.camera import camera_origin_jax
from pointcloud_render_tpu.shading.shade import ShadingConfig as JShading
from pointcloud_render_tpu_torch.cli import traj_vel_renderer
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.geometry import droplet, rotation
from pointcloud_render_tpu_torch.io import obj, ply
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.primitives import (
    capsules_from_vertex_columns,
)
from pointcloud_render_tpu_torch.raster.render import (
    RasterConfig,
    check_config,
    render,
)
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.run.trajectory import (
    TrajectoryScanRenderer,
    srgb_encode_u8,
)
from pointcloud_render_tpu_torch.shading.shade import ShadingConfig
from pointcloud_render_tpu_torch.utils import convert
from tests.torch_jax import jax_soup, numpy_soup
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import (
    NEAR_ORIGIN,
    SPAN8_FILM,
    TARGET,
    cloud,
    droplet_soup,
    make_soup,
    tcam,
)

W, H = 160, 96
SMALL = 64  # film edge of the interpret-mode run (2x2 tiles)
FI = 120
# Batch rotations against the JAX package's jitted ones (entries in
# [-1, 1]; arccos/cos/sin round differently in the two packages and XLA
# contracts multiply-adds; measured: 4.8e-7 on the seeded velocities
# below and on cloud(), 2.1e-6 on 20,000 velocities normal(0, 2)).
ROT_ATOL = 4e-6
# The soup against the jitted JAX build from the same rotations: params
# and bbox relative to each column's largest magnitude (measured 8.1e-8).
BUILD_REL = 1e-6
# Tail capsules built from the two packages' rotations: their params and
# bbox, relative to each column's largest magnitude (the endpoints; the
# deltas, dr and 1/len^2 cancel and take TAIL_DELTA_REL).
TAIL_REL = 2e-6
TAIL_DELTA_REL = 1e-4
# The frame against the jitted JAX FramePipeline (tiled on CPU): the
# soup differs by the rotations above and XLA's FMA contraction
# (measured: 0 flips, depth 3 ulp, rgb 1.2e-7).
FRAME_FLIPS = 2
DEPTH_ULP = 8
RGB_ATOL = 3e-5


def _velocities(n=300, seed=21):
    """Seeded velocities with the reference's edge cases: zero, below the
    epsilon, parallel and antiparallel to the tip axis, nearly so."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 2, (n, 3)).astype(np.float32)
    v[:8] = [[0, 0, 0], [1e-7, 0, 0], [0, 0, -3], [0, 0, 5],
             [1e-9, 0, 2], [0, 1e-9, -2], [0.95, 0, 0.1], [-4, 0, 0]]
    return v


def _jcam(origin, w, h):
    return JCamera(origin=jnp.asarray(origin, jnp.float32),
                   target=jnp.asarray(TARGET, jnp.float32), width=w,
                   height=h)


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_rotation_host_replays_match_jax():
    for v in _velocities(24):
        t = np.float64([0.1, -0.2, 0.3])
        np.testing.assert_array_equal(
            rotation.rotation_from_velocity(v, t),
            jrotation.rotation_from_velocity(v, t))
    for seed in (0, 1, 7, 123):
        np.testing.assert_array_equal(
            rotation.random_rotation_matrix(seed, [1.0, 2.0, 3.0]),
            jrotation.random_rotation_matrix(seed, [1.0, 2.0, 3.0]))


# The JAX package's batch rotations, compiled once for the tests here.
_jax_rotations = jax.jit(jrotation.rotation_matrices_from_velocities)


def test_batch_rotations_match_jax_within_bound():
    v = _velocities()
    p = np.random.default_rng(22).uniform(-0.5, 0.5, v.shape).astype(
        np.float32)
    ours = rotation.rotation_matrices_from_velocities(
        v, torch.tensor(p)).numpy()
    err = np.abs(ours - np.asarray(_jax_rotations(v, p))).max()
    print(f"batch rotations: {err:.3g} from the JAX package's")
    assert err <= ROT_ATOL
    # Translations, the homogeneous row and the identity cases are exact.
    np.testing.assert_array_equal(ours[:, :3, 3], p)
    np.testing.assert_array_equal(ours[:, 3], np.tile([0, 0, 0, 1], (300, 1)))
    for k in (0, 1, 2):  # zero, below epsilon, parallel: the identity
        np.testing.assert_array_equal(ours[k, :3, :3], np.eye(3))
    # Every matrix takes the tip axis -z onto the unit velocity (the host
    # replay's float64 matrices agree with all of them).
    host = np.stack([rotation.rotation_from_velocity(vi, pi).reshape(4, 4)
                     for vi, pi in zip(v, p)])
    assert np.abs(host - ours).max() < 1e-5
    moving = np.linalg.norm(v, axis=1) > 1e-6
    unit = v[moving] / np.linalg.norm(v[moving], axis=1, keepdims=True)
    assert np.abs(-ours[moving, :3, 2] - unit).max() < 1e-5


def test_droplet_mesh_instancing_and_lod_match_jax():
    verts, faces = droplet.droplet_mesh()
    jverts, jfaces = jdroplet.droplet_mesh()
    assert verts.shape == (340, 3) and faces.shape == (640, 3)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32)
    vel = _velocities(12, seed=3)
    rot = rotation.rotation_matrices_from_velocities(vel, torch.tensor(pos))
    world, ifaces = droplet.instance_droplets(rot)
    with jax.disable_jit():
        jworld, jifaces = jdroplet.instance_droplets(rot.numpy(), None)
        jlod = jdroplet.droplet_capsule_lod(pos, vel)
    np.testing.assert_array_equal(_bits(world.numpy()), _bits(jworld))
    np.testing.assert_array_equal(ifaces, jifaces)
    lod = droplet.droplet_capsule_lod(torch.tensor(pos), torch.tensor(vel))
    for a, b in zip(lod, jlod):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    assert droplet.TAIL_TIP_OFFSET == jdroplet.TAIL_TIP_OFFSET
    assert droplet.BASE_RADIUS == jdroplet.BASE_RADIUS


def test_obj_round_trip(tmp_path):
    """The droplet OBJ is byte-equal to the JAX package's; reading it back
    gives the mesh to the file's 6 decimals, as the JAX reader does."""
    ours = droplet.write_droplet_obj(str(tmp_path / "a" / "droplet.obj"))
    theirs = jdroplet.write_droplet_obj(str(tmp_path / "b" / "droplet.obj"))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    verts, faces = obj.read_obj(ours)
    jverts, jfaces = jobj.read_obj(ours)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_array_equal(faces, droplet.droplet_mesh()[1])
    assert np.abs(verts - droplet.droplet_mesh()[0]).max() <= 6e-7
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 -1\n")
    np.testing.assert_array_equal(obj.read_obj(str(quad))[1],
                                  jobj.read_obj(str(quad))[1])
    with pytest.raises(ValueError, match="no triangle geometry"):
        (tmp_path / "empty.obj").write_text("# nothing\n")
        obj.read_obj(str(tmp_path / "empty.obj"))


def test_tapered_capsules_match_jax():
    """Per-vertex radii (the droplet tails) bit-equal to the JAX builder
    op by op; the scalar radius path is untouched."""
    rng = np.random.default_rng(5)
    n = 300
    a = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    taper = np.broadcast_to(np.float32([0.0048, 0.0004]), (n, 2))
    ones = np.ones(n, bool)
    color = np.float32([0.2, 0.4, 0.9])
    ours = capsules_from_vertex_columns(
        [torch.tensor(a), torch.tensor(b)], [torch.tensor(ones)] * 2,
        tcam(W, H), taper, color)
    with jax.disable_jit():
        theirs = jprims.capsules_from_vertex_columns(
            [jnp.asarray(a), jnp.asarray(b)], [ones, ones],
            _jcam((2.0, 2.0, 2.0), W, H), taper, color)
    assert bool(ours.valid.any())
    for name, arr in convert.soup_to_numpy(ours).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    # The tail's radius shrinks along the segment: dr < 0 where valid.
    assert (ours.params[ours.valid, 7] < 0).all()


def _jax_build(pos, vel, fi, rotations=None, w=W, h=H):
    preset = JAX_PRESETS["traj_vel"]
    origin = camera_origin_jax(preset.camera_preset, fi, preset.total_frames)
    cam = JCamera(origin=origin, target=np.asarray(TARGETS["traj_vel"],
                                                   np.float32),
                  fov_x_degrees=preset.fov_x_degrees, width=w, height=h)
    return jpipe.build_primitives(preset, cam, pos, vel, fi,
                                  rotations=rotations,
                                  return_layout=True), cam


@pytest.fixture(scope="module")
def traj_vel_soup():
    """The traj_vel soup of ``cloud()`` at frame FI from the port's
    rotations, built by the port and by the jitted JAX package (one
    compile) -> (soup, layout, JAX soup, JAX layout)."""
    pos, vel = cloud()
    rot = rotation.rotation_matrices_from_velocities(vel, torch.tensor(pos))
    cam = pipeline.frame_camera(PRESETS["traj_vel"], FI, W, H, "cpu")
    soup, layout = pipeline.build_primitives(
        PRESETS["traj_vel"], cam, pos, vel, FI, rotations=rot,
        return_layout=True)
    jlayout = []

    def jbuild(p, v, r):
        (jsoup, lay), _ = _jax_build(p, v, jnp.int32(FI), rotations=r)
        jlayout[:] = lay  # static, read while tracing
        return jsoup

    jsoup = jax.jit(jbuild)(pos, vel, rot.numpy())
    return soup, layout, jax.tree_util.tree_map(np.asarray, jsoup), jlayout


def test_droplet_soup_matches_jax_build_primitives(traj_vel_soup):
    pos, vel = cloud()
    n = pos.shape[0]
    soup, layout, jsoup, jlayout = traj_vel_soup
    assert layout == jlayout == [(4, 0), (n, 1), (n, 1), (8 * n, 8)]
    ours = convert.soup_to_numpy(soup)
    for name in ("kind", "color", "valid", "normal"):
        np.testing.assert_array_equal(ours[name], getattr(jsoup, name),
                                      err_msg=name)
    valid = ours["valid"]
    for name in ("params", "bbox"):
        a, b = ours[name], getattr(jsoup, name)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        a, b = a[valid], b[valid]
        scale = np.abs(a).max(axis=0)
        rel = np.abs(a - b).max(axis=0) / np.maximum(scale, 1e-30)
        print(f"traj_vel soup vs jitted JAX: {name} rel diff {rel.max():.3g}")
        assert (np.abs(a - b) <= BUILD_REL * scale).all(), name
    assert valid[4:4 + n].sum() > 250  # heads render
    assert valid[4 + n:4 + 2 * n].sum() > 250  # tails render
    # The JAX package's own rotations move the tail capsules only: every
    # other row is bit-equal, the tails within TAIL_REL.
    jrot = np.asarray(_jax_rotations(vel, pos))
    cam = pipeline.frame_camera(PRESETS["traj_vel"], FI, W, H, "cpu")
    own = convert.soup_to_numpy(pipeline.build_primitives(
        PRESETS["traj_vel"], cam, pos, vel, FI, rotations=jrot))
    tail = np.arange(4 + n, 4 + 2 * n)
    for name, arr in own.items():
        np.testing.assert_array_equal(np.delete(arr, tail, axis=0),
                                      np.delete(ours[name], tail, axis=0),
                                      err_msg=name)
    for name in ("kind", "color", "valid", "normal"):
        np.testing.assert_array_equal(own[name], ours[name])
    valid = own["valid"][tail]
    for name in ("params", "bbox"):
        a, b = own[name][tail][valid], ours[name][tail][valid]
        scale = np.abs(a).max(axis=0)
        bound = np.full(a.shape[1], TAIL_REL)
        if name == "params":
            bound[4:9] = TAIL_DELTA_REL  # deltas, dr and 1/len^2 cancel
        rel = np.abs(a - b) / np.maximum(scale, 1e-30)
        print(f"traj_vel tails, JAX rotations: {name} rel diff "
              f"{rel.max(axis=0).tolist()}")
        assert (np.abs(a - b) <= bound * scale).all(), name


BIN_CASES = [(2, True), (4, True), (8, True), (4, False)]


@pytest.mark.parametrize("span,kind_split", BIN_CASES)
def test_kind_split_binning_matches_jax(span, kind_split):
    """starts (every (region, anchor, class) bound), big count, overflow
    and true_entries equal the JAX binning's; the probe mirrors it."""
    soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    w, h = 150, 90
    tiles_x, tiles_y = csr6.grid_shape(w, h)
    num_tiles = tiles_x * tiles_y
    factor = 2 if kind_split else 1

    @jax.jit
    def jbin(s):
        keys, _, _, big_count, _, n_small = jcsr6._bin_csr6(
            s, 32, 32, num_tiles, tiles_x, tiles_y, max_big=8, span=span,
            with_z=False, kind_split=kind_split)
        bounds = jnp.arange(factor * num_tiles * span * span + 1,
                            dtype=keys.dtype)
        return (jnp.searchsorted(keys, bounds).astype(jnp.int32), big_count,
                jcsr6.bin_diagnostics6(s, w, h, max_big=8, span=span))

    jstarts, jbig, jovf = (np.asarray(x) for x in jbin(jax_soup(soup)))
    b = csr6.bin_csr6(soup, w, h, 8, span=span, kind_split=kind_split)
    np.testing.assert_array_equal(b["starts"].numpy(), jstarts)
    assert int(b["big_count"]) == int(jbig) > 0
    assert int(b["diag"]["big_overflow"]) == int(jovf)
    assert int(csr6.bin_diagnostics6(soup, w, h, 8, span=span,
                                     kind_split=kind_split)) == int(jovf)
    cls = np.diff(jstarts).reshape(factor * num_tiles, span * span).sum(0)
    sx, sy = csr6.class_spill(span)
    assert int(b["diag"]["true_entries"]) == int(
        cls @ ((np.array(sx) + 1) * (np.array(sy) + 1)))
    if kind_split:  # discs first, then capsules
        region = csr6._binned_layout(b["starts"], w, h, span)[0]
        kinds = soup.kind[b["order"][:region.shape[0]].long()]
        np.testing.assert_array_equal(kinds.numpy(), region.numpy())


def test_table9_matches_jax():
    """build_table9 equals the JAX rows9 gather (``_rows9_columns``
    through the sorted order, NaN past the binned prefix)."""
    soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    b = csr6.bin_csr6(soup, 150, 90, 64, span=4, kind_split=True)
    rows = csr6.build_table9(soup, b["order"], b["starts"][-1])
    p = soup.count

    @jax.jit
    def jrows(s, order, n_small):
        table = jnp.pad(jnp.stack(jcsr6._rows9_columns(s), axis=1),
                        ((0, 1), (0, 0)), constant_values=np.nan)
        live = jnp.arange(p, dtype=jnp.int32) < n_small
        return table[jnp.where(live, order, p)]

    theirs = np.asarray(jrows(jax_soup(soup), b["order"].numpy(),
                              int(b["starts"][-1])))
    np.testing.assert_array_equal(_bits(rows.numpy()), _bits(theirs))
    n_small = int(b["starts"][-1])
    assert np.isnan(rows.numpy()[n_small:]).all()
    assert not np.isnan(rows.numpy()[:n_small]).any()


def _rows9_inputs(soup, w, h, span, max_big=64):
    b = csr6.bin_csr6(soup, w, h, max_big, span=span, kind_split=True)
    zeros = torch.zeros((soup.count, 3))
    rows9 = csr6.build_table9(soup, b["order"], b["starts"][-1])
    big = csr6.build_table16_rows(soup, zeros, zeros[:, 0], b["big_ids"])
    return (rows9, big, b["starts"], b["big_n"], w, h, span), b


@pytest.mark.parametrize("span", [2, 4, 8])
def test_plain_rows9_matches_cap8_oracle(span):
    """The plain kind-split walk against the NumPy oracle's cap8 twin, bit
    for bit: binned capsules take the renormalized evaluation, big-list
    capsules and all discs the exact one, split at the render's span.  At
    span 8 the film has 10x8 tiles, where long capsules reach 5-8 tiles
    (binned only at span 8)."""
    w, h = SPAN8_FILM if span == 8 else (150, 90)
    drops = droplet_soup(tcam(w, h, origin=NEAR_ORIGIN))
    for soup in (drops, make_soup("spill"), make_soup("invalid")):
        d_o, i_o = cpu_reference.rasterize_reference(
            numpy_soup(soup), w, h, capsule_eval="cap8", span=span)
        assert (i_o >= 0).any()
        args, b = _rows9_inputs(soup, w, h, span)
        assert int(b["diag"]["big_overflow"]) == 0
        depth, index = csr6.raster_tiles_rows9_plain(*args)
        np.testing.assert_array_equal(index.numpy(), i_o)
        np.testing.assert_array_equal(_bits(depth.numpy()), _bits(d_o))
    if span == 8:  # some capsules reach 5-8 tiles: binned only at span 8
        _, b = _rows9_inputs(drops, w, h, span)
        cls = np.diff(b["starts"].numpy()).reshape(2, -1, 64).sum(axis=1)[1]
        sx, sy = (np.array(c) for c in csr6.class_spill(8))
        assert cls[(sx >= 4) | (sy >= 4)].sum() > 0
    # The cap8 evaluation is not cap10's: depth bits differ somewhere.
    d8, _ = cpu_reference.rasterize_reference(
        numpy_soup(drops), w, h, capsule_eval="cap8", span=span)
    d10, _ = cpu_reference.rasterize_reference(numpy_soup(drops), w, h)
    assert (_bits(d10) != _bits(d8)).any()


def test_rows8_renders_through_the_rows9_walk(monkeypatch):
    """rows8 and rows9 evaluate the same float32 expressions: one walk,
    identical frames, one launch each through the same wrapper."""
    soup = droplet_soup(tcam(origin=NEAR_ORIGIN))
    calls = []
    real = csr6.raster_tiles_rows9_plain
    monkeypatch.setattr(csr6, "raster_tiles_rows9_plain",
                        lambda *a: calls.append(a[-1]) or real(*a))
    cam = tcam(origin=NEAR_ORIGIN)
    fbs = [render(soup, cam, RasterConfig(span=4, **{mode: True}))
           for mode in ("rows8", "rows9")]
    assert calls == [4, 4]
    for field in ("index", "depth", "rgb"):
        np.testing.assert_array_equal(getattr(fbs[0], field).numpy(),
                                      getattr(fbs[1], field).numpy())


@pytest.fixture(scope="module")
def interpret_scene():
    """The 64x64 droplet soup, its four tones, and its one interpret-mode
    Pallas render (rows9 at span 2, four-tone shade) under one jit with
    ``unroll=1`` (one merge chain: the same winners)."""
    soup = droplet_soup(tcam(SMALL, SMALL, origin=NEAR_ORIGIN))
    reps, ok = csr6.derive_four_tone(soup)
    assert bool(ok)
    tones = tuple(int(r) for r in reps)
    out = jax.jit(lambda s: jcsr6.render_shaded_csr6(
        s, _jcam(NEAR_ORIGIN, SMALL, SMALL), JShading(), interpret=True,
        rows9=True, three_tone=tones, span=2, unroll=1, max_big=64,
        return_diag=True))(jax_soup(soup))
    rgb, depth, index, diag = out
    return soup, tones, dict(rgb=np.asarray(rgb), depth=np.asarray(depth),
                             index=np.asarray(index),
                             diag={k: int(np.asarray(v))
                                   for k, v in diag.items()})


def test_rows9_render_matches_pallas_interpret(interpret_scene):
    soup, tones, theirs = interpret_scene
    rgb, depth, index, diag = csr6.render_shaded_csr6(
        soup, tcam(SMALL, SMALL, origin=NEAR_ORIGIN), ShadingConfig(),
        max_big=64, rows9=True, three_tone=tones, span=2)
    index, depth = index.numpy(), depth.numpy()
    np.testing.assert_array_equal(index, theirs["index"])
    hit = index >= 0
    kinds = soup.kind.numpy()[np.maximum(index, 0)]
    assert hit.all() and (kinds == 1).sum() > 64 and (kinds == 0).sum() > 32
    disc = hit & (kinds == 0)
    np.testing.assert_array_equal(_bits(depth)[disc],
                                  _bits(theirs["depth"])[disc])
    ulp = np.abs(_bits(depth).astype(np.int64) - _bits(theirs["depth"]))
    gap = np.abs(rgb.numpy() - theirs["rgb"]).max()
    print(f"rows9 vs interpret: depth {ulp[hit].max()} ulp, rgb {gap:.3g}")
    assert ulp[hit].max() <= 4 and gap <= 1e-6
    assert int(diag["true_entries"]) == theirs["diag"]["true_entries"]
    assert int(diag["big_overflow"]) == theirs["diag"]["big_overflow"] == 0
    # The same winners as the cap8 oracle.
    oracle = cpu_reference.rasterize_reference(
        numpy_soup(soup), SMALL, SMALL, capsule_eval="cap8", span=2)[1]
    np.testing.assert_array_equal(index, oracle)


def test_tone_reps_match_jax():
    """derive_three_tone / derive_four_tone equal the JAX functions on a
    droplet soup (two capsule colors: four-tone only) and a trail soup
    (one: both), and fail on a soup whose disc colors differ."""
    cam = tcam()
    pos, vel = cloud(n=80)
    trail = pipeline.build_primitives(PRESETS["traj_ball"], cam, pos, vel, FI)
    mixed = make_soup("wide_big")  # gray and red discs
    expect = {"drop": (False, True), "trail": (True, True),
              "mixed": (False, False)}
    jderive = jax.jit(lambda s: (jcsr6.derive_three_tone(s),
                                 jcsr6.derive_four_tone(s)))
    for name, soup in (("drop", droplet_soup(cam)), ("trail", trail),
                       ("mixed", mixed)):
        (r3, ok3), (r4, ok4) = jderive(jax_soup(soup))
        t3, t_ok3 = csr6.derive_three_tone(soup)
        t4, t_ok4 = csr6.derive_four_tone(soup)
        np.testing.assert_array_equal(t3.numpy(), np.asarray(r3))
        np.testing.assert_array_equal(t4.numpy(), np.asarray(r4))
        assert (bool(t_ok3), bool(t_ok4)) == (bool(ok3), bool(ok4)) \
            == expect[name], name


def test_tone_shades_match_jax():
    """The three- and four-tone shade_by_id bit-equal to
    pallas_csr4._shade_by_id op by op (both tuples on one droplet soup:
    the function is the same whatever the certificate says), and each
    certified tuple within 1e-6 of the generic preshade shade (0 u8
    values differ): the four tones on the droplet soup, the three on a
    traj_ball soup."""
    cam = tcam(origin=NEAR_ORIGIN)
    shading = ShadingConfig()
    drops = droplet_soup(cam)
    four, ok4 = csr6.derive_four_tone(drops)
    three, _ = csr6.derive_three_tone(drops)
    depth, index, _ = csr6.rasterize_csr6(drops, 150, 90, max_big=64,
                                          rows9=True)
    zeros3, zeros = torch.zeros((drops.count, 3)), torch.zeros(drops.count)
    for reps in (three, four):
        tones = tuple(int(r) for r in reps)
        ours = csr6.shade_by_id(drops, cam, shading, depth, index, zeros3,
                                zeros, three_tone=tones)
        with jax.disable_jit():
            theirs, _ = jcsr4._shade_by_id(
                jax_soup(drops), _jcam(NEAR_ORIGIN, 150, 90), JShading(),
                jnp.asarray(depth.numpy()),
                jnp.asarray(index.numpy().astype(np.float32)),
                jnp.zeros((drops.count, 3)), jnp.zeros(drops.count),
                three_tone=tones)
        np.testing.assert_array_equal(_bits(ours.numpy()), _bits(theirs))
    # Both capsule tones show in the four-tone frame.
    kinds = drops.kind.numpy()[np.maximum(index.numpy(), 0)]
    split = index.numpy() < int(four[3])
    assert ((kinds == 1) & split).any() and ((kinds == 1) & ~split).any()
    pos, vel = cloud(n=80)
    trail = pipeline.build_primitives(PRESETS["traj_ball"], cam, pos, vel, FI)
    three_t, ok3 = csr6.derive_three_tone(trail)
    assert bool(ok4) and bool(ok3)
    for soup, reps in ((drops, four), (trail, three_t)):
        depth, index, _ = csr6.rasterize_csr6(soup, 150, 90, max_big=64,
                                              rows9=True)
        z3 = torch.zeros((soup.count, 3))
        toned = csr6.shade_by_id(soup, cam, shading, depth, index, z3,
                                 z3[:, 0], three_tone=tuple(
                                     int(r) for r in reps))
        rgb_p, flag = csr6.preshade(soup, cam, shading)
        generic = csr6.shade_by_id(soup, cam, shading, depth, index, rgb_p,
                                   flag)
        assert np.abs(generic.numpy() - toned.numpy()).max() <= 1e-6
        np.testing.assert_array_equal(srgb_encode_u8(generic).numpy(),
                                      srgb_encode_u8(toned).numpy())


def test_traj_vel_frame_matches_jax_pipeline(traj_vel_soup):
    """A 160x96 traj_vel frame: its winners and depth bits equal the NumPy
    oracle's on the same soup, and the frame is within FRAME_FLIPS flips,
    DEPTH_ULP and RGB_ATOL of the jitted JAX FramePipeline (its own
    rotations, tiled on CPU)."""
    pos, vel = cloud()
    pcl = np.concatenate([pos, vel], axis=1)
    soup = traj_vel_soup[0]
    fb = render(soup, pipeline.frame_camera(PRESETS["traj_vel"], FI, W, H,
                                            "cpu"), RasterConfig())
    d_o, i_o = cpu_reference.rasterize_reference(numpy_soup(soup), W, H)
    np.testing.assert_array_equal(fb.index.numpy(), i_o)
    np.testing.assert_array_equal(_bits(fb.depth.numpy()), _bits(d_o))
    tp = pipeline.FramePipeline(PRESETS["traj_vel"], width=W, height=H,
                                device="cpu")
    ours = tp.render_array(pcl, FI)
    jp = jpipe.FramePipeline(JAX_PRESETS["traj_vel"],
                             JRasterConfig(max_per_tile=2048), width=W,
                             height=H)
    jfb = jp.render_array(pcl, FI)
    index = ours.index.numpy()
    kinds = soup.kind.numpy()[np.maximum(index, 0)]
    assert (kinds == 0).sum() > 100 and (kinds == 1).sum() > 100
    same = index == np.asarray(jfb.index)
    flips = int((~same).sum())
    hit = same & (index >= 0)
    ulp = np.abs(_bits(ours.depth.numpy()).astype(np.int64)
                 - _bits(np.asarray(jfb.depth)))[hit].max()
    rgb = np.abs(ours.rgb.numpy() - np.asarray(jfb.rgb))[same].max()
    print(f"traj_vel frame vs jitted JAX: {flips} flips, depth {ulp} ulp, "
          f"rgb {rgb:.3g}")
    assert flips <= FRAME_FLIPS and ulp <= DEPTH_ULP and rgb <= RGB_ATOL


def test_traj_vel_scan_frames_equal_pipeline_frames():
    """The scan on traj_vel renders FramePipeline's frames (sRGB encoded),
    at the default config and on the tuned rows9 + four-tone lane."""
    pos, vel = cloud(n=120, seed=9)
    preset = PRESETS["traj_vel"]
    ids = [20, 120, 210]
    cam = pipeline.frame_camera(preset, ids[0], 96, 64, "cpu")
    tones, ok = csr6.derive_four_tone(pipeline.build_primitives(
        preset, cam, pos, vel, ids[0]))
    assert bool(ok)
    for cfg in (RasterConfig(), RasterConfig(
            rows9=True, span=4, three_tone=tuple(int(r) for r in tones))):
        frames, _ = TrajectoryScanRenderer(
            preset, cfg, frames_per_chunk=2, width=96, height=64,
            device="cpu").render_frames(pos, vel, ids)
        pipe = pipeline.FramePipeline(preset, cfg, width=96, height=64,
                                      device="cpu")
        pcl = np.concatenate([pos, vel], axis=1)
        for fi, frame in zip(ids, frames):
            want = srgb_encode_u8(pipe.render_array(pcl, fi).rgb).numpy()
            np.testing.assert_array_equal(frame, want)
        assert (frames[1].min(axis=2) < 250).mean() > 0.01


def test_traj_vel_cli_on_cpu(tmp_path):
    pos, vel = cloud(n=150, seed=5)
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    for fi in (10, 120):
        ply.write_ply(str(inp / f"frame_{fi:04d}_b0.ply"), pos + 0.01 * fi,
                      velocities=vel)
    sink = traj_vel_renderer.main(
        ["--input-folder", str(inp), "--output-folder", str(out), "--frames",
         "10,120", "--device", "cpu", "--width", "96", "--height", "64"])
    assert [r.status for r in sink.records] == ["ok", "ok"]
    for fi in (10, 120):
        assert (out / f"frame_{fi:04d}_b0.png").read_bytes()[:8] \
            == b"\x89PNG\r\n\x1a\n"
    bad = traj_vel_renderer.main(
        ["--input-folder", str(inp), "--output-folder", str(tmp_path / "o2"),
         "--frames", "10", "--device", "cpu", "--droplet-lod", "capsule",
         "--width", "96", "--height", "64"])
    assert [r.status for r in bad.records] == ["ok"]
    mesh = traj_vel_renderer.main(
        ["--input-folder", str(inp), "--output-folder", str(tmp_path / "o3"),
         "--frames", "120", "--device", "cpu", "--droplet-lod", "mesh",
         "--width", "96", "--height", "64"])
    assert [r.status for r in mesh.records] == ["ok"]
    assert (tmp_path / "o3" / "frame_0120_b0.png").read_bytes()[:8] \
        == b"\x89PNG\r\n\x1a\n"


def test_rows9_wrapper_dispatch_and_knob_errors():
    """CPU tensors take the plain walk without counting a launch; a device
    with no kernel raises; malformed inputs and the knob combinations the
    JAX package rejects raise."""
    args, _ = _rows9_inputs(droplet_soup(tcam(origin=NEAR_ORIGIN)), 150, 90,
                            4)
    before = csr6.raster_tiles_rows9.launches
    got = csr6.raster_tiles_rows9(*args)
    want = csr6.raster_tiles_rows9_plain(*args)
    assert csr6.raster_tiles_rows9.launches == before
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="no csr6 kernel"):
        csr6.raster_tiles_rows9(*(a.to("meta") for a in args[:4]), *args[4:])
    with pytest.raises(ValueError, match="rows9 must be"):
        csr6.raster_tiles_rows9(args[0][:, :8], *args[1:])
    with pytest.raises(ValueError, match="starts does not match"):
        csr6.raster_tiles_rows9(*args[:6], 2)
    for cfg, err in ((RasterConfig(rows8=True, rows9=True), "exclusive"),
                     (RasterConfig(rows9=True, discs_only=True), "exclusive"),
                     (RasterConfig(rows9=True, allow_exit=True), "allow_exit"),
                     (RasterConfig(rows9_carry=True), "requires rows9"),
                     (RasterConfig(rows9=True, span=3), "span"),
                     (RasterConfig(three_tone=(0, 1)), "3 or 5")):
        with pytest.raises(ValueError, match=err):
            check_config(cfg)
    # TPU build variants and the tuned lane's knobs are accepted.
    check_config(RasterConfig(rows9=True, rows9_carry=True, span=8,
                              three_tone=(0, 1, 2, 3, 4), chunk_rows=1024))
    cfg = convert.raster_config_from_fields(JRasterConfig(
        rows9=True, span=4, three_tone=np.int32([4, 5, 6, 7, 0])))
    assert cfg.three_tone == (4, 5, 6, 7, 0) and cfg.span == 4
    hash(cfg)
