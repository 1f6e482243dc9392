"""The port's fidelity certificate and tuned-defaults loader
(``pointcloud_render_tpu_torch.utils.fidelity`` and ``utils.tuned``)
against the JAX package's ``utils/fidelity.py`` and ``utils/tuned.py``.

The NumPy functions (``owner_map``, ``surface_image``, ``part_image``) are
held equal to the JAX ones on the layouts of the port's
``build_primitives`` (traj_ball, traj_vel and the mesh LOD) and on a
layout with the mesh LOD's ``("split2", faces)`` count, over rendered and
synthetic index images with empty pixels; ``load_tuned``/``fill`` on
missing, garbage and valid files; the certificate's limit on the JAX
records to ``benchmarks/pick_tuned.py``'s rule.  The flip-rate functions
are not held to the JAX ones here: one cold JAX call of either costs
~28 s of XLA compiles on one CPU, past this file's budget.  They are
checked on the port's own renders (a candidate with known changes) and,
on the card, against the JAX records (``chip_smoke.py``'s fidelity
phase).  No XLA compile: the JAX functions compared are NumPy code.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from pointcloud_render_tpu.utils import fidelity as jfidelity
from pointcloud_render_tpu.utils import tuned as jtuned
from pointcloud_render_tpu_torch.configs import PRESETS
from pointcloud_render_tpu_torch.raster import csr6
from pointcloud_render_tpu_torch.raster.primitives import KIND_CAPSULE
from pointcloud_render_tpu_torch.run import pipeline
from pointcloud_render_tpu_torch.utils import fidelity, tuned
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)
from tests.torch_soups import cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILM = (96, 64)
# A tiny certificate scene: the records' presets and reference polyline
# (20 segments), 200 points on a 160x90 film, one frame.
TINY = dict(n_points=200, frames=(120,), width=160, height=90,
            device="cpu")


def _built_layout(case):
    """(layout, rendered index image) of the port's build at FILM."""
    pos, vel = cloud(40, seed=3)
    preset = PRESETS["traj_ball" if case == "traj_ball" else "traj_vel"]
    cam = pipeline.frame_camera(preset, 120, *FILM, "cpu")
    soup, layout = pipeline.build_primitives(
        preset, cam, pos, vel, 120, return_layout=True,
        droplet_lod="mesh" if case == "mesh" else "capsule")
    _, index, _ = csr6.rasterize_csr6(soup, *FILM, max_big=soup.count)
    return layout, index.numpy()


LAYOUTS = {"traj_ball": lambda: _built_layout("traj_ball"),
           "traj_vel": lambda: _built_layout("traj_vel"),
           "mesh": lambda: _built_layout("mesh"),
           "split2": lambda: ([(2, 0), (24, ("split2", 4)), (3, 0),
                               (18, 3)], None)}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_surface_codes_match_jax(case):
    """owner_map, surface_image and part_image == the JAX functions:
    the same codes and dtypes on a rendered image (where there is one)
    and on a seeded image of every prim id and empty pixels."""
    layout, rendered = LAYOUTS[case]()
    n = sum(rows for rows, _ in layout)
    np.testing.assert_array_equal(fidelity.owner_map(layout, n),
                                  jfidelity.owner_map(layout, n))
    synthetic = np.random.default_rng(7).integers(0, n, (17, 23)).astype(
        np.int32)
    synthetic[::4, ::3] = -1
    synthetic[0, :2] = (0, n - 1)
    for img in (synthetic, rendered) if rendered is not None else (
            synthetic,):
        assert (img >= 0).any()
        for fn, jfn in ((fidelity.surface_image, jfidelity.surface_image),
                        (fidelity.part_image, jfidelity.part_image)):
            got, want = fn(img, layout), jfn(img, layout)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_owner_map_rejects_a_short_layout():
    with pytest.raises(ValueError, match="layout covers 5 of 6"):
        fidelity.owner_map([(2, 0), (3, 1)], 6)


TUNED_FILES = {"missing": None, "garbage": "{not json", "list": "[1, 2]",
               "valid": json.dumps({"trail": {"segments": 4, "rows9": True},
                                    "note": "x"})}


@pytest.mark.parametrize("case", sorted(TUNED_FILES))
def test_load_tuned_matches_jax(case, tmp_path):
    path = tmp_path / "tuned.json"
    if TUNED_FILES[case] is not None:
        path.write_text(TUNED_FILES[case])
    got = tuned.load_tuned(str(path))
    assert got == jtuned.load_tuned(str(path))
    assert got == ({} if case != "valid" else json.loads(TUNED_FILES[case]))


def test_repo_tuned_defaults_match_jax():
    """By default both read the repository's tuned_defaults.json, whose
    trail and droplet lanes take the two geometry knobs."""
    assert tuned.TUNED_PATH == jtuned.TUNED_PATH
    got = tuned.load_tuned()
    assert got == jtuned.load_tuned() != {}
    for lane in ("trail", "droplet"):
        assert got[lane]["segments"] == 4 and got[lane]["rows9"] is True


@pytest.mark.parametrize("args", [(8, {"k": 4}, "k", 2), (None, {"k": 4},
                                                          "k", 2),
                                  (None, {}, "k", 2), (None, {"k": None},
                                                       "k", 2),
                                  (False, {"k": True}, "k", None)])
def test_fill_matches_jax(args):
    """Explicit value > tuned file > builtin, as the JAX fill."""
    assert tuned.fill(*args) == jtuned.fill(*args)


def test_flip_limit_is_pick_tuneds_rule_on_the_records():
    """The certificate's limit, max(bound, rate(8) + margin), with
    pick_tuned's constants: 0.005 for traj_ball and 0.0109 for traj_vel
    on the JAX records."""
    spec = importlib.util.spec_from_file_location(
        "pick_tuned", os.path.join(REPO, "benchmarks", "pick_tuned.py"))
    pick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pick)
    assert fidelity.FLIP_MARGIN == pick.GEOMETRY_REL_MARGIN
    assert str(fidelity.DEFAULT_SEGMENTS) == pick.DEFAULT_SEGMENTS
    assert fidelity.DEFAULT_SEGMENTS == pipeline.VEL_TRAIL_RENDER_SEGMENTS
    with open(pick.FIDELITY_CERT) as f:
        cert = json.load(f)
    assert fidelity.FLIP_BOUND == cert["bound"]
    limits = {name: fidelity.flip_limit(scene["rates"]["8"]["trail_rate"])
              for name, scene in cert["scenes"].items()}
    assert limits["traj_ball"] == 0.005
    assert limits["traj_vel"] == pytest.approx(0.0109, abs=1e-4)


def _empty_trail_pixels(monkeypatch, k, which):
    """Make ``fidelity._index`` empty the first ``k`` pixels a trail
    capsule wins (the soup's last 20 rows per point) in the renders of
    TINY at 20 segments that ``which(rows9, call number)`` selects."""
    real = fidelity._index
    calls = []

    def index(soup, width, height, rows9=False, span=csr6.SPAN):
        img = real(soup, width, height, rows9, span)
        calls.append(rows9)
        if which(rows9, len(calls)):
            trail_start = soup.count - 20 * TINY["n_points"]
            assert int(soup.kind[trail_start:].ne(KIND_CAPSULE).sum()) == 0
            hit = np.flatnonzero(img >= trail_start)
            assert hit.size > k
            img.flat[hit[:k]] = -1
        return img

    monkeypatch.setattr(fidelity, "_index", index)
    return calls


@pytest.mark.parametrize("preset", ["traj_ball", "traj_vel"])
def test_flip_rate_counts_the_candidates_changes(preset, monkeypatch):
    """At the reference's own segment count the exact and the rows9
    candidates flip no pixel; 3 trail pixels emptied in the rows9
    candidate are 3 flips, all visible (trail -> empty), and its
    candidate_diff; the exact candidate (cap10) is not touched."""
    for capsule_eval in ("cap10", "cap8"):
        r = fidelity.trail_segments_flip_rate(
            20, preset_name=preset, capsule_eval=capsule_eval, **TINY)
        assert r == {"segments": 20, "frame_rate": 0.0, "trail_rate": 0.0,
                     "kind_rate": 0.0, "candidate_diff": 0}
    denom = fidelity.trail_flip_decomposition(
        20, preset_name=preset, **TINY)["denom"]
    assert denom > 50
    calls = _empty_trail_pixels(monkeypatch, 3, lambda rows9, _: rows9)
    r = fidelity.trail_segments_flip_rate(20, preset_name=preset,
                                          capsule_eval="cap8", **TINY)
    assert calls == [True, False, False]  # candidate, reference, exact
    assert r["candidate_diff"] == 3
    assert r["trail_rate"] == r["kind_rate"] == 3 / denom
    assert r["frame_rate"] == 3 / (160 * 90)
    assert fidelity.trail_segments_flip_rate(
        20, preset_name=preset, **TINY)["trail_rate"] == 0.0
    with pytest.raises(ValueError, match="capsule_eval"):
        fidelity.trail_segments_flip_rate(4, capsule_eval="cap9", **TINY)


def test_flip_decomposition_attributes_the_candidates_changes(monkeypatch):
    """3 trail pixels emptied in the candidate (the first render of the
    frame) are the decomposition's only transition, from the candidate's
    part to the reference's: empty -> trail."""
    _empty_trail_pixels(monkeypatch, 3, lambda _, n: n == 1)
    d = fidelity.trail_flip_decomposition(20, **TINY)
    assert d["frame"] == 120 and d["parts"] == ["ground", "head", "tail",
                                                "trail"]
    assert d["transitions"] == {"empty->trail": 3 / d["denom"]}
    assert d["trail_rate"] == 3 / d["denom"] and d["trail_owner_swap"] == 0
