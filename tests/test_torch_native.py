"""The port's binding to the native IO library (``io/native.py``) and the
loaders' native PLY reader, held against the JAX package's binding on the
same files: equal arrays, equal PNG bytes, equal errors.  Skips where the
library was not built (``tests/conftest.py`` builds it with ``make``)."""

import numpy as np
import pytest

from pointcloud_render_tpu.io import loaders as jloaders
from pointcloud_render_tpu.io import native as jnative
from pointcloud_render_tpu_torch.io import loaders, native, ply
from tests.torch_jax import one_intra_op_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(2)


@pytest.fixture(autouse=True)
def library():
    if not native.available():
        pytest.skip("the native library was not built")


def _signed_ply(path):
    """Binary signed int/short/char coordinates (negatives sign-extend)."""
    header = (b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
              b"property int x\nproperty short y\nproperty char z\n"
              b"end_header\n")
    rows = [(-1, -2, -3), (7, 8, 9), (-2147483648, -32768, -128)]
    body = b"".join(np.int32(x).tobytes() + np.int16(y).tobytes()
                    + np.int8(z).tobytes() for x, y, z in rows)
    with open(path, "wb") as f:
        f.write(header + body)


def _ascii_before_vertex(path):
    """An ASCII PLY whose vertex element follows a list element."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                "element face 2\nproperty list uchar int vertex_indices\n"
                "element vertex 2\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n3 0 1 2\n2 0 1\n1 2 3\n4 5 6\n")


def _write(kind, path):
    pos = RNG.normal(size=(500, 3)).astype(np.float32)
    other = RNG.normal(size=(500, 3)).astype(np.float32)
    if kind == "velocities":
        ply.write_ply(path, pos, velocities=other)
    elif kind == "normals":
        ply.write_ply(path, pos, normals=other)
    elif kind == "ascii":
        ply.write_ply(path, pos[:50], binary=False)
    elif kind == "signed":
        _signed_ply(path)
    else:
        _ascii_before_vertex(path)


@pytest.mark.parametrize("positions_only", [False, True])
@pytest.mark.parametrize("kind", ["velocities", "normals", "ascii", "signed",
                                  "list_before_vertex"])
def test_read_ply_array_equals_jax(tmp_path, kind, positions_only):
    path = str(tmp_path / "c.ply")
    _write(kind, path)
    got = native.read_ply_array(path, positions_only=positions_only)
    want = jnative.read_ply_array(path, positions_only=positions_only)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        loaders.load_point_cloud(path, positions_only=positions_only),
        jloaders.load_point_cloud(path, positions_only=positions_only))


def test_loader_takes_the_native_reader(tmp_path, monkeypatch):
    path = str(tmp_path / "d.ply")
    _write("velocities", path)
    calls = []
    read = native.read_ply_array

    def reader(p, positions_only=False):
        calls.append(p)
        return read(p, positions_only)
    monkeypatch.setattr(native, "read_ply_array", reader)
    loaders.load_point_cloud(path)
    assert calls == [path]


def test_png_bytes_equal_jax(tmp_path):
    from PIL import Image

    img = (RNG.uniform(size=(32, 64, 3)) * 255).astype(np.uint8)
    paths = [str(tmp_path / f"{k}.png") for k in ("port", "jax")]
    assert native.write_png(paths[0], img)
    assert jnative.write_png(paths[1], img)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(np.asarray(Image.open(paths[0])), img)
    with pytest.raises(ValueError, match="takes"):
        native.write_png(paths[0], img[..., :2])


def test_corrupt_file_raises_as_jax(tmp_path):
    path = str(tmp_path / "bad.ply")
    with open(path, "wb") as f:
        f.write(b"not a ply at all")
    with pytest.raises(OSError):
        native.read_ply_array(path)
    with pytest.raises(OSError):
        jnative.read_ply_array(path)
