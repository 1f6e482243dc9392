"""Build and load the port's hand-written CUDA kernels.

Each library is one ``csrc/<name>.cu`` file (one kernel or a few that
share code; the per-pair evaluations they all use sit in
``csrc/raster_pairs.cuh``) with a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper into a shared library under
``build/kernels/`` beside the package (a directory git ignores) and bound
with ``ctypes``.  The library name carries a hash of the source, the
headers and the flags, so an edited source rebuilds and a finished build
is reused.  ``build_all`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

# -fmad=false: no multiply-add contraction (the per-pair math is IEEE
# float32 per operation); no --use_fast_math: division and sqrt stay
# correctly rounded.  -Xptxas -v records registers/spills in the log.
# Every kernel library of csrc/.
LIBRARIES = ("csr6_raster", "csr2_raster", "csr5_raster")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    the shared ``csrc/*.cuh`` headers and the flags)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library path.  The nvcc log is kept beside the library as ``.log``.
    Processes that build one library at once (the ranks of a world) take
    turns on a lock file: the first compiles, the others find its
    library."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.isfile(out):
            _compile(name, out)
    return out


def _compile(name: str, out: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        with open(out[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_all(names=LIBRARIES) -> list:
    """:func:`build` each library of ``names`` at once (one ``nvcc`` per
    source, all started together); returns their paths."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def build_log(name: str) -> str:
    """The nvcc output of the last build of ``name`` ('' if none)."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``."""
    return ctypes.CDLL(build(name))
