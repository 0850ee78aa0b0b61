"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``iterativelqr_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed on a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.  Nothing is built
at import: ``load_library`` runs the first time a CUDA tensor reaches a
kernel, so the package imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of iterativelqr_tpu_torch are built from csrc/ at "
        "first use"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libilqr_kernels_{_source_hash()}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [str(f) for f in _sources() if f.suffix == ".cu"]
    # compile to a private name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return ctypes.CDLL(str(build()))
