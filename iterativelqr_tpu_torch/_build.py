"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` (``*.cu``: the rollout kernels K3/K4 of the
registered models) are compiled with ``nvcc`` for Hopper (``sm_90a``), one
process per source started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``iterativelqr_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed on a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import:
``load_library`` runs the first time a CUDA tensor reaches a kernel, so
the package imports on a machine without ``nvcc``.

Translation units written at run time are built by ``build_generated``,
each into a library of its own keyed on a hash of its text, ``csrc/``'s
sources and headers and the flags, at first use (when the solver that
runs it starts on the card): a generated device model
(``ops/device_functions.py``, K3/K4 on a user's stage functions) and the
backward recursion at one (n, m, dtype) (``ops/packed_backward.py::
RiccatiPlan.source``: K1 or K2, K5, K6a, K6b from the template headers).
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

from .utils import profiling

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v only reports each kernel's registers, shared memory and spills
# (kept in the build log, ``ptxas_report``); it does not change the code
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-c",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


def _sources():
    """Every source and header under ``csrc/``: an edited header changes the
    hash too."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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


def _log_path() -> Path:
    return library_path().with_suffix(".log")


def _run(cmds):
    """Start every command at once, wait for all; raise on the first that
    failed.  Returns each command's output.  The wait adds to the counter
    ``build.nvcc_s``."""
    outs, failed = [], None
    with profiling.timer("build.nvcc_s"):
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in cmds]
        for cmd, proc in procs:
            out, _ = proc.communicate()
            outs.append(out)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, out)
    if failed:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build in a private directory, then rename: a concurrent loader never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for src in (f for f in _sources() if f.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *COMPILE_FLAGS, "-o", obj, str(src)])
        log = "".join(_run(cmds))
        lib = os.path.join(tmp, out.name)
        log += "".join(_run([[nvcc, *LINK_FLAGS, "-o", lib, *objs]]))
        Path(tmp, "build.log").write_text(log)
        os.replace(os.path.join(tmp, "build.log"), _log_path())
        os.replace(lib, out)
    return out


def generated_library_path(source: str) -> Path:
    """Where the library of a generated translation unit goes."""
    h = hashlib.sha256(source.encode())
    h.update(_source_hash().encode())
    return BUILD_DIR / f"libilqr_gen_{h.hexdigest()[:16]}.so"


def build_generated(*sources: str) -> list:
    """Compile each generated translation unit (its text; it includes
    headers from ``csrc/``) into a library of its own unless it exists: one
    nvcc per source, all started together, then the links.  Returns the
    libraries' paths; raises with nvcc's log when one fails."""
    outs = [generated_library_path(src) for src in sources]
    todo = {out: src for out, src in zip(outs, sources) if not out.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # in a private directory, then renamed, as build()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compiles, links = [], []
        for out, src in todo.items():
            cu = Path(tmp, out.stem + ".cu")
            cu.write_text(src)
            obj = str(cu.with_suffix(".o"))
            compiles.append([nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-o", obj, str(cu)])
            links.append([nvcc, *LINK_FLAGS, "-o", str(Path(tmp, out.name)), obj])
        logs = _run(compiles)
        _run(links)
        for out, log in zip(todo, logs):
            Path(tmp, out.stem + ".log").write_text(log)
            os.replace(Path(tmp, out.stem + ".log"), out.with_suffix(".log"))
            os.replace(Path(tmp, out.name), out)
    return outs


def _load(path: Path) -> ctypes.CDLL:
    """Load a built library; the seconds add to the counter ``build.load_s``."""
    with profiling.timer("build.load_s"):
        return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def load_generated(source: str) -> ctypes.CDLL:
    """Build (if needed) and load a generated translation unit's library,
    once per process."""
    return _load(build_generated(source)[0])


def _demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        cand = Path(find_nvcc()).parent / "cu++filt"
        tool = str(cand) if cand.exists() else None
    if tool is None or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def ptxas_report(log: Path = None) -> list:
    """One line per compiled kernel from a build log (the kernel library's,
    or a generated library's ``.log``): its name, the registers it uses and
    the bytes it spills."""
    log = _log_path() if log is None else log
    if not log.exists():
        return []
    names, regs, spills, props = [], {}, {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            names.append(ln.split("'")[1])
        elif "Function properties for" in ln:
            props = ln.split("Function properties for", 1)[1].strip()
        elif names and "spill stores" in ln and props == names[-1]:
            spills[names[-1]] = ln.strip()
        elif names and "Used" in ln and "registers" in ln:
            regs[names[-1]] = ln.split("Used", 1)[1].split(",")[0].strip()
    lines = []
    for n, p in zip(names, _demangle(names)):
        p = p.replace("void (anonymous namespace)::", "")
        p = p[:p.find(">(") + 1] if ">(" in p else p    # drop the arguments
        lines.append(f"{p}: {regs.get(n, '?')}; {spills.get(n, 'no spill line')}")
    return lines


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return _load(build())
