"""The port imports torch and never jax or the JAX package, and imports on a
machine without nvcc (the kernels build at first use)."""

import pathlib
import subprocess
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import iterativelqr_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "iterativelqr_tpu."))
             or n == "iterativelqr_tpu")
assert not bad, bad
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
print("ok")
"""


def test_port_imports_no_jax():
    # a fresh interpreter: conftest has already imported jax in this one
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=_ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_sources_name_no_jax():
    pkg = _ROOT / "iterativelqr_tpu_torch"
    for f in sorted(pkg.rglob("*.py")):
        text = f.read_text(encoding="utf-8")
        for line in text.splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, line)
            assert not s.startswith(("import iterativelqr_tpu ",
                                     "from iterativelqr_tpu ",
                                     "from iterativelqr_tpu.")), (f, line)
