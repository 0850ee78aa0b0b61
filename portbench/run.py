"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``iterativelqr_tpu_torch/``).  Loads and warms up (set-up),
measures whole batches for ``--seconds``, with ``--trace 1``
profiles a short sub-window after it, compares every answer with the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number and its limit,
also the last lines on standard error).  Without as many cards as the cell
asks for it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
# every cache the program or its libraries may keep, at fixed paths inside
# the checkout, so that only a checkout's first run builds
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)

    from portbench import catalog, harness

    bench = catalog.load_benchmark(ROOT)
    cell = catalog.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, info = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(info), file=sys.stderr)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
