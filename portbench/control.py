"""The readings that the comparison's limits are set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds <s>
        [--fault unchanged|half|altered_state] [--out FILE]

runs the cell's window once a seed in one process, on the card, and prints
for each seed a JSON line with the numbers the comparison reads of the
program's answers (``program``, judged ``correct``) and of the control
(``control``, judged ``control_correct`` by the same limits): the reference
put in the program's place at TF32, that is, the program's answers
rounded to TF32 and the gains' recursion worked out again at TF32.  It
exits 1 where the control comes out correct on a seed, or, with
``--fault``, where the program does.  ``--fault`` plants one fault in the
timed path underneath the entry first:

* ``unchanged``: every line search returns its state unchanged;
* ``half``: each solve solves the first half of its lanes and returns that
  half twice;
* ``altered_state``: the winner re-roll (K4) returns one state of one lane
  moved by 1e-3.

The benchmark's own runs never plant a fault and never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

FAULTS = ("unchanged", "half", "altered_state")


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted under its entry (None: as is)."""
    from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
    from iterativelqr_tpu_torch.ops.sl_ops import SLOps

    from portbench import port

    saved = []

    def patch(owner, name, make):
        old = getattr(owner, name)
        saved.append((owner, name, old))
        setattr(owner, name, make(old))

    if fault == "unchanged":
        def line_search(old):
            def run(self, xbar, ubar, ws, K, k, slope, J_prev, c_prev, *rest, **kw):
                B = xbar.shape[-1]
                ok = torch.ones(B, dtype=torch.bool, device=xbar.device)
                return xbar, ubar, J_prev, c_prev, ok, xbar.new_ones(B)
            return run
        patch(SLOps, "line_search", line_search)
    elif fault == "half":
        def entry(old):
            def make(*a, **kw):
                solve = old(*a, **kw)

                def run(*args):
                    half = args[0].shape[0] // 2
                    sol = solve(*(x[:half] for x in args))
                    for f in vars(sol):
                        v = getattr(sol, f)
                        if torch.is_tensor(v) and v.dim() and v.shape[0] == half:
                            setattr(sol, f, torch.cat([v, v]))
                    return sol
                return run
            return make
        patch(port, "make_batched_solve_fn", entry)
    elif fault == "altered_state":
        def alter(old):
            def run(*args, **kw):
                xs, *rest = old(*args, **kw)
                xs = xs.clone()
                xs[xs.shape[0] // 2, 0, 0] += 1e-3
                return (xs, *rest)
            return run
        patch(fk, "winner_reroll", alter)
        patch(fk, "winner_reroll_reference", alter)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


def readings(bench, workload, seeds, seconds, fault=None, device="cuda"):
    """For each seed: the program's numbers and ``correct``, the control's
    numbers and ``control_correct``."""
    from portbench import harness

    out = []
    with planted(fault):
        for seed in seeds:
            result, info = harness.run(bench, workload, seed, seconds, False, device,
                                       time.perf_counter(), control=True)
            out.append({"seed": seed, "fault": fault, "correct": result["correct"],
                        "program": {k: v for k, (v, _) in result["checks"].items()},
                        "control": info["control"],
                        "control_correct": info["control_correct"], "answers": info["answers"],
                        "failed": result["failed"], "attempted": result["attempted"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from pathlib import Path

    from portbench import catalog

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = catalog.load_benchmark(Path.cwd())
    seeds = [int(s) for s in args.seeds.split(",")]
    separated = True
    for rec in readings(bench, args.workload, seeds, args.seconds, args.fault):
        line = json.dumps({"workload": args.workload, **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        separated &= not rec["control_correct"] and not (args.fault and rec["correct"])
    if not separated:
        print("portbench.control: a control or fault came out correct", file=sys.stderr)
    return 0 if separated else 1


if __name__ == "__main__":
    sys.exit(main())
