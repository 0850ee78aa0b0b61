"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison, the result.

``run`` is what ``python3 -m portbench.run`` calls once it has found the
cards; the CPU tests call it with ``device="cpu"`` at tiny sizes.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time

import torch

from portbench import catalog, inputs, judge, streams, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "iterativelqr_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit(device) -> str:
    """The card's power limit as ``nvidia-smi`` reads it (a card may run
    below its 700 W maximum, and slower), or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                              "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip()


def shape_of(config, ref, B) -> dict:
    """What the kernel bounds read of a cell."""
    cmask = ref.cmask
    return {"n": ref.nx, "m": ref.nu, "T": config["T"], "B": B, "nc": ref.nc,
            "c_stage": int(cmask[0].sum()), "c_term": int(cmask[-1].sum()), "npar": 0,
            "size": torch.finfo(inputs.DTYPES[config["dtype"]]).bits // 8,
            "rollout_ops_per_step": config["rollout_ops_per_step"],
            "candidates": config["candidates"]}


def compare(config, ref, window, control=False) -> tuple:
    """(numbers, solved, attempted) of every answer in the window, or of
    the control put in the program's place."""
    tol = config["options"]["constraint_tolerance"]
    numbers, solved, attempted = {}, 0, 0
    def worst(name, v):
        v = float("inf") if math.isnan(v) else v      # a NaN reading fails every limit
        numbers[name] = max(numbers.get(name, 0.0), v)

    for rec in window["answers"]:
        a = rec["answers"]
        if control:
            a = judge.control_answers(ref, a)
        got = judge.trajectory_numbers(ref, tol, rec["start"], a)
        solved, attempted = solved + got.pop("solved"), attempted + got.pop("attempted")
        for k, v in got.items():
            worst(k, v)
        worst("gain_gap", judge.gains_number(config, ref, a, control))
    numbers["unsolved_share"] = 1.0 - solved / attempted
    return numbers, solved, attempted


def run(bench, workload, seed, seconds, traced, device, t_start, control=False):
    """(the result of one run, what else it learned).  The result's last
    key, ``checks``, holds each compared number with its limit; with
    ``control`` the second holds the control's numbers (``control``) and
    whether they pass the same limits (``control_correct``)."""
    cell = catalog.cell(bench, workload)
    config = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    checks = catalog.checks(workload)
    device = torch.device(device)
    dtype = inputs.DTYPES[config["dtype"]]
    parts, mark = {}, [t_start]

    def phase(name):
        now = time.perf_counter()
        parts[name], mark[0] = now - mark[0], now

    phase("imports")
    if device.type == "cuda":
        torch.zeros(1, device=device)
        phase("cuda_init")
    stream = streams.make(config, traffic, checks["gain_lanes"], device, dtype)
    phase("solvers")
    stream.setup(seed)
    phase("warm_up")
    setup_s = mark[0] - t_start

    window = stream.window(seed, seconds)
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
           "power_limit": power_limit(device) if cuda else "none"}
    B = window["answers"][0]["answers"].xs.shape[0]
    t_judge = time.perf_counter()
    numbers, solved, attempted = compare(config, stream.ref, window)
    judge_s = time.perf_counter() - t_judge

    span = window["span"]
    end_to_end = {"setup_s": setup_s, "solves_per_s": solved / span}
    metrics = {}
    breakdown = None
    if traced:
        events, trips = stream.profile(seed, len(window["answers"]))
        busy_us, window_us, _ = trace.busy(events)
        dev.update(busy_s=busy_us / 1e6, window_s=window_us / 1e6)
        breakdown = trace.breakdown(events)
        ctx = {"config": config, "traffic": traffic, "shape": shape_of(config, stream.ref, B),
               "window": window, "events": events, "trace_trips": trips}
        for m in catalog.metrics_of(bench, "per_layer", workload):
            value = catalog.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in catalog.metrics_of(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": end_to_end[m["name"]], "unit": m["unit"]}

    limits = checks["limits"]
    compared = {k: [numbers[k], limits[k]] for k in limits}
    result = {"correct": all(v <= lim for v, lim in compared.values()),
              "attempted": attempted, "failed": attempted - solved,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    info = {"workload": workload, "seed": seed, "answers": len(window["answers"]),
            "span_s": span, "trips": window["trips"], "setup_s": setup_s, "judge_s": judge_s,
            "setup_parts": parts,
            "durations": [[round(r["t1"] - r["t0"], 4), r["trips"]] for r in window["answers"]],
            "total_s": time.perf_counter() - t_start, "numbers": numbers}
    if control:
        numbers = compare(config, stream.ref, window, control=True)[0]
        info["control"] = numbers
        info["control_correct"] = all(numbers[k] <= lim for k, lim in limits.items())
    return result, info
