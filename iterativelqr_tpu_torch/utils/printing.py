"""Host-side presentation: banner, live progress line, per-iteration table.

Counterpart of ``iterativelqr_tpu/utils/printing.py`` (its citations of the
reference live there).  The solve returns trace tensors (cost, gradient
norm, violation and step size per inner iteration) and the table is
rendered from them after the solve; ``live_progress_line`` is the one line
a solve with ``Options.live_progress`` prints while it runs.
"""

from __future__ import annotations

_BANNER = r"""
 ┌─────────────────────────────────────────────────────────┐
 │  iterativelqr-tpu — constrained iLQR / AL-iLQR          │
 │  PyTorch · CUDA                                         │
 └─────────────────────────────────────────────────────────┘
"""


def solver_info():
    print(_BANNER)


def live_progress_line(al_it, inner_it, J, grad_norm, viol):
    """One in-flight progress line of an AL round (values are scalars or
    0-d tensors on the host)."""
    print(
        f"  [al {int(al_it):>2}] inner {int(inner_it):>4}  "
        f"J {float(J):>13.6e}  |grad| {float(grad_norm):>10.4e}  "
        f"viol {float(viol):>10.4e}",
        flush=True,
    )


def print_solution(sol):
    tm, tc, tg, tv, ts = (a.detach().cpu().numpy() for a in (
        sol.trace_mask, sol.trace_cost, sol.trace_gradient_norm,
        sol.trace_violation, sol.trace_step_size))
    header = f"{'al':>3} {'iter':>5} {'objective':>14} {'|grad|_inf':>12} {'viol':>12} {'step':>9}"
    print(header)
    print("-" * len(header))
    for a in range(tm.shape[0]):
        for i in range(tm.shape[1]):
            if tm[a, i]:
                print(
                    f"{a:>3} {i:>5} {tc[a, i]:>14.6e} {tg[a, i]:>12.4e} "
                    f"{tv[a, i]:>12.4e} {ts[a, i]:>9.2e}"
                )
    print(
        f"\n  objective:      {float(sol.objective):.6e}"
        f"\n  gradient norm:  {float(sol.gradient_norm):.4e}"
        f"\n  max violation:  {float(sol.max_violation):.4e}"
        f"\n  iterations:     {int(sol.iterations)} inner / {int(sol.al_iterations)} dual updates"
    )
