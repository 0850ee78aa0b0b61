"""K2: the Riccati recursion on K2's template (``csrc/riccati_backward_wide.cuh``)
and, past n + m = 32, the tall one (``csrc/riccati_backward_tall.cuh``):
K1's inputs, outputs and arithmetic, for dims K1's template does not fit
(such as a quadrotor's (12, 4))."""

from portbench.counts import riccati_launch as launch  # noqa: F401

ROLE = "riccati"


def match(name: str) -> bool:
    return "riccati_wide_kernel" in name or "riccati_tall_kernel" in name
