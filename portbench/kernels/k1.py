"""K1: the Riccati recursion on K1's template (``csrc/riccati_backward.cuh``),
where the problem's (n, m) fits it (the acrobot's (4, 1), the car's (3, 2))."""

from portbench.counts import riccati_launch as launch  # noqa: F401

ROLE = "riccati"


def match(name: str) -> bool:
    return "riccati_kernel" in name
