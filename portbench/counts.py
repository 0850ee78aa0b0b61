"""Operations and values a kernel needs, from the shapes of its call.

Copied from ``chip_smoke.py`` (``riccati_ops``, ``rollout_bytes``) and its
byte sums over each kernel's inputs and outputs: each input read once and
each output written once, whatever a kernel reads again.  ``shape`` holds
the lanes ``B``, the horizon ``T``, the dims ``n``, ``m``, the constraint
rows ``nc`` (``c_stage`` a stage, ``c_term`` at the end), per-step
parameters ``npar`` and the float ``size`` in bytes.
"""


def riccati_ops(n: int, m: int) -> int:
    """Operations a step and lane (each multiplication, addition, division
    or square root one): Qx, Qu, fx^T P, fu^T P, Qxx, Quu, Qux, the
    Cholesky and its n+1 solves, Quu K, the P and p updates and the
    symmetrization."""
    return (2 * n * n + 2 * n * m + 2 * n ** 3 + 2 * n * n * m
            + 2 * n ** 3 + n * n + 2 * n * m * m + m * m + 2 * n * n * m + n * m
            + (m ** 3) // 3 + m * m + (n + 1) * 2 * m * m + 2 * m * m * n
            + 6 * m * n * n + 3 * n * n + 2 * n * n + 6 * m * n + 3 * n)


def riccati_values(n: int, m: int, T: int) -> int:
    """Values a lane moves: in fx, fu, gx, gu, gxx, guu, gux over T-1
    steps, the terminal gxx and gx, the regularizer; out K, k, Qx, Qu, p
    over T-1 steps and the ok flag."""
    Tm1 = T - 1
    inputs = Tm1 * (n * n + n * m + n + m + n * n + m * m + m * n) + n * n + n + 1
    outputs = Tm1 * (m * n + m + n + m + n) + 1
    return inputs + outputs


def riccati_launch(shape: dict) -> tuple:
    """(bytes, operations) of one recursion launch over the shape's lanes."""
    n, m, T, B = shape["n"], shape["m"], shape["T"], shape["B"]
    return (riccati_values(n, m, T) * B * shape["size"],
            riccati_ops(n, m) * (T - 1) * B)


def rollout_values(shape: dict, nb=None) -> int:
    """Values a lane moves in K3 (``nb`` candidates: in the nominal
    trajectory, gains, parameters, duals and penalties; out J a candidate)
    or K4 (``nb`` None: the same in, the winner's alpha in; out states,
    controls, constraint values and J)."""
    T, nx, nu, npar = shape["T"], shape["n"], shape["m"], shape["npar"]
    ncs, nct, nc = shape["c_stage"], shape["c_term"], shape["nc"]
    Tm1 = T - 1
    per_lane = Tm1 * (nx + nu + npar + nu * nx + nu + 2 * ncs) + npar + 2 * nct
    if nb is not None:
        return per_lane + nb
    return per_lane + 1 + T * nx + Tm1 * nu + T * nc + 1


def rollout_launch(shape: dict, nb=None) -> tuple:
    """(bytes, operations) of one K3 (``nb`` candidates) or K4 launch;
    operations are the configuration's count a step and candidate
    (``rollout_ops_per_step``)."""
    B, T = shape["B"], shape["T"]
    return (rollout_values(shape, nb) * B * shape["size"],
            shape["rollout_ops_per_step"] * (T - 1) * B * (nb or 1))
