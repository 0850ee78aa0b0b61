"""KD: the derive kernel (``csrc/sl_derive.cuh``): the stage functions'
Jacobians, gradients and Hessians at every (lane, stage) of a batch in one
launch, from generated programs.  Its bound is bytes: it reads the states,
controls and parameters and writes the stacks the AL augmentation reads,
each value once; its arithmetic counts no operations."""

ROLE = "derive"


def match(name: str) -> bool:
    return "sl_derive_kernel" in name


def launch(shape: dict) -> tuple:
    """(bytes, operations) of one launch: a lane reads (T-1)(n + m + npar)
    + n + npar values and writes fx, fu, gu, guu, gux and cu over T-1
    stages and gx, gxx and cx over T (the terminal row included), padded
    constraint rows too."""
    n, m, T, B = shape["n"], shape["m"], shape["T"], shape["B"]
    npar, nc = shape["npar"], shape["nc"]
    read = (T - 1) * (n + m + npar) + n + npar
    written = (T - 1) * (n * n + n * m + m + m * m + m * n + nc * m) + T * (n + n * n + nc * n)
    return (read + written) * B * shape["size"], 0
