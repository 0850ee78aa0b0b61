"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit), and the least time a kernel could take
on them."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {4: 67e12, 8: 34e12}     # float32, float64 outside the tensor cores


def bound_s(nbytes: float, ops: float, size: int = 4) -> float:
    """The larger of bytes over the memory rate and operations over the
    arithmetic rate of ``size``-byte floats."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[size])
