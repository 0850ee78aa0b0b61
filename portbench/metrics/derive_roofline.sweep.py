"""Share of its roofline the derive kernel reaches (``csrc/sl_derive.cuh``,
``ops/derive_kernel.py``): the least time of its launches in the traced
trips at the published peaks (``kernels/kd.py``, ROLE "derive") over their
device time.  Nothing to read where no launch matches (a checkout whose
derive is the torch.func stacks)."""

from portbench import catalog, trace
from portbench.peaks import bound_s


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep":
        return None
    bound = spent = 0.0
    for k in catalog.kernels():
        if k.ROLE != "derive":
            continue
        n, us = trace.kernel_us(ctx["events"], k.match)
        if n:
            bound += n * bound_s(*k.launch(ctx["shape"]), ctx["shape"]["size"])
            spent += us / 1e6
    return 100.0 * bound / spent if spent else None
