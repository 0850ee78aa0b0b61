"""Share of its roofline the Riccati kernel reaches (K1 where its template
fits the dims, as the car's (3, 2), K2 elsewhere;
``csrc/riccati_backward*.cuh``): the least time of its
launches in the traced trips at the published peaks
(``kernels/<kernel>.py`` with ROLE "riccati") over their device time."""

from portbench import catalog, trace
from portbench.peaks import bound_s


def read(ctx):
    if ctx["traffic"]["kind"] != "sweep":
        return None
    bound = spent = 0.0
    for k in catalog.kernels():
        if k.ROLE != "riccati":
            continue
        n, us = trace.kernel_us(ctx["events"], k.match)
        if n:
            bound += n * bound_s(*k.launch(ctx["shape"]), ctx["shape"]["size"])
            spent += us / 1e6
    return 100.0 * bound / spent if spent else None
