"""The kernel bounds against those PERF.md's kernel table records at
B=4096 (bytes at 3.35 TB/s, operations at 67 TFLOP/s, the larger)."""

import pytest

from portbench import catalog, peaks

ACROBOT = dict(n=4, m=1, T=101, B=4096, size=4, npar=0, c_stage=0, c_term=4, nc=4,
               rollout_ops_per_step=catalog.config("acrobot_T101")["rollout_ops_per_step"])
# the quadrotor (12, 4), T=41 of chip_smoke.py's cell, where K2 was timed
QUAD = dict(n=12, m=4, T=41, B=4096, size=4)
KERNELS = {k.__name__.rsplit("_", 1)[-1]: k for k in catalog.kernels()}


@pytest.mark.parametrize("name, shape, args, ms", [
    ("k1", ACROBOT, (), 0.0295), ("k2", QUAD, (), 0.0978),
    ("k3", ACROBOT, (8,), 0.0139), ("k4", ACROBOT, (), 0.0094)])
def test_bound_at_the_recorded_shapes(name, shape, args, ms):
    k = KERNELS[name]
    assert round(peaks.bound_s(*k.launch(shape, *args), 4) * 1e3, 4) == ms


def test_names_select_one_kernel_each():
    names = {"k1": "void riccati_kernel<4, 1, float, SevenArrays<float>, NoMask>(...)",
             "k2": "void riccati_wide_kernel<12, 4, float, SevenArrays<float>, NoMask>(...)",
             "k3": "void sl_rollout_kernel<Acrobot, 1, float, Score<1, float> >(...)",
             "k4": "void sl_rollout_kernel<Acrobot, 1, float, Reroll<1, float> >(...)"}
    for name, symbol in names.items():
        assert [n for n, k in KERNELS.items() if k.match(symbol)] == [name]
    assert KERNELS["k2"].match("void riccati_tall_kernel<36, 12, float>(...)")
