"""The derive kernel's bound (``kernels/kd.py``): bytes at 3.35 TB/s, no
operations, at car.sweep's shape, and its name selects the kernel alone."""

from portbench import catalog, peaks

CAR = dict(n=3, m=2, T=51, B=131072, size=4, npar=0, c_stage=5, c_term=3, nc=5)


def _kd():
    return {k.__name__.rsplit("_", 1)[-1]: k for k in catalog.kernels()}["kd"]


def test_bound_at_the_car_sweep():
    kd = _kd()
    nbytes, ops = kd.launch(CAR)
    # 3,480 values a lane: 253 read, 3,227 written
    assert nbytes == 3480 * 131072 * 4 and ops == 0
    assert round(peaks.bound_s(nbytes, ops, 4) * 1e3, 4) == 0.5446


def test_name_selects_the_derive_kernel_alone():
    names = {"kd": "void (anonymous namespace)::sl_derive_kernel<sl_models::Derive_c248b2c9948571d7,"
                   " float>(float const*, float const*, float const*, DeriveStacks<float>, int, int)",
             "k3": "void sl_rollout_kernel<Car, 1, float, Score<1, float> >(...)",
             "k1": "void riccati_kernel<3, 2, float, SevenArrays<float>, NoMask>(...)"}
    for name, symbol in names.items():
        hits = [k.__name__.rsplit("_", 1)[-1] for k in catalog.kernels() if k.match(symbol)]
        assert hits == [name], (name, hits)
    assert _kd().ROLE == "derive"
