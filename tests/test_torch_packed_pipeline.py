"""Port derive -> backward -> slope (iterativelqr_tpu_torch/ops/
packed_pipeline.py) against the JAX package's ``make_derive_backward_sl``
with its Pallas kernel in interpret mode, on acrobot in f64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import acrobot as jax_acrobot
from iterativelqr_tpu.ops.derivatives import constraint_values as jax_cv
from iterativelqr_tpu.ops.packed_pipeline import (
    make_derive_backward_sl as jax_make_derive,
)
from iterativelqr_tpu.ops.sl_ops import to_sl as jax_to_sl
from iterativelqr_tpu_torch import build_spec
from iterativelqr_tpu_torch.convert import options_from_fields
from iterativelqr_tpu_torch.models import acrobot
from iterativelqr_tpu_torch.ops import packed_backward as pk
from iterativelqr_tpu_torch.ops.packed_pipeline import make_derive_backward_sl

torch.set_num_threads(1)

T, B = 9, 1024   # the JAX SL kernel takes lanes in blocks of 1024


@pytest.mark.parametrize("case", ["plain", "reg_retry"])
def test_derive_backward_matches_jax(case):
    rng = np.random.default_rng(4)
    jspec = jax_build_spec(*jax_acrobot.problem(T)[:3])
    tspec = build_spec(*acrobot.problem(T)[:3])
    xs = 0.5 * rng.standard_normal((B, T, 4))
    us = 0.5 * rng.standard_normal((B, T - 1, 1))
    ws = np.zeros((B, T, 0))
    duals = 0.1 * rng.standard_normal((B, T, 4))
    penalty = np.full((B, T, 4), 10.0)
    c = np.asarray(jax.vmap(lambda x, u, w: jax_cv(jspec, x, u, w))(
        jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ws)))
    reg = np.zeros(B)
    if case == "reg_retry":
        # a negative reg makes Quu + reg indefinite on these lanes: the
        # batch-wide retry loop must raise their reg while the ok lanes
        # re-run with their own
        reg[:5] = -1.0e3
        reg[5:9] = 1.0e-3
    jo = JaxOptions(record_traces=False)

    jargs = [jax_to_sl(jnp.asarray(a), B // 128) for a in (xs, us, ws, duals, penalty, c)]
    ref = jax_make_derive(jspec, jo, interpret=True)(
        *jargs, jnp.asarray(reg).reshape(B // 128, 128))
    ref = [np.asarray(r).reshape(r.shape[:-2] + (B,)) for r in ref]

    derive = make_derive_backward_sl(
        tspec, options_from_fields(dataclasses.asdict(jo))
    )
    bl = lambda a: torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))
    before = pk.RICCATI_LAUNCHES.launches
    out = derive(*(bl(a) for a in (xs, us, ws, duals, penalty, c)),
                 torch.as_tensor(reg))
    assert pk.RICCATI_LAUNCHES.launches == before   # CPU: plain version only
    for name, a, b in zip(["K", "k", "slope", "grad_norm", "reg_next"], ref, out):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    if case == "reg_retry":
        # without the retry these lanes' gains would be NaN
        assert torch.isfinite(out[0][..., :5]).all()


def test_invalid_lanes_never_hold_the_retry_open():
    """Lanes outside ``valid`` are excluded from the retry's all(ok) test:
    an indefinite invalid lane gets no retry (its gains stay NaN) while the
    valid lanes finish in one kernel run."""
    tspec = build_spec(*acrobot.problem(T)[:3])
    rng = np.random.default_rng(9)
    b = 16
    t = lambda a: torch.as_tensor(a)
    xs = t(0.5 * rng.standard_normal((T, 4, b)))
    us = t(0.5 * rng.standard_normal((T - 1, 1, b)))
    ws = torch.zeros((T, 0, b), dtype=torch.float64)
    duals = torch.zeros((T, 4, b), dtype=torch.float64)
    penalty = torch.full((T, 4, b), 10.0, dtype=torch.float64)
    c = torch.zeros((T, 4, b), dtype=torch.float64)
    reg = torch.zeros(b, dtype=torch.float64)
    reg[:3] = -1.0e3
    valid = torch.ones(b, dtype=torch.bool)
    valid[:3] = False
    derive = make_derive_backward_sl(tspec, options_from_fields(
        dataclasses.asdict(JaxOptions(record_traces=False))))
    K, *_ = derive(xs, us, ws, duals, penalty, c, reg, valid=valid)
    assert torch.isnan(K[..., :3]).all()
    assert torch.isfinite(K[..., 3:]).all()
