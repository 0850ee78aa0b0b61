"""The "auto" backward dispatch and the default single-instance solve that
the port's associative scan (iterativelqr_tpu_torch/ops/assoc.py) unlocks,
against the JAX package on the same numpy inputs in f64: equal iteration
counts, and the trajectories within 1e-10 of their largest value.

The JAX package's per-instance program and its ``jax.vmap`` can take
different iteration counts on a long, ill-conditioned acrobot solve (T=21,
x0 = 0.02 N(0,1) from seed 0, backward_pass="scan": 73 iterations
unbatched, 60 under ``jax.vmap``); the port's per-instance form runs the
batched program on one lane and takes 60 there.  The acrobot case here
(T=11, 77 iterations) is one where the port and JAX's per-instance program
agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu import make_solve_fn as jax_make_solve_fn
from iterativelqr_tpu.ops import backward as jbw
from iterativelqr_tpu_torch import Options, make_solve_fn
from iterativelqr_tpu_torch.convert import solution_to_numpy
from iterativelqr_tpu_torch.ops import backward

from test_torch_assoc import lq
from test_torch_backward import close, one_instance
from test_torch_solve import inputs

torch.set_num_threads(1)


def assert_solution_close(out, ref):
    """Equal iteration counts and statuses; the trajectory, objective,
    violation and AL state within 1e-10 (``close``), the rest (gains,
    gradient norm, traces: read off intermediate iterates) within 1e-6 of
    their largest value (tests/test_torch_solve.py's tolerances)."""
    ints = ("iterations", "al_iterations", "status", "trace_mask")
    for name in ints:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for name, b in ref.items():
        if name not in ints:
            tight = name in ("xs", "us", "objective", "max_violation", "duals", "penalty")
            close(out[name], b, 1e-10 if tight else 1e-6)



@pytest.mark.parametrize("B", [1, 3, 4])
def test_auto_dispatch_matches_jax_vmap(B):
    """backward_pass="auto" under the batched form: the associative scan at
    B <= T // 7 (T=21: B <= 3), the reverse scan above, with the
    regularization retry (lane 0 starts indefinite: reg escalates)."""
    T, n, m = 21, 4, 1
    st, um, _ = lq(7, B, T, n, m, False)
    st[5][0, 3] = -1.0e3 * np.eye(m)
    reg = np.full(B, 0.0)
    out = backward.backward_pass(*(torch.as_tensor(a) for a in st), torch.as_tensor(um),
                                 torch.as_tensor(reg), Options())
    ref = jax.jit(jax.vmap(lambda *a: jbw.backward_pass(*a[:7], um, a[7], JaxOptions())))(
        *st, reg)
    for a, b in zip(out, ref):
        close(a, b)
    assert float(out[6][0]) > 0.0
    assert backward._assoc_wins(B, T) == (B <= 3)


@pytest.mark.parametrize("model", ["acrobot", "car"])
def test_default_one_instance_solve_matches_jax(model):
    """make_solve_fn(spec, Options())(xs, us, ws) on one instance: the
    literal defaults, so the "auto" backward is the associative scan
    (acrobot T=11, 77 iterations; car T=12)."""
    if model == "acrobot":
        jspec, tspec, *args = one_instance(11)
    else:
        jspec, tspec, *batch = inputs(model)
        args = [a[2] for a in batch]
    ref = jax.jit(jax_make_solve_fn(jspec, JaxOptions()))(*(jnp.asarray(a) for a in args))
    sol = make_solve_fn(tspec, Options(), device="cpu")(*(torch.as_tensor(a) for a in args))
    out = solution_to_numpy(sol)
    assert_solution_close(out, {k: np.asarray(v) for k, v in vars(ref).items()})
    assert out["max_violation"] <= 5e-3


