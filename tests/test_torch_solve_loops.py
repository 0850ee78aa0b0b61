"""The vmap route's loop structure against the JAX package (f64, B=4; the
helpers and tolerances of tests/test_torch_solve.py): the nested AL loop,
with and without capped rounds and a total budget, a dual warm start, and a
user callback in the fused and nested loops.
"""

import numpy as np
import pytest

from iterativelqr_tpu import CallbackState as JaxCallbackState
from iterativelqr_tpu_torch import CallbackState

from test_torch_solve import BASE, assert_matches, jax_solve, port_solve


def test_nested_loop_matches_jax():
    opts = dict(BASE, fused_al_loop=False)
    assert_matches(port_solve("acrobot", opts), jax_solve("acrobot", opts))


def test_nested_loop_with_cap_and_budget_matches_jax():
    """The nested loop's capped rounds, progress gate and total budget."""
    opts = dict(BASE, fused_al_loop=False, early_round_iteration_cap=3,
                initial_constraint_penalty=1000.0, max_penalty=1e5,
                max_total_iterations=20)
    assert_matches(port_solve("car", opts), jax_solve("car", opts))


def test_dual_warm_start_matches_jax():
    """Carried duals and penalties (MPC re-solves) from a cold solve."""
    cold = port_solve("car", BASE)
    opts = dict(BASE, max_total_iterations=6)
    warm = (cold["duals"], cold["penalty"])
    out = port_solve("car", opts, *warm, dual_warm_start=True)
    assert (out["iterations"] == 6).any()
    assert_matches(out, jax_solve("car", opts, *warm, dual_warm_start=True))


@pytest.mark.parametrize("fused", [True, False])
def test_callback_matches_jax(fused):
    """A continuation callback (halves the controls' penalty growth by
    scaling the penalty and nudges the duals) applied at each lane's own
    round boundaries; the batched form maps it with torch.func.vmap."""
    def cb_port(s):
        return CallbackState(xs=s.xs, us=s.us, ws=s.ws, duals=0.5 * s.duals,
                             penalty=s.penalty * 0.5 + 1.0, al_iteration=s.al_iteration)

    def cb_jax(s):
        return JaxCallbackState(xs=s.xs, us=s.us, ws=s.ws, duals=0.5 * s.duals,
                                penalty=s.penalty * 0.5 + 1.0, al_iteration=s.al_iteration)

    opts = dict(BASE, fused_al_loop=fused)
    out = port_solve("acrobot", opts, callback=cb_port)
    assert_matches(out, jax_solve("acrobot", opts, callback=cb_jax))
    assert not np.array_equal(out["penalty"], port_solve("acrobot", opts)["penalty"])
