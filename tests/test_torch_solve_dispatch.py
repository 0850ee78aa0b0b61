"""The vmap route with a ``backward_impl`` against the JAX package, f64,
B=4: the K6a/K6b dispatch (``make_backward_dispatch``, against the JAX one
in interpret mode), and a plain user function with no batching rule
(mapped over lanes with torch.func.vmap, as jax.vmap maps it).
Tolerances as tests/test_torch_solve.py.
"""

import pytest

from iterativelqr_tpu.ops.backward import backward_pass_scan as jax_scan
from iterativelqr_tpu.ops.pallas_backward import make_backward_dispatch as jax_dispatch
from iterativelqr_tpu_torch.ops.backward import backward_pass_scan
from iterativelqr_tpu_torch.ops.pallas_backward import make_backward_dispatch

from test_torch_solve import BASE, assert_matches, jax_solve, port_solve

SCAN = dict(BASE, backward_pass="scan")


@pytest.mark.parametrize("model", ["acrobot", "car"])
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_masked_kernel_dispatch_matches_jax(model, variant):
    out = port_solve(model, SCAN, backward_impl=make_backward_dispatch(variant=variant))
    ref = jax_solve(model, SCAN, backward_impl=jax_dispatch(
        interpret=True, block_b=128, variant=variant))
    assert_matches(out, ref)


def test_dispatch_offers_the_jax_variants_only():
    """v1 (K6a) and v2 (K6b), as the JAX dispatch; K5 has no dispatch."""
    with pytest.raises(ValueError, match="unknown variant 'v3'"):
        make_backward_dispatch(variant="v3")


def test_plain_function_is_mapped_over_lanes():
    """A backward_impl with no batching rule."""
    impl = lambda *a: backward_pass_scan(*a)            # noqa: E731
    out = port_solve("acrobot", SCAN, backward_impl=impl)
    assert_matches(out, jax_solve("acrobot", SCAN, backward_impl=lambda *a: jax_scan(*a)))
