"""``backward_pass="packed"`` on the vmap route against the JAX package
(f64, B=4; helpers and tolerances of tests/test_torch_solve.py): the
batched rule of ``make_derive_backward`` runs the SL pipeline, whose K1
takes its plain version on the CPU; the JAX rule falls back to vmapping the
per-instance path off the TPU.  Also the refusal of a ``backward_impl``
with the packed pipeline or DDP.
"""

import pytest

from iterativelqr_tpu_torch.ops.pallas_backward import make_backward_dispatch

from test_torch_solve import BASE, assert_matches, jax_solve, port_solve


@pytest.mark.parametrize("model", ["acrobot", "car"])
def test_packed_backward_matches_jax(model):
    opts = dict(BASE, backward_pass="packed")
    assert_matches(port_solve(model, opts), jax_solve(model, opts))


def test_backward_impl_refuses_packed_and_ddp():
    from iterativelqr_tpu_torch import Options, build_spec, make_solve_fn
    from iterativelqr_tpu_torch.models import acrobot

    spec = build_spec(*acrobot.problem(9)[:3])
    impl = make_backward_dispatch()
    for kw in (dict(backward_pass="packed"), dict(ddp=True)):
        with pytest.raises(ValueError, match="backward_impl"):
            make_solve_fn(spec, Options(**kw), backward_impl=impl, device="cpu")
