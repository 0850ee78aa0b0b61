"""The port's entry points (iterativelqr_tpu_torch/entry.py) against
__graft_entry__.py: ``entry()``'s program and arguments, its solve against
the JAX package's, and ``dryrun_multichip`` over four CPU entries.

A per-instance acrobot solve at entry()'s T=51 takes minutes on this CPU,
so the same program (``acrobot_program``) is held to JAX at T=9 in
f64.  There it is held to JAX's ``jax.vmap(make_solve_fn)`` on one
instance: the port's per-instance solver runs its batched program on one
lane and follows JAX's vmap form, which differs from JAX's unbatched
program by rounding on this long ill-conditioned solve (164 iterations;
ROADMAP, Queue 3's reference behaviours)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iterativelqr_tpu_torch import entry as port_entry

import __graft_entry__ as jax_entry
from iterativelqr_tpu import Options as JOptions
from iterativelqr_tpu.core.solve import make_solve_fn as jmake_solve_fn
from iterativelqr_tpu.core.spec import build_spec as jbuild_spec
from iterativelqr_tpu.models import acrobot as jacrobot

torch.set_num_threads(1)


def test_entry_matches_jax_entry_arguments():
    fn, args = port_entry.entry(device="cpu")
    _, jargs = jax_entry.entry()
    assert callable(fn)
    for a, j in zip(args, jargs):
        assert tuple(a.shape) == tuple(j.shape) and a.device.type == "cpu"
        assert a.dtype == torch.float32 and j.dtype == jnp.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))


def test_entry_program_solve_matches_jax():
    T = 9
    fn, args = port_entry.acrobot_program(T, "cpu", torch.float64)
    sol = fn(*args)
    jsolve = jax.jit(jax.vmap(jmake_solve_fn(jbuild_spec(*jacrobot.problem(T)[:3]),
                                             JOptions(verbose=False))))
    jsol = jsolve(*(jnp.asarray(a.numpy())[None] for a in args))
    assert int(sol.iterations) == int(jsol.iterations[0])
    np.testing.assert_allclose(float(sol.objective), float(jsol.objective[0]), rtol=1e-8)
    assert float(sol.max_violation) <= 5e-3


def test_dryrun_multichip_cpu():
    port_entry.dryrun_multichip(4, device="cpu")
