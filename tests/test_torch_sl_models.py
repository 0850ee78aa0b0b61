"""The plain versions of the rollout kernels K3/K4 for the three models
that gained device functions (particle, pendulum, cartpole;
csrc/sl_model_{particle,pendulum,cartpole}.cuh) and of K1 at their
(n, m) = (2, 1), against the JAX package's Pallas kernels
(``_score_kernel``, ``_reroll_kernel``, ``_kernel_mr``) in interpret mode,
one small case each, in f64 to 1e-10 relative to the largest value.

On the CPU the port's wrappers run these plain versions; the CUDA kernels
are held against them on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu.core.spec import build_spec as jax_build_spec
from iterativelqr_tpu.models import cartpole as jax_cartpole
from iterativelqr_tpu.models import particle as jax_particle
from iterativelqr_tpu.models import pendulum as jax_pendulum
from iterativelqr_tpu.ops import sl_forward_kernel as jfk
from iterativelqr_tpu_torch import build_spec
from iterativelqr_tpu_torch.models import cartpole, particle, pendulum
from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk
from test_torch_backward import close
from test_torch_packed_backward import _batch_last, _jax_multiref, _port_multiref, _stacks

torch.set_num_threads(1)

T, B = 7, 128
_MODELS = {"particle": (jax_particle, particle), "pendulum": (jax_pendulum, pendulum),
           "cartpole": (jax_cartpole, cartpole)}


def _live(name):
    """(JAX spec, port spec, batch-last live arrays): states rolled out by
    the port's plain re-roll from random controls, random non-converged
    gains, duals with lam = 0 on half the lanes, and for cartpole controls
    past the limit on some lanes (active rows)."""
    jmod, tmod = _MODELS[name]
    jspec = jax_build_spec(*jmod.problem(T)[:3])
    tspec = build_spec(*tmod.problem(T, device="cpu")[:3])
    r = fk.Rollouts(tspec, "cpu")
    rng = np.random.default_rng(7)
    nx, nu, nc = tspec.nx, tspec.nu, tspec.nc
    x0 = 0.3 * rng.standard_normal((nx, B))
    ubar = rng.standard_normal((T - 1, nu, B))
    if name == "cartpole":
        ubar[:, 0, 1::5] = 10.5
        ubar[:, 0, 2::7] = -10.5
    K = 0.1 * rng.standard_normal((T - 1, nu, nx, B))
    k = rng.standard_normal((T - 1, nu, B))
    duals = np.abs(0.5 * rng.standard_normal((T, nc, B))) * (rng.uniform(size=B) < 0.5)
    penalty = 10.0 * rng.uniform(0.5, 2.0, (T, nc, B))
    t = torch.as_tensor
    ws = torch.zeros((T, 0, B), dtype=torch.float64)
    xbar0 = torch.zeros((T, nx, B), dtype=torch.float64)
    xbar0[0] = t(x0)
    xbar = fk.winner_reroll_reference(
        r, torch.zeros(B, dtype=torch.float64), xbar0, t(ubar), ws, t(0 * K), t(0 * k),
        t(duals), t(penalty))[0]
    return jspec, r, [xbar.numpy(), ubar, ws.numpy(), K, k, duals, penalty]


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_plain_rollouts_match_jax_kernels(name):
    """K3's plain version (the 8-candidate head) and K4's (per-lane alpha
    = 2^-j) against JAX's score and re-roll kernels."""
    jspec, r, live = _live(name)
    assert r.model is not None and r.model.name == name
    sl = lambda a: jnp.asarray(a.reshape(a.shape[:-1] + (B // 128, 128)))
    unsl = lambda a: np.asarray(a).reshape(a.shape[:-2] + (B,))
    jopts = JaxOptions(forward_kernel="pallas", record_traces=False)
    alphas = tuple(0.5 ** j for j in range(8))
    J = fk.score_rollout(r, 0, 8, *(torch.as_tensor(a) for a in live))
    ref = jfk.make_score_rollout(jspec, jopts, alphas, interpret=True)(*(sl(a) for a in live))
    close(J, unsl(ref))
    j = np.random.default_rng(8).integers(0, 17, B)
    alpha = 0.5 ** j
    out = fk.winner_reroll(r, torch.as_tensor(alpha), *(torch.as_tensor(a) for a in live))
    ref = jfk.make_winner_reroll(jspec, jopts, interpret=True)(
        sl(alpha), *(sl(a) for a in live))
    for a, b in zip(out, ref):
        close(a, unsl(b))
    if name == "cartpole":
        c = out[3][:-1].numpy()
        assert (c > 0).any() and (c < 0).any()


def test_plain_k1_at_2_1_matches_jax_kernel():
    """K1's plain version at particle's and pendulum's (n, m) = (2, 1),
    B=256, Tm1=12, per-lane regularization, against JAX's ``_kernel_mr``
    (``backward_pass_multiref``)."""
    rng = np.random.default_rng(12)
    B, Tm1 = 256, 12
    bl = [_batch_last(a) for a in _stacks(rng, B, Tm1, 2, 1)]
    u_mask = np.ones((Tm1, 1), bool)
    reg = np.abs(rng.standard_normal(B))
    ref = _jax_multiref(bl, reg, u_mask)
    out = _port_multiref(bl, reg, u_mask)
    for name, a, b in zip(["K", "k", "Qx", "Qu", "p", "ok"], ref, out):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10, err_msg=name)
    assert (out[-1] == 1).all()
