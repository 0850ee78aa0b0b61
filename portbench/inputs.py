"""Inputs made from the seed, on the device, by the configuration's protocol.

Every random draw comes from a ``torch.Generator`` on the run's device
seeded by ``(seed, *index)``, so the same seed gives the same inputs and
each batch draws its own.  Protocols (a configuration's
``inputs.protocol``; ``u0`` one number for every action, or one a action):

* ``splice``: ``bench.py``'s initial guess: x0 = x1 + scale N(0, 1) spliced
  into zero states, every control ``u0``;
* ``rollout``: ``chip_smoke.py::model_inputs``'s: x0 = x1 + scale N(0, 1),
  every control ``u0``, the states rolled out open loop through the
  reference's dynamics.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def seed_of(seed: int, *index: int) -> int:
    """A 63-bit seed for ``(seed, *index)``; any whole numbers."""
    words = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *map(int, index)])
    hi, lo = (int(w) for w in words.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & (2 ** 63 - 1)


def generator(device, seed: int, *index: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *index))
    return g


def normal(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def initial_states(config, B, gen, dtype):
    p = config["inputs"]
    x1 = torch.tensor(p["x1"], dtype=dtype, device=gen.device)
    return x1 + p["x0_scale"] * normal((B, x1.numel()), gen, dtype)


def batch(config: dict, reference, B: int, gen: torch.Generator, dtype):
    """(xs [B, T, nx], us [B, T-1, nu], ws [B, T, 0]) by the configuration's
    protocol."""
    p, T = config["inputs"], config["T"]
    x0 = initial_states(config, B, gen, dtype)
    u0 = torch.as_tensor(p["u0"], dtype=dtype, device=gen.device)
    us = u0.expand(B, T - 1, reference.nu).contiguous()
    if p["protocol"] == "splice":
        xs = x0.new_zeros((B, T, reference.nx))
        xs[:, 0] = x0
    elif p["protocol"] == "rollout":
        xs = [x0]
        for t in range(T - 1):
            xs.append(reference.discrete(xs[-1], us[:, t]))
        xs = torch.stack(xs, dim=1)
    else:
        raise ValueError(f"unknown input protocol {p['protocol']!r}")
    return xs.contiguous(), us, x0.new_zeros((B, T, 0))
