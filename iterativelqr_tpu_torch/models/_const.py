"""Model constants kept once per (device, dtype).

A model function runs on every rollout step; casting a float64 host
constant with ``.to(x)`` there would copy it from the host on every call.
``const_like`` makes each cast once and hands back the same tensor after.
``floats`` turns a problem's scalar or vector argument into the tuple of
Python floats that a model's ``Parameters`` hold.

While a function is traced with fake tensors (``ops/device_functions.py``)
the constant made is a fake tensor too; it is not kept, or a later call on
real tensors would get it back.
"""

from __future__ import annotations

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor

_CACHE: dict = {}


def const_like(values: tuple, x) -> torch.Tensor:
    """``torch.tensor(values, dtype=float64)`` cast to ``x``'s dtype on
    ``x``'s device, made once per (values, device, dtype)."""
    key = (values, x.device, x.dtype)
    c = _CACHE.get(key)
    if c is None:
        c = torch.tensor(values, dtype=torch.float64).to(
            device=x.device, dtype=x.dtype
        )
        if not (isinstance(c, FakeTensor) or isinstance(x, FakeTensor)
                or detect_fake_mode() is not None):
            _CACHE[key] = c
    return c


def floats(v, n: int) -> tuple:
    """``v`` (a scalar or a length-``n`` sequence) as ``n`` Python floats."""
    return tuple(float(a) for a in torch.broadcast_to(
        torch.as_tensor(v, dtype=torch.float64), (n,)))
