"""256-bit limb arithmetic on torch tensors: the limb ops the plain field
needs (counterpart of the matching parts of `tpu_msm/ops/u256.py`).

A value is a (16, *batch) integer tensor of little-endian 16-bit limbs,
limbs first. Any signed integer dtype with room for a 17-bit limb sum works
(the pipeline passes int32, the plain kernels compute in int64).
"""

from __future__ import annotations

import functools

import torch

from tpu_msm_torch.models.bn254 import LIMB_BITS, LIMB_MASK, LIMBS


def const(value: int, like: torch.Tensor) -> torch.Tensor:
    """(16, 1, ..., 1) tensor of `value`'s limbs that broadcasts against
    `like`, on its device and in its dtype. Read-only: it is cached, so a
    plain op on the card does not copy the constant to the device on every
    call."""
    return _const(value, like.dtype, like.device, like.dim())


@functools.lru_cache(maxsize=64)
def _const(value: int, dtype, device, ndim: int) -> torch.Tensor:
    limbs = [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)]
    t = torch.tensor(limbs, dtype=dtype, device=device)
    return t.reshape((LIMBS,) + (1,) * (ndim - 1))


def normalize(cols: torch.Tensor):
    """Exact sequential carry propagation over the limb axis.

    cols: (k, *batch) limb columns of either sign (a column may hold a sum
    of products or a negative difference). Returns (canonical limbs, final
    carry); the carry is negative when the value was negative (a borrow),
    since the arithmetic shift keeps the sign."""
    rows = []
    carry = None
    for v in cols.unbind(0):
        if carry is not None:
            v = v + carry
        rows.append(v)
        carry = v >> LIMB_BITS
    return torch.stack(rows) & LIMB_MASK, carry


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(cond, a, b):
    """Per-lane select: cond is (*batch) bool, a and b (16, *batch)."""
    return torch.where(cond, a, b)

