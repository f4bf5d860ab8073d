"""256-bit limb arithmetic on torch tensors: the limb ops the plain field
and the GLV split need (counterpart of the matching parts of
`tpu_msm/ops/u256.py`: `add`/`sub` with carry out, `geq`, `test_bit`,
`mul_const`, and `const` for its `from_const`).

A value is a (k, *batch) integer tensor of little-endian 16-bit limbs,
limbs first (k = 16 for a 256-bit value). Any signed integer dtype with room
for a 17-bit limb sum works (the pipeline passes int32, the plain kernels
compute in int64); `mul_const` computes in int64 and returns the input's
dtype.
"""

from __future__ import annotations

import functools

import torch

from tpu_msm_torch.models.bn254 import LIMB_BITS, LIMB_MASK, LIMBS


def const(value: int, like: torch.Tensor, limbs: int = LIMBS) -> torch.Tensor:
    """(limbs, 1, ..., 1) tensor of `value`'s limbs (mod 2^(16·limbs)) that
    broadcasts against `like`, on its device and in its dtype. Read-only: it
    is cached, so a plain op on the card does not copy the constant to the
    device on every call."""
    return _const(value, like.dtype, like.device, like.dim(), limbs)


@functools.lru_cache(maxsize=64)
def _const(value: int, dtype, device, ndim: int, limbs: int) -> torch.Tensor:
    vals = [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(limbs)]
    t = torch.tensor(vals, dtype=dtype, device=device)
    return t.reshape((limbs,) + (1,) * (ndim - 1))


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


def add(a, b):
    """a + b -> (limbs mod 2^(16k), carry out in {0, 1})."""
    return normalize(a + b)


def sub(a, b):
    """a - b -> (limbs mod 2^(16k), borrow out in {0, 1})."""
    limbs, carry = normalize(a - b)
    return limbs, -carry


def geq(a, b):
    """a >= b, per batch element."""
    return sub(a, b)[1] == 0


def test_bit(a, k: int):
    """Bit k of each batch element (0 or 1)."""
    limb, bit = divmod(k, LIMB_BITS)
    return (a[limb] >> bit) & 1


def mul_const(a, b_int: int, n_out: int):
    """(k, *batch) limbs times the integer constant b_int -> n_out limbs,
    exact mod 2^(16·n_out). One multiply-add of the (k, *batch) slab per
    nonzero limb of b_int into int64 columns (each below 2^37 for k <= 32),
    then one carry ripple; no (k, k, *batch) outer product."""
    k = a.shape[0]
    cols = torch.zeros((n_out + k, *a.shape[1:]), dtype=torch.int64,
                       device=a.device)
    a64 = a.to(torch.int64)
    nb = -(-max(b_int.bit_length(), 1) // LIMB_BITS)
    for j in range(min(nb, n_out)):
        bj = (b_int >> (LIMB_BITS * j)) & LIMB_MASK
        if bj:
            cols[j:j + k].add_(a64, alpha=bj)
    limbs, _ = normalize(cols[:n_out])
    return limbs.to(a.dtype)


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(cond, a, b):
    """Per-lane select: cond is (*batch) bool, a and b (16, *batch)."""
    return torch.where(cond, a, b)

