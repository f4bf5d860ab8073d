"""Plain BN254 base-field arithmetic in Montgomery form on torch tensors
(counterpart of `tpu_msm/ops/field.py`).

An element is a (16, *batch) integer tensor of canonical u16 limbs with
value in [0, P), in Montgomery form v = x·2^256 mod P. Every function returns
canonical values, so its results are bit-identical to the JAX cores and to
the CUDA core (`csrc/bn254.cuh`), which all compute the same residues.

This is the readable reference the kernels are held against, and what the
kernel wrappers run on CPU tensors; it is not fast. `mont_mul` loops over
the limbs in int64 (schoolbook product, then word-by-word REDC with lazy
carries) and never materialises a 16 x 16 x batch outer product: at the
`_sides_batched` width of 16 x 32,769 lanes that product would pass 1 GB.
"""

from __future__ import annotations

import types

import torch

from tpu_msm_torch.models import bn254
from tpu_msm_torch.models.bn254 import LIMB_BITS, LIMB_MASK, LIMBS
from tpu_msm_torch.ops import u256


def zero(batch_shape, device, dtype=torch.int32) -> torch.Tensor:
    return torch.zeros((LIMBS, *batch_shape), dtype=dtype, device=device)


def one_mont(batch_shape, device, dtype=torch.int32) -> torch.Tensor:
    """Montgomery one, R mod P (a fresh tensor, never the cached constant)."""
    like = torch.empty((LIMBS, *batch_shape), dtype=dtype, device=device)
    return u256.const(bn254.R_MOD_P, like).expand_as(like).clone()


def _first_nonneg(v, fallback):
    """Canonical limbs of `v` if its value is >= 0, else of `fallback`.
    Both are limb columns of any sign; one carry ripple covers the pair."""
    limbs, carry = u256.normalize(torch.stack([v, fallback], dim=1))
    return u256.select(carry[0] < 0, limbs[:, 1], limbs[:, 0])


def reduce_2p(v):
    """Canonical residue of limb columns with value in [0, 2P)."""
    return _first_nonneg(v - u256.const(bn254.P, v), v)


def add_mod(a, b):
    return reduce_2p(a + b)


def sub_mod(a, b):
    d = a - b
    return _first_nonneg(d, d + u256.const(bn254.P, d))


def neg_mod(a):
    """(-a) mod P, with -0 = 0 (so the (0, 0) infinity sentinel survives)."""
    d, _ = u256.normalize(u256.const(bn254.P, a) - a)
    return u256.select(u256.is_zero(a), a, d)


def double_mod(a):
    return add_mod(a, a)


def mul9(a):
    """9·a mod P (b3 = 3b = 9 for BN254) by an add chain."""
    return add_mod(double_mod(double_mod(double_mod(a))), a)


def mont_mul(a, b):
    """a·b·2^-256 mod P, canonical; returns a's dtype.

    The 16x16 product accumulates into 32 int64 columns (each < 2^36). REDC
    then clears one 16-bit limb per step: u = t_i·(-P^-1) mod 2^16,
    t += u·P·2^(16i), and t_i's carry moves up; the columns stay < 2^38.
    The high 16 columns hold (t + mP)/2^256 < 2P."""
    dtype = a.dtype
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = torch.zeros((2 * LIMBS, *batch), dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        t[i:i + LIMBS].addcmul_(a[i], b)
    p = u256.const(bn254.P, t)
    for i in range(LIMBS):
        u = (t[i] * bn254.P_INV_NEG_16) & LIMB_MASK
        t[i:i + LIMBS].addcmul_(u, p)
        t[i + 1] += t[i] >> LIMB_BITS
    return reduce_2p(t[LIMBS:]).to(dtype)


def is_zero(a):
    return u256.is_zero(a)


def eq(a, b):
    return u256.eq(a, b)


def select(cond, a, b):
    return u256.select(cond, a, b)


def one_like(a):
    """Montgomery one in the shape, device and dtype of `a`."""
    return one_mont(a.shape[1:], a.device, a.dtype)


# The field namespace the shared EC formulas (ops/ec_rows.py) run over.
F = types.SimpleNamespace(
    mont_mul=mont_mul, add_mod=add_mod, sub_mod=sub_mod, dbl_mod=double_mod,
    mul9=mul9, select=select, is_zero=is_zero, zero_like=torch.zeros_like,
    one_like=one_like)
