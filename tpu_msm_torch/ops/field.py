"""Plain BN254 base-field arithmetic in Montgomery form on torch tensors
(counterpart of `tpu_msm/ops/field.py`).

An element is a (16, *batch) integer tensor of canonical u16 limbs with
value in [0, P), in Montgomery form v = x·2^256 mod P. Every function returns
canonical values, so its results are bit-identical to the JAX cores and to
the CUDA core (`csrc/bn254.cuh`), which all compute the same residues.

This is the readable reference the kernels are held against, and what the
kernel wrappers run on CPU tensors; it is not fast. Beside it, off the MSM's
path as in the JAX package: `redc`, `to_mont` / `from_mont`, `pow_fixed`,
`inv_mont`, `batch_inv_mont` and `sqrt_mont`. `mont_mul` loops over
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


def cond_sub_p(a):
    """a - P if a >= P else a, for canonical limbs of a < 2^256."""
    d, borrow = u256.sub(a, u256.const(bn254.P, a))
    return u256.select(borrow == 0, d, a)


def mont_mul_const(a, c_int: int):
    """a·c·2^-256 mod P for a (16, *batch) batch and an integer constant c
    < P (the caller supplies its Montgomery form, e.g. glv.BETA_MONT);
    canonical, in a's dtype. One-shot REDC by constant products
    (`tpu_msm/ops/field.py:115-129`): t = a·c, m = t·(-P^-1) mod 2^256,
    (t + m·P) / 2^256 < 2P, then one conditional subtract."""
    t = u256.mul_const(a, c_int, 2 * LIMBS)
    m = u256.mul_const(t[:LIMBS], bn254.P_INV_NEG, LIMBS)
    s, _ = u256.add(t, u256.mul_const(m, bn254.P, 2 * LIMBS))
    return cond_sub_p(s[LIMBS:])


def _redc_columns(t):
    """REDC in place of (32, *batch) int64 columns of a value below
    P·2^256: clears one 16-bit limb per step, u = t_i·(-P^-1) mod 2^16,
    t += u·P·2^(16i), and t_i's carry moves up; columns below 2^36 stay
    below 2^38. The high 16 columns hold (t + mP)/2^256 < 2P; returns its
    canonical residue."""
    p = u256.const(bn254.P, t)
    for i in range(LIMBS):
        u = (t[i] * bn254.P_INV_NEG_16) & LIMB_MASK
        t[i:i + LIMBS].addcmul_(u, p)
        t[i + 1] += t[i] >> LIMB_BITS
    return reduce_2p(t[LIMBS:])


def mont_mul(a, b):
    """a·b·2^-256 mod P, canonical; returns a's dtype. The 16x16 product
    accumulates into 32 int64 columns (each < 2^36), then `_redc_columns`."""
    return _redc_columns(u256.product_columns(a, b, 2 * LIMBS)).to(a.dtype)


def redc(t):
    """Montgomery reduction of (32, *batch) limbs of t < P·2^256 ->
    t·2^-256 mod P, canonical (16, *batch), in t's dtype."""
    return _redc_columns(t.to(torch.int64).clone()).to(t.dtype)


def p_limbs(like):
    """P's limbs, (16, 1, ...) broadcasting against `like`."""
    return u256.const(bn254.P, like)


def const_mont(value: int, device, dtype=torch.int32) -> torch.Tensor:
    """(16, 1) limbs of an integer constant (the caller supplies the
    Montgomery form where the consumer expects it, e.g. glv.BETA_MONT)."""
    return u256.from_const(bn254.int_to_limbs(value, LIMBS), device=device,
                           dtype=dtype)


def mont_mul_many(pairs):
    """The Montgomery products of a list of (a, b) pairs of one shape, as
    one stacked mont_mul (`tpu_msm/ops/field.py:132-146`)."""
    a = torch.stack([p[0] for p in pairs], dim=1)
    b = torch.stack([p[1] for p in pairs], dim=1)
    return list(mont_mul(a, b).unbind(1))


def mont_sqr(a):
    return mont_mul(a, a)


def to_mont(a):
    """Standard form (any a < 2^256) -> Montgomery form, a·2^256 mod P."""
    return mont_mul(a, u256.const(bn254.R2_MOD_P, a))


def from_mont(a):
    """Montgomery form -> standard form, the REDC of a."""
    return redc(torch.cat([a, torch.zeros_like(a)]))


def pow_fixed(a, exponent: int):
    """a^exponent in Montgomery form for a Python-int exponent: left to
    right square-and-multiply; a^0 is one."""
    if exponent == 0:
        return one_like(a)
    acc = a
    for bit in bin(exponent)[3:]:  # after the leading 1
        acc = mont_sqr(acc)
        if bit == "1":
            acc = mont_mul(acc, a)
    return acc


def inv_mont(a):
    """a^-1 by Fermat, a^(P-2); the inverse of 0 is 0."""
    return pow_fixed(a, bn254.P - 2)


def _scan_mont_mul(a, reverse: bool = False):
    """Inclusive running products along axis 1 (from the end with
    `reverse`) by a log-depth Hillis-Steele scan over mont_mul. Products of
    canonical residues are exact, so any association gives the values of
    the JAX package's associative_scan."""
    if reverse:
        return _scan_mont_mul(a.flip(1)).flip(1)
    n = a.shape[1]
    shift = 1
    while shift < n:
        ones = one_mont((shift, *a.shape[2:]), a.device, a.dtype)
        a = mont_mul(a, torch.cat([ones, a[:, :n - shift]], dim=1))
        shift *= 2
    return a


def batch_inv_mont(a):
    """Elementwise inverses of (16, N, ...) along N by Montgomery's trick
    (`tpu_msm/ops/field.py:186-209`): the prefix and suffix products, one
    Fermat inversion of the total, two products an element. Zeros invert
    to zero (they count as one in the products)."""
    zero_mask = u256.is_zero(a)
    safe = u256.select(zero_mask, one_like(a), a)
    prefix = _scan_mont_mul(safe)
    suffix = _scan_mont_mul(safe, reverse=True)
    total_inv = inv_mont(prefix[:, -1:])
    ones = one_mont((1, *a.shape[2:]), a.device, a.dtype)
    before = torch.cat([ones, prefix[:, :-1]], dim=1)  # prod_{j<i}
    after = torch.cat([suffix[:, 1:], ones], dim=1)    # prod_{j>i}
    inv = mont_mul(mont_mul(before, after), total_inv.expand_as(a))
    return u256.select(zero_mask, torch.zeros_like(a), inv)


def sqrt_mont(a):
    """The candidate square root a^((P+1)/4) (P = 3 mod 4); the caller
    checks that its square is a."""
    return pow_fixed(a, bn254.SQRT_EXP)


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
