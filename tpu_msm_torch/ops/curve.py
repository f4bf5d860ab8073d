"""BN254 G1 points in homogeneous projective and Jacobian coordinates,
plain torch (counterpart of `tpu_msm/ops/curve.py`).

Affine (x, y), projective (X : Y : Z) and Jacobian (X, Y, Z) points hold
(16, *batch) Montgomery limb tensors. The affine infinity is the (0, 0)
sentinel (not on the curve, since B = 3); the projective infinity is
(0 : 1 : 0), the Jacobian one (1, 1, 0), and any Z = 0 is infinity. The RCB
formulas are complete: one code path covers doubling, inverses and the
identity, with no per-lane branches. The Jacobian adders (add-2007-bl,
madd-2007-bl) are made complete by selects: the generic formula, the
dbl-2009-l fallback and the infinity cases are all computed and combined.
The MSM runs on the RCB formulas; the Jacobian ops are what the Jacobian
kernels (`cuda_curve.jac_madd`, `jac_add`) are checked against. Off the
MSM's path, as in the JAX package: `scalar_mul`, `mul_all_ones`, the
conversions to affine (a field inversion each) and `affine_on_curve`.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from tpu_msm_torch.models import bn254
from tpu_msm_torch.ops import ec_rows, field, u256


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


class ProjPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class JacPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def proj_infinity(batch_shape, device, dtype=torch.int32) -> ProjPoint:
    zero = field.zero(batch_shape, device, dtype)
    return ProjPoint(zero, field.one_mont(batch_shape, device, dtype), zero)


def proj_is_infinity(p: ProjPoint):
    return field.is_zero(p.z)


def affine_is_infinity(p: AffinePoint):
    return field.is_zero(p.x) & field.is_zero(p.y)


def proj_neg(p: ProjPoint) -> ProjPoint:
    return ProjPoint(p.x, field.neg_mod(p.y), p.z)


def select_point(cond, a, b):
    """Per-lane select of two points of the same kind."""
    return type(a)(*(field.select(cond, fa, fb) for fa, fb in zip(a, b)))


def affine_to_proj(p: AffinePoint) -> ProjPoint:
    """(x, y) -> (x : y : 1); the (0, 0) sentinel -> (0 : 1 : 0)."""
    inf = affine_is_infinity(p)
    shape, dev, dt = p.x.shape[1:], p.x.device, p.x.dtype
    one = field.one_mont(shape, dev, dt)
    zero = field.zero(shape, dev, dt)
    return ProjPoint(p.x, field.select(inf, one, p.y),
                     field.select(inf, zero, one))


def proj_add(p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """RCB Algorithm 7 (a = 0): complete projective addition."""
    return ProjPoint(*ec_rows.proj_add(field.F, *p, *q))


def proj_madd(p: ProjPoint, q: AffinePoint) -> ProjPoint:
    """RCB Algorithm 8 (a = 0): complete mixed addition; q = (0, 0) is
    infinity and leaves p unchanged."""
    return ProjPoint(*ec_rows.proj_madd(field.F, *p, *q))


def proj_double(p: ProjPoint) -> ProjPoint:
    """Doubling as a self-addition (Algorithm 7 handles P + P exactly)."""
    return proj_add(p, p)


def proj_eq(p: ProjPoint, q: ProjPoint):
    """Projective equality: X1·Z2 == X2·Z1 and Y1·Z2 == Y2·Z1, with the
    infinity cases."""
    x_eq = field.eq(field.mont_mul(p.x, q.z), field.mont_mul(q.x, p.z))
    y_eq = field.eq(field.mont_mul(p.y, q.z), field.mont_mul(q.y, p.z))
    inf_p = proj_is_infinity(p)
    inf_q = proj_is_infinity(q)
    return (inf_p & inf_q) | (~inf_p & ~inf_q & x_eq & y_eq)


# --------------------------------------------------------------------------
# Jacobian coordinates (`tpu_msm/ops/curve.py:35-200,267-278`). The JAX
# package stacks independent multiplies into wide ones (`mont_mul_many`);
# one multiply each gives the same canonical values.
# --------------------------------------------------------------------------

def jac_infinity(batch_shape, device, dtype=torch.int32) -> JacPoint:
    one = field.one_mont(batch_shape, device, dtype)
    return JacPoint(one, one.clone(), field.zero(batch_shape, device, dtype))


def jac_is_infinity(p: JacPoint):
    return field.is_zero(p.z)


def affine_to_jac(p: AffinePoint) -> JacPoint:
    """(x, y) -> (x, y, 1); the (0, 0) sentinel -> (1, 1, 0)."""
    inf = affine_is_infinity(p)
    shape, dev, dt = p.x.shape[1:], p.x.device, p.x.dtype
    one = field.one_mont(shape, dev, dt)
    return JacPoint(field.select(inf, one, p.x), field.select(inf, one, p.y),
                    field.select(inf, field.zero(shape, dev, dt), one))


def jac_neg(p: JacPoint) -> JacPoint:
    return JacPoint(p.x, field.neg_mod(p.y), p.z)


def _sqr(a):
    return field.mont_mul(a, a)


def jac_double(p: JacPoint) -> JacPoint:
    """dbl-2009-l (a = 0). Z = 0 stays 0, and BN254 G1 has no point with
    y = 0, so no select is needed."""
    xx, yy, yz = _sqr(p.x), _sqr(p.y), field.mont_mul(p.y, p.z)
    yyyy, t = _sqr(yy), _sqr(field.add_mod(p.x, yy))
    d = field.double_mod(field.sub_mod(field.sub_mod(t, xx), yyyy))
    e = field.add_mod(field.double_mod(xx), xx)
    x3 = field.sub_mod(_sqr(e), field.double_mod(d))
    g = field.mont_mul(e, field.sub_mod(d, x3))
    y3 = field.sub_mod(g, field.double_mod(field.double_mod(
        field.double_mod(yyyy))))
    return JacPoint(x3, y3, field.double_mod(yz))


def _finalize_add(raw: JacPoint, dbl: JacPoint, p: JacPoint, q_jac: JacPoint,
                  inf_p, inf_q, h, r) -> JacPoint:
    """The exceptional-case selects shared by the complete adders."""
    both_finite = ~inf_p & ~inf_q
    h_zero = field.is_zero(h)
    r_zero = field.is_zero(r)
    res = select_point(both_finite & h_zero & r_zero, dbl, raw)
    inf_mask = both_finite & h_zero & ~r_zero
    res = JacPoint(res.x, res.y,
                   field.select(inf_mask, torch.zeros_like(res.z), res.z))
    res = select_point(inf_q, p, res)
    return select_point(inf_p, q_jac, res)


def _dbl_tail(x3d, gd, yyyy, y1z1):
    """The doubling fallback's point from the fused multiplies."""
    return JacPoint(x3d, field.sub_mod(gd, field.double_mod(field.double_mod(
        field.double_mod(yyyy)))), field.double_mod(y1z1))


def jac_add(p: JacPoint, q: JacPoint) -> JacPoint:
    """Complete Jacobian + Jacobian addition (add-2007-bl with the doubling
    fallback fused in and select fix-ups)."""
    add, sub, dbl2, mul = (field.add_mod, field.sub_mod, field.double_mod,
                           field.mont_mul)
    z1z1, z2z2, xx, yy = _sqr(p.z), _sqr(q.z), _sqr(p.x), _sqr(p.y)
    xpyy = add(p.x, yy)
    u1, u2 = mul(p.x, z2z2), mul(q.x, z1z1)
    zc1, zc2 = mul(q.z, z2z2), mul(p.z, z1z1)
    yyyy, t = _sqr(yy), _sqr(xpyy)
    e = add(dbl2(xx), xx)
    s1, s2, f_dbl, y1z1 = mul(p.y, zc1), mul(q.y, zc2), _sqr(e), mul(p.y, p.z)
    h = sub(u2, u1)
    r = dbl2(sub(s2, s1))
    d = dbl2(sub(sub(t, xx), yyyy))
    x3d = sub(f_dbl, dbl2(d))
    two_h = dbl2(h)
    zpz = add(p.z, q.z)
    i, rr, gd, zt = _sqr(two_h), _sqr(r), mul(e, sub(d, x3d)), _sqr(zpz)
    j, v = mul(h, i), mul(u1, i)
    x3 = sub(sub(rr, j), dbl2(v))
    zh = sub(sub(zt, z1z1), z2z2)
    w1, w2, z3 = mul(r, sub(v, x3)), mul(s1, j), mul(zh, h)
    raw = JacPoint(x3, sub(w1, dbl2(w2)), z3)
    return _finalize_add(raw, _dbl_tail(x3d, gd, yyyy, y1z1), p, q,
                         jac_is_infinity(p), jac_is_infinity(q), h, r)


def jac_add_affine(p: JacPoint, q: AffinePoint) -> JacPoint:
    """Complete Jacobian + affine mixed addition (madd-2007-bl with the
    doubling fallback fused in and select fix-ups)."""
    add, sub, dbl2, mul = (field.add_mod, field.sub_mod, field.double_mod,
                           field.mont_mul)
    z1z1, y2z1, xx, yy = _sqr(p.z), mul(q.y, p.z), _sqr(p.x), _sqr(p.y)
    xpyy = add(p.x, yy)
    u2, s2, yyyy, t = mul(q.x, z1z1), mul(y2z1, z1z1), _sqr(yy), _sqr(xpyy)
    h = sub(u2, p.x)
    r = dbl2(sub(s2, p.y))
    d = dbl2(sub(sub(t, xx), yyyy))
    e = add(dbl2(xx), xx)
    hh, rr, f_dbl, y1z1 = _sqr(h), _sqr(r), _sqr(e), mul(p.y, p.z)
    i = dbl2(dbl2(hh))
    x3d = sub(f_dbl, dbl2(d))
    z1ph = add(p.z, h)
    j, v, gd, zt = mul(h, i), mul(p.x, i), mul(e, sub(d, x3d)), _sqr(z1ph)
    x3 = sub(sub(rr, j), dbl2(v))
    w1, w2 = mul(r, sub(v, x3)), mul(p.y, j)
    raw = JacPoint(x3, sub(w1, dbl2(w2)), sub(sub(zt, z1z1), hh))
    return _finalize_add(raw, _dbl_tail(x3d, gd, yyyy, y1z1), p,
                         affine_to_jac(q), jac_is_infinity(p),
                         affine_is_infinity(q), h, r)


def jac_eq(p: JacPoint, q: JacPoint):
    """Projective equality: X1·Z2^2 == X2·Z1^2 and Y1·Z2^3 == Y2·Z1^3, with
    the infinity cases."""
    z1z1, z2z2 = _sqr(p.z), _sqr(q.z)
    x_eq = field.eq(field.mont_mul(p.x, z2z2), field.mont_mul(q.x, z1z1))
    y_eq = field.eq(field.mont_mul(p.y, field.mont_mul(q.z, z2z2)),
                    field.mont_mul(q.y, field.mont_mul(p.z, z1z1)))
    inf_p = jac_is_infinity(p)
    inf_q = jac_is_infinity(q)
    return (inf_p & inf_q) | (~inf_p & ~inf_q & x_eq & y_eq)


# --------------------------------------------------------------------------
# Scalar multiplication, conversions and predicates
# (`tpu_msm/ops/curve.py:203-300,395-403`): not on the MSM's path.
# --------------------------------------------------------------------------

def scalar_mul(p: JacPoint, scalar_limbs,
               num_bits: int = bn254.TOTAL_BITS) -> JacPoint:
    """Per-lane double-and-add of p by (16, *batch) scalar limbs, the most
    significant of `num_bits` bits first."""
    acc = jac_infinity(p.z.shape[1:], p.z.device, p.z.dtype)
    for k in range(num_bits - 1, -1, -1):
        acc = jac_double(acc)
        acc = select_point(u256.test_bit(scalar_limbs, k) == 1,
                           jac_add(acc, p), acc)
    return acc


def mul_all_ones(p: JacPoint, c: int) -> JacPoint:
    """(2^c - 1)·p by c - 1 rounds of acc = 2·acc + p (the window sum's
    M·X(n) for unsigned digits)."""
    acc = p
    for _ in range(c - 1):
        acc = jac_add(jac_double(acc), p)
    return acc


# The widest batch inverted one element at a time: above it, Montgomery's
# trick (about 3 products an element against about 380).
INV_ELEMENTWISE_MAX = 16


def _inv_for_batch(z):
    if math.prod(z.shape[1:]) > INV_ELEMENTWISE_MAX:
        return field.batch_inv_mont(z.reshape(z.shape[0], -1)).reshape(
            z.shape)
    return field.inv_mont(z)


def _affine_or_infinity(x, y, inf) -> AffinePoint:
    zero = torch.zeros_like(x)
    return AffinePoint(field.select(inf, zero, x), field.select(inf, zero, y))


def jac_to_affine(p: JacPoint) -> AffinePoint:
    """(X / Z^2, Y / Z^3) in Montgomery form; infinity -> (0, 0)."""
    zinv = _inv_for_batch(p.z)
    zinv2 = field.mont_sqr(zinv)
    return _affine_or_infinity(
        field.mont_mul(p.x, zinv2),
        field.mont_mul(p.y, field.mont_mul(zinv, zinv2)), jac_is_infinity(p))


def proj_to_affine(p: ProjPoint) -> AffinePoint:
    """(X / Z, Y / Z) in Montgomery form; infinity -> (0, 0)."""
    zinv = _inv_for_batch(p.z)
    return _affine_or_infinity(field.mont_mul(p.x, zinv),
                               field.mont_mul(p.y, zinv),
                               proj_is_infinity(p))


def affine_on_curve(p: AffinePoint):
    """y^2 == x^3 + 3 in Montgomery form; the (0, 0) infinity counts as on
    the curve."""
    x2 = field.mont_mul(p.x, p.x)
    rhs = field.add_mod(field.mont_mul(x2, p.x),
                        u256.const(bn254.B_MONT, p.x).expand_as(p.x))
    return field.eq(field.mont_mul(p.y, p.y), rhs) | affine_is_infinity(p)


def generator(batch_shape, device, dtype=torch.int32) -> AffinePoint:
    """The generator (1, 2) in Montgomery form, (16, *batch_shape) each."""
    shape = (bn254.LIMBS, *batch_shape)
    like = torch.empty(shape, dtype=dtype, device=device)
    return AffinePoint(*(u256.const(v, like).expand(shape).clone()
                         for v in (bn254.GX_MONT, bn254.GY_MONT)))
