"""BN254 G1 points in homogeneous projective coordinates, plain torch
(counterpart of `tpu_msm/ops/curve.py:310-411`).

Affine (x, y) and projective (X : Y : Z) points hold (16, *batch) Montgomery
limb tensors. The affine infinity is the (0, 0) sentinel (not on the curve,
since B = 3); the projective infinity is (0 : 1 : 0), and any Z = 0 is
infinity. The RCB formulas are complete: one code path covers doubling,
inverses and the identity, with no per-lane branches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_msm_torch.ops import ec_rows, field


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


class ProjPoint(NamedTuple):
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
