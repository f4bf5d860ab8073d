"""Complete projective EC formulas over an abstract field namespace
(counterpart of `tpu_msm/ops/ec_rows.py:75-120`).

Renes–Costello–Batina Algorithms 7 and 8 for a = 0, b3 = 9 (BN254 G1),
written once against `F`, which must provide mont_mul, add_mod, sub_mod,
dbl_mod, mul9, select and is_zero. The plain field (`ops/field.F`) runs them
on tensors; `csrc/bn254.cuh` spells out the same sequence in CUDA, and the
same sequence of canonical field ops gives bit-identical coordinates.
"""

from __future__ import annotations


def proj_add(F, x1, y1, z1, x2, y2, z2):
    """Complete projective P + Q (RCB Algorithm 7, a = 0)."""
    t0 = F.mont_mul(x1, x2)
    t1 = F.mont_mul(y1, y2)
    t2 = F.mont_mul(z1, z2)
    a = F.mont_mul(F.add_mod(x1, y1), F.add_mod(x2, y2))
    b = F.mont_mul(F.add_mod(x1, z1), F.add_mod(x2, z2))
    c = F.mont_mul(F.add_mod(y1, z1), F.add_mod(y2, z2))
    t3 = F.sub_mod(F.sub_mod(a, t0), t1)
    t4 = F.sub_mod(F.sub_mod(c, t1), t2)
    y3t = F.sub_mod(F.sub_mod(b, t0), t2)
    t0 = F.add_mod(F.dbl_mod(t0), t0)
    t2 = F.mul9(t2)
    z3t = F.add_mod(t1, t2)
    t1 = F.sub_mod(t1, t2)
    y3p = F.mul9(y3t)
    x3 = F.sub_mod(F.mont_mul(t3, t1), F.mont_mul(t4, y3p))
    y3 = F.add_mod(F.mont_mul(t1, z3t), F.mont_mul(y3p, t0))
    z3 = F.add_mod(F.mont_mul(z3t, t4), F.mont_mul(t0, t3))
    return x3, y3, z3


def proj_madd(F, x1, y1, z1, x2, y2):
    """Complete projective P + affine Q (RCB Algorithm 8, a = 0); the (0, 0)
    affine infinity sentinel leaves P unchanged (trailing select)."""
    inf_q = F.is_zero(x2) & F.is_zero(y2)
    t0 = F.mont_mul(x1, x2)
    t1 = F.mont_mul(y1, y2)
    a = F.mont_mul(F.add_mod(x1, y1), F.add_mod(x2, y2))
    d = F.mont_mul(y2, z1)
    e = F.mont_mul(x2, z1)
    t3 = F.sub_mod(F.sub_mod(a, t0), t1)
    t4 = F.add_mod(d, y1)
    y3t = F.add_mod(e, x1)
    t0 = F.add_mod(F.dbl_mod(t0), t0)
    t2 = F.mul9(z1)
    z3t = F.add_mod(t1, t2)
    t1 = F.sub_mod(t1, t2)
    y3p = F.mul9(y3t)
    x3 = F.sub_mod(F.mont_mul(t3, t1), F.mont_mul(t4, y3p))
    y3 = F.add_mod(F.mont_mul(t1, z3t), F.mont_mul(y3p, t0))
    z3 = F.add_mod(F.mont_mul(z3t, t4), F.mont_mul(t0, t3))
    x3 = F.select(inf_q, x1, x3)
    y3 = F.select(inf_q, y1, y3)
    z3 = F.select(inf_q, z1, z3)
    return x3, y3, z3
