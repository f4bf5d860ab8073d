"""EC formulas over an abstract field namespace (counterpart of
`tpu_msm/ops/ec_rows.py:75-120` and of the Jacobian row bodies of
`tpu_msm/ops/pallas_curve.py:216-309`).

Renes–Costello–Batina Algorithms 7 and 8 for a = 0, b3 = 9 (BN254 G1), and
the Jacobian madd-2007-bl / add-2007-bl adders with their dbl-2009-l
fallback and infinity selects, written once against `F`, which must provide
mont_mul, add_mod, sub_mod, dbl_mod, mul9, select, is_zero, zero_like and
one_like. The plain field (`ops/field.F`) runs them on tensors;
`csrc/bn254.cuh` spells out the same sequences in CUDA, and the same
sequence of canonical field ops gives bit-identical coordinates.
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


# --------------------------------------------------------------------------
# Jacobian adders (`pallas_curve.py:216-309`): the generic formula, the
# doubling fallback and the infinity cases, combined by selects.
# --------------------------------------------------------------------------

def jac_dbl_core(F, x1, y1, z1):
    """dbl-2009-l (a = 0), the fallback both adders share (`_dbl_core`)."""
    xx = F.mont_mul(x1, x1)
    yy = F.mont_mul(y1, y1)
    yyyy = F.mont_mul(yy, yy)
    xpyy = F.add_mod(x1, yy)
    t = F.mont_mul(xpyy, xpyy)
    d = F.dbl_mod(F.sub_mod(F.sub_mod(t, xx), yyyy))
    e = F.add_mod(F.dbl_mod(xx), xx)
    f = F.mont_mul(e, e)
    xd = F.sub_mod(f, F.dbl_mod(d))
    yd = F.sub_mod(F.mont_mul(e, F.sub_mod(d, xd)),
                   F.dbl_mod(F.dbl_mod(F.dbl_mod(yyyy))))
    zd = F.mont_mul(F.dbl_mod(y1), z1)
    return xd, yd, zd


def jac_finalize(F, raw, dbl, p, q, inf_p, inf_q, h_zero, r_zero):
    """The select order of `_finalize`: P == Q doubles, P == -Q gives
    Z = 0, then an infinite Q returns P and an infinite P returns Q."""
    use_dbl = h_zero & r_zero & ~inf_p & ~inf_q
    ox, oy, oz = (F.select(use_dbl, d, r) for d, r in zip(dbl, raw))
    inf_mask = h_zero & ~r_zero & ~inf_p & ~inf_q
    oz = F.select(inf_mask, F.zero_like(oz), oz)
    ox, oy, oz = (F.select(inf_q, a, o) for a, o in zip(p, (ox, oy, oz)))
    return tuple(F.select(inf_p, a, o) for a, o in zip(q, (ox, oy, oz)))


def jac_madd(F, x1, y1, z1, x2, y2):
    """Jacobian P + affine Q, madd-2007-bl (`_madd_rows`); the (0, 0)
    affine sentinel is infinity and lifts to (0, 0, 0)."""
    inf_q = F.is_zero(x2) & F.is_zero(y2)
    inf_p = F.is_zero(z1)
    z1z1 = F.mont_mul(z1, z1)
    u2 = F.mont_mul(x2, z1z1)
    s2 = F.mont_mul(y2, F.mont_mul(z1, z1z1))
    h = F.sub_mod(u2, x1)
    rhalf = F.sub_mod(s2, y1)
    h_zero = F.is_zero(h)
    r_zero = F.is_zero(rhalf)
    r = F.dbl_mod(rhalf)
    hh = F.mont_mul(h, h)
    i = F.dbl_mod(F.dbl_mod(hh))
    j = F.mont_mul(h, i)
    v = F.mont_mul(x1, i)
    rr = F.mont_mul(r, r)
    x3 = F.sub_mod(F.sub_mod(rr, j), F.dbl_mod(v))
    y3 = F.sub_mod(F.mont_mul(r, F.sub_mod(v, x3)),
                   F.dbl_mod(F.mont_mul(y1, j)))
    zph = F.add_mod(z1, h)
    z3 = F.sub_mod(F.sub_mod(F.mont_mul(zph, zph), z1z1), hh)
    dbl = jac_dbl_core(F, x1, y1, z1)
    q_jac = (x2, y2, F.select(inf_q, F.zero_like(x2), F.one_like(x2)))
    return jac_finalize(F, (x3, y3, z3), dbl, (x1, y1, z1), q_jac,
                        inf_p, inf_q, h_zero, r_zero)


def jac_add(F, x1, y1, z1, x2, y2, z2):
    """Jacobian P + Q, add-2007-bl (`_add_rows`)."""
    inf_p = F.is_zero(z1)
    inf_q = F.is_zero(z2)
    z1z1 = F.mont_mul(z1, z1)
    z2z2 = F.mont_mul(z2, z2)
    u1 = F.mont_mul(x1, z2z2)
    u2 = F.mont_mul(x2, z1z1)
    s1 = F.mont_mul(y1, F.mont_mul(z2, z2z2))
    s2 = F.mont_mul(y2, F.mont_mul(z1, z1z1))
    h = F.sub_mod(u2, u1)
    rhalf = F.sub_mod(s2, s1)
    h_zero = F.is_zero(h)
    r_zero = F.is_zero(rhalf)
    r = F.dbl_mod(rhalf)
    h2 = F.dbl_mod(h)
    i = F.mont_mul(h2, h2)
    j = F.mont_mul(h, i)
    v = F.mont_mul(u1, i)
    rr = F.mont_mul(r, r)
    x3 = F.sub_mod(F.sub_mod(rr, j), F.dbl_mod(v))
    y3 = F.sub_mod(F.mont_mul(r, F.sub_mod(v, x3)),
                   F.dbl_mod(F.mont_mul(s1, j)))
    zs = F.add_mod(z1, z2)
    zh = F.sub_mod(F.sub_mod(F.mont_mul(zs, zs), z1z1), z2z2)
    z3 = F.mont_mul(zh, h)
    dbl = jac_dbl_core(F, x1, y1, z1)
    return jac_finalize(F, (x3, y3, z3), dbl, (x1, y1, z1), (x2, y2, z2),
                        inf_p, inf_q, h_zero, r_zero)
