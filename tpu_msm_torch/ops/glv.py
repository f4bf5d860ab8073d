"""GLV endomorphism decomposition for BN254 G1 on torch tensors
(counterpart of `tpu_msm/ops/glv.py`).

BN254 G1 carries the cube-root endomorphism phi(x, y) = (BETA·x, y) with
phi(P) = LAMBDA·P for every point of the prime-order group. Splitting each
scalar k into k = k1 + k2·LAMBDA (mod r) with |k1|, |k2| < 2^127 lets the
Pippenger pipeline run 2n points over half the windows (8 instead of 16 at
c = 16): the scan does the same number of mixed adds, and every per-window
cost (lane-carry scan, queries, reduction, Horner) halves.

The constants are derived here at import from r and P and checked exactly,
with the JAX package's asserts (`glv.py:77-127`): phi(G) == LAMBDA·G on the
curve (the port's own oracle), both basis vectors in the GLV lattice,
det == +r, and the worst-case |k_i| after the corrections below 2^127.

The split is Babai round-off with a 272-bit fixed-point reciprocal, then one
conditional lattice-vector correction per component (the bound notes are in
the JAX module). `decompose_int` is the exact host version of one scalar;
`decompose_limbs` computes the same on (16, N) limb tensors with the limb
ops of `ops/u256.py`. The JAX package left these stages to XLA, so here they
are PyTorch ops on whatever device the scalars are on: no kernel.

Scalars in [r, 2^254), which the repository's fixtures contain, keep the
bound: the round-off error does not grow with k there (the fixed-point
error is below k·2^-272 < 2^-18), and tests/test_torch_glv.py holds the
limb version to the oracle on such scalars.
"""

from __future__ import annotations

import torch

from tpu_msm_torch.models import bn254
from tpu_msm_torch.ops import u256

P = bn254.P
FR = bn254.FR

# |k_i| < 2^GLV_BITS after the split: the windows of a split scalar.
GLV_BITS = 127


def _cube_root_of_unity(m: int) -> int:
    x = 2
    while True:
        w = pow(x, (m - 1) // 3, m)
        if w != 1:
            assert pow(w, 3, m) == 1
            return w
        x += 1


def _match_endomorphism():
    """(LAMBDA, BETA) with phi(G) = LAMBDA·G, checked on the curve."""
    from tpu_msm_torch.utils import oracle

    g = oracle.GEN
    lam = _cube_root_of_unity(FR)
    w = _cube_root_of_unity(P)
    for beta in (w, w * w % P):
        if oracle.ec_mul(g, lam) == (beta * g[0] % P, g[1]):
            return lam, beta
    raise AssertionError("no (lambda, beta) pairing found")  # pragma: no cover


LAMBDA, BETA = _match_endomorphism()


def _short_basis():
    """Extended-Euclid GLV basis of the lattice {(x, y): x + y·L = 0 mod r}."""
    rs, ts = [FR, LAMBDA], [0, 1]
    while rs[-1] * rs[-1] >= FR:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    a1, b1 = rs[-1], -ts[-1]
    cand_prev = (rs[-2], -ts[-2])
    q = rs[-2] // rs[-1]
    cand_next = (rs[-2] - q * rs[-1], -(ts[-2] - q * ts[-1]))
    a2, b2 = min(cand_prev, cand_next, key=lambda v: v[0] ** 2 + v[1] ** 2)
    return (a1, b1), (a2, b2)


(A1, B1), (A2, B2) = _short_basis()
DET = A1 * B2 - A2 * B1
assert DET == FR, "basis determinant must be +r"
for _a, _b in ((A1, B1), (A2, B2)):
    assert (_a + _b * LAMBDA) % FR == 0, "basis vector not in the GLV lattice"
assert A1 > 0 and B1 < 0 and A2 > 0 and B2 > 0  # the signs the code assumes

# 272-bit fixed-point reciprocals: q1 ~= k·B2/r, q2 ~= k·(-B1)/r.
_SHIFT = 272  # 17 u16 limbs: the biased shift is a limb drop
M1 = (B2 << _SHIFT) // FR
M2 = ((-B1) << _SHIFT) // FR

# Worst-case bounds, exact integer arithmetic (`tpu_msm/ops/glv.py:107-127`):
# before the corrections |k1| <= 1.5·(A1 + A2), |k2| <= 1.5·(|B1| + B2);
# one correction by the vector whose large component is in that coordinate
# when the magnitude reaches _THR, which sits 2^70 below 2^127 so that the
# other correction's small component cannot push a value past 2^127.
_THR = (1 << 127) - (1 << 70)
_PRE_K1 = 3 * (A1 + A2) // 2 + 1
_PRE_K2 = 3 * ((-B1) + B2) // 2 + 1
_K1_MID = max(_PRE_K1 - A2, A2 - _THR, _THR - 1)
_K1_FINAL = _K1_MID + A1
_K2_MID = _PRE_K2 + B2
_K2_FINAL = max(_K2_MID - (-B1), (-B1) - _THR, _THR - 1)
assert _K1_FINAL < (1 << GLV_BITS) and _K2_FINAL < (1 << GLV_BITS)

# BETA in Montgomery form (the pipeline's coordinates are Montgomery).
BETA_MONT = BETA * bn254.R % P


def decompose_int(k: int):
    """Exact host version of `decompose_limbs` on one scalar 0 <= k < r:
    (k1, k2) with k1 + k2·LAMBDA == k (mod r) and |k_i| < 2^127."""
    if not 0 <= k < FR:
        raise ValueError("decompose_int takes 0 <= k < r")
    bias = 1 << (_SHIFT - 1)
    q1 = (k * M1 + bias) >> _SHIFT
    q2 = (k * M2 + bias) >> _SHIFT
    k1 = k - q1 * A1 - q2 * A2
    k2 = -q1 * B1 - q2 * B2
    if abs(k1) >= _THR:  # correct with v2 (A2 is its large component)
        s = 1 if k1 >= 0 else -1
        k1 -= s * A2
        k2 -= s * B2
    if abs(k2) >= _THR:  # correct with v1 (B1 is its large component)
        s = 1 if k2 >= 0 else -1
        k1 -= s * A1
        k2 -= s * B1
    assert abs(k1) < 1 << GLV_BITS and abs(k2) < 1 << GLV_BITS
    assert (k1 + k2 * LAMBDA - k) % FR == 0
    return k1, k2


# --- Limb version ----------------------------------------------------------

def _q_fixed(k_limbs, m_int: int):
    """floor((k·M + 2^271) / 2^272) as (16, N) limbs: a 26-limb constant
    product (k·M < 2^400), the bias, then a 17-limb drop."""
    n_out = 26
    prod, _ = u256.add(u256.mul_const(k_limbs, m_int, n_out),
                       u256.const(1 << (_SHIFT - 1), k_limbs, n_out))
    q = prod[17:]
    return torch.cat([q, q.new_zeros((16 - q.shape[0],) + q.shape[1:])])


def _neg(x):
    return u256.sub(torch.zeros_like(x), x)[0]


def _sign_mag(x):
    """Two's-complement (16, N) -> (negative?, magnitude)."""
    neg = u256.test_bit(x, 255) == 1
    return neg, u256.select(neg, _neg(x), x)


def _cond_correct(k1, k2, which: int, va, vb):
    """Subtract sign(k_which)·(va, vb) from (k1, k2) where |k_which| >=
    _THR."""
    neg, mag = _sign_mag(k1 if which == 0 else k2)
    over = u256.geq(mag, u256.const(_THR, mag))
    do_sub = over & ~neg
    do_add = over & neg
    out = []
    for k, vc in ((k1, va), (k2, vb)):
        sub_v, _ = u256.sub(k, vc)
        add_v, _ = u256.add(k, vc)
        out.append(u256.select(do_sub, sub_v, u256.select(do_add, add_v, k)))
    return out


def decompose_limbs(scalar_limbs):
    """(16, N) standard-form scalars below 2^254 -> (|k1|, neg1, |k2|,
    neg2): (16, N) magnitudes below 2^127 in the input's dtype and (N,)
    bool negation masks, limb for limb the JAX `decompose_limbs`."""
    q1 = _q_fixed(scalar_limbs, M1)
    q2 = _q_fixed(scalar_limbs, M2)
    t1, _ = u256.add(u256.mul_const(q1, A1, 16), u256.mul_const(q2, A2, 16))
    k1, _ = u256.sub(scalar_limbs, t1)
    k2, _ = u256.sub(u256.mul_const(q1, -B1, 16), u256.mul_const(q2, B2, 16))
    k1, k2 = _cond_correct(k1, k2, 0, u256.const(A2, k1), u256.const(B2, k1))
    k1, k2 = _cond_correct(k1, k2, 1, u256.const(A1, k1),
                           u256.const(B1 % (1 << 256), k1))
    neg1, mag1 = _sign_mag(k1)
    neg2, mag2 = _sign_mag(k2)
    return mag1, neg1, mag2, neg2
