"""Pure-Python BN254 reference implementation (differential-test oracle),
a copy of `tpu_msm/utils/oracle.py` that imports no jax (`tpu_msm/__init__.py`
does). Written with Python big ints — slow, obviously correct.

All values here are **standard form** Python ints (not Montgomery).
Points are `(x, y)` affine tuples with `None` for the point at infinity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from tpu_msm_torch.models.bn254 import P, FR, B_CURVE, GX, GY

Affine = Optional[Tuple[int, int]]


# ---------------------------------------------------------------------------
# Field ops
# ---------------------------------------------------------------------------

def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> Optional[int]:
    """Square root mod P (P = 3 mod 4), or None if a is not a QR."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a else None


# ---------------------------------------------------------------------------
# Curve ops (affine, y^2 = x^3 + 3)
# ---------------------------------------------------------------------------

GEN: Affine = (GX, GY)


def is_on_curve(pt: Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_CURVE)) % P == 0


def ec_neg(pt: Affine) -> Affine:
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def ec_add(p1: Affine, p2: Affine) -> Affine:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * fp_inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fp_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def ec_double(pt: Affine) -> Affine:
    return ec_add(pt, pt)


def ec_mul(pt: Affine, k: int) -> Affine:
    k %= FR
    acc: Affine = None
    add = pt
    while k:
        if k & 1:
            acc = ec_add(acc, add)
        add = ec_add(add, add)
        k >>= 1
    return acc


def msm(scalars: Sequence[int], points: Sequence[Affine]) -> Affine:
    """Naive MSM oracle: sum_i scalars[i] * points[i]."""
    acc: Affine = None
    for s, pt in zip(scalars, points):
        acc = ec_add(acc, ec_mul(pt, s))
    return acc


# ---------------------------------------------------------------------------
# Pippenger stage oracles (mirror the reference's per-stage Rust oracles).
# ---------------------------------------------------------------------------

def window_digits(scalar: int, c: int, num_windows: int) -> List[int]:
    """Digit extraction oracle (reference: prepare_buckets_indices_rust,
    src/metal/msm/prepare_buckets_indices.rs:59-118)."""
    return [(scalar >> (c * w)) & ((1 << c) - 1) for w in range(num_windows)]


def bucket_sums(
    scalars: Sequence[int], points: Sequence[Affine], c: int, window: int
) -> List[Affine]:
    """Per-bucket point sums for one window; index b holds digit b+1.

    Reference: bucket_wise_accumulation_rust
    (src/metal/msm/bucket_wise_accumulation.rs:662-681)."""
    buckets: List[Affine] = [None] * ((1 << c) - 1)
    for s, pt in zip(scalars, points):
        d = (s >> (c * window)) & ((1 << c) - 1)
        if d != 0:
            buckets[d - 1] = ec_add(buckets[d - 1], pt)
    return buckets


def window_sum(buckets: Sequence[Affine]) -> Affine:
    """sum_b (b+1) * buckets[b] (reference: sum_reduction_rust,
    src/metal/msm/sum_reduction.rs:358-378)."""
    running: Affine = None
    acc: Affine = None
    for b in range(len(buckets) - 1, -1, -1):
        running = ec_add(running, buckets[b])
        acc = ec_add(acc, running)
    return acc


def pippenger(scalars: Sequence[int], points: Sequence[Affine], c: int) -> Affine:
    """Full Pippenger oracle (reference: exec_metal_commands + final fold,
    src/metal/msm.rs:189-217, src/metal/msm/final_accumulation.rs:5-40)."""
    num_windows = -(-256 // c)
    acc: Affine = None
    for w in range(num_windows - 1, -1, -1):
        for _ in range(c if acc is not None else 0):
            acc = ec_double(acc)
        acc = ec_add(acc, window_sum(bucket_sums(scalars, points, c, w)))
    return acc
