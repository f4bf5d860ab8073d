"""The plain reference: BN254 G1 in Python integers, and the MSM of a run's
inputs from the discrete logs the benchmark gave its bases.

Every base the traffic makes is d·G for a d the benchmark knows
(`traffic.Workload`): the walk's k-th point is G + k·(t·G) = (1 + k·t)·G,
and the table holds the walk's points at seeded indices. So the MSM
sum_i s_i·P_i is (sum_i s_i·d_i mod r)·G, and that sum takes two int64
dot products a limb: sum_i s_i and sum_i s_i·idx_i, each below 2^63 while
n times the number of distinct bases stays below 2^47 (2^24 points over
4096 bases: below 2^52). The
reference never reads what the program made; it regenerates the scalars
and the index from the seed (`traffic.Workload`) and checks sampled rows of
the table the program was handed against scalar multiples of G worked out
here, so a table that is not what the discrete logs say is caught too.

This module imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
G = (1, 2)
MONT = 1 << 256
LIMBS = 16
LIMB_BITS = 16

Affine = Optional[Tuple[int, int]]


def ec_add(p: Affine, q: Affine) -> Affine:
    """Affine addition on y^2 = x^3 + 3, None for the point at infinity."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def ec_mul(p: Affine, k: int) -> Affine:
    """k·p by double-and-add, k reduced mod r."""
    out, k = None, k % R
    while k:
        if k & 1:
            out = ec_add(out, p)
        p = ec_add(p, p)
        k >>= 1
    return out


def on_curve(p: Affine) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - B) % P == 0


def walk(step_log: int, count: int) -> List[Affine]:
    """The traffic's distinct bases: G + k·(step_log·G), k < count."""
    step = ec_mul(G, step_log)
    out, acc = [], G
    for _ in range(count):
        out.append(acc)
        acc = ec_add(acc, step)
    return out


def to_mont_limbs(values) -> np.ndarray:
    """Field elements -> their Montgomery forms x·2^256 mod p as (16, m)
    uint32 arrays of little-endian 16-bit limbs."""
    words = b"".join((v * MONT % P).to_bytes(32, "little") for v in values)
    return np.frombuffer(words, dtype="<u2").reshape(-1, LIMBS).T.astype(
        np.uint32, order="C")


def from_mont_limbs(column) -> int:
    """One column of 16 Montgomery limbs -> the field element."""
    v = sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(column))
    return v * pow(MONT, -1, P) % P


def limb_sums(scalars, index) -> Tuple[List[int], List[int]]:
    """sum_i limb_l(s_i) and sum_i limb_l(s_i)·index_i for each limb l, in
    int64 on the tensors' device, one limb at a time."""
    idx = index.to(torch.int64)
    plain, weighted = [], []
    for l in range(LIMBS):
        row = scalars[l].to(idx.dtype)
        plain.append(int(row.sum()))
        weighted.append(int((row * idx).sum()))
    return plain, weighted


def exponent(plain: List[int], weighted: List[int], step_log: int,
             limbs: int = LIMBS) -> int:
    """sum_i s_i·d_i mod r with d_i = 1 + index_i·step_log, over the low
    `limbs` limbs of every scalar (all 16 for the reference)."""
    e = 0
    for l in range(limbs):
        e += (plain[l] + step_log * weighted[l]) << (LIMB_BITS * l)
    return e % R


def expected(plain, weighted, step_log: int, limbs: int = LIMBS) -> Affine:
    """The MSM as the reference has it. With limbs=15 it is the control: the
    same sum over scalars cut to 240 bits, their top window left out."""
    return ec_mul(G, exponent(plain, weighted, step_log, limbs))
