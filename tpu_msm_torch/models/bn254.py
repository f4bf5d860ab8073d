"""BN254 base-field and curve parameters for the PyTorch port.

The two primes and the generator are the definition; every other constant
is derived from them here at import time, as in `tpu_msm/models/bn254.py`,
with the same names: Python ints, and their limb vectors (`*_LIMBS`, numpy
uint32 by `int_to_limbs`). No torch, no jax, so the host-side interop and
the native binding import it cheaply.

Limb layout: a 256-bit value is 16 little-endian 16-bit limbs, limbs first,
one limb per 32-bit lane — the JAX package's wire format, which both
packages accept. The CUDA kernels read the same value as 8 little-endian
32-bit words (word i = limb 2i | limb 2i+1 << 16).
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * LIMBS  # 256
R = 1 << TOTAL_BITS  # Montgomery radix 2^256


def int_to_limbs(x: int, n: int = LIMBS) -> np.ndarray:
    """Python int -> its n little-endian 16-bit limbs, (n,) uint32."""
    if x < 0 or x >= 1 << (LIMB_BITS * n):
        raise ValueError(f"{x} out of range for {n} limbs of {LIMB_BITS} "
                         f"bits")
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """Little-endian limbs (leading axis) -> Python int."""
    limbs = np.asarray(limbs)
    acc = 0
    for i in range(limbs.shape[0] - 1, -1, -1):
        acc = (acc << LIMB_BITS) | int(limbs[i])
    return acc


# Base field prime (coordinates live in Fp) and scalar field prime (the
# group order; scalars live in Fr).
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# y^2 = x^3 + 3 (a = 0, b = 3, so b3 = 3b = 9 in the RCB formulas);
# generator (1, 2), cofactor 1.
A_CURVE = 0
B_CURVE = 3
GX = 1
GY = 2

# Montgomery one, and -P^-1 mod 2^16: the word-by-word REDC multiplier of
# the 16-bit-limb plain field (ops/field.py). The CUDA core uses the same
# value mod 2^32.
R_MOD_P = R % P
P_INV_NEG_16 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
P_INV_NEG_32 = (-pow(P, -1, 1 << 32)) % (1 << 32)
# -P^-1 mod 2^256: the one-shot REDC multiplier of field.mont_mul_const.
P_INV_NEG = (-pow(P, -1, R)) % R

# Montgomery constants of Fp and Fr with radix 2^256.
R2_MOD_P = (R * R) % P
R3_MOD_P = (R * R * R) % P
R_MOD_FR = R % FR
R2_MOD_FR = (R * R) % FR
FR_INV_NEG = (-pow(FR, -1, R)) % R

# Montgomery forms of the curve's constants.
GX_MONT = (GX * R) % P
GY_MONT = (GY * R) % P
B_MONT = (B_CURVE * R) % P
THREE_B_MONT = (3 * B_CURVE * R) % P

P_LIMBS = int_to_limbs(P)
R_MOD_P_LIMBS = int_to_limbs(R_MOD_P)
R2_MOD_P_LIMBS = int_to_limbs(R2_MOD_P)
P_INV_NEG_LIMBS = int_to_limbs(P_INV_NEG)
FR_LIMBS = int_to_limbs(FR)
R_MOD_FR_LIMBS = int_to_limbs(R_MOD_FR)
R2_MOD_FR_LIMBS = int_to_limbs(R2_MOD_FR)
FR_INV_NEG_LIMBS = int_to_limbs(FR_INV_NEG)
GX_MONT_LIMBS = int_to_limbs(GX_MONT)
GY_MONT_LIMBS = int_to_limbs(GY_MONT)
B_MONT_LIMBS = int_to_limbs(B_MONT)

SCALAR_BITS = FR.bit_length()  # 254
MODULUS_BITS = P.bit_length()  # 254

# P = 3 mod 4, so a square x has the root x^((P + 1) / 4).
assert P % 4 == 3
SQRT_EXP = (P + 1) // 4
