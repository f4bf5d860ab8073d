"""BN254 base-field and curve parameters for the PyTorch port.

The two primes and the generator are the definition; every other constant
is derived from them here at import time, as in `tpu_msm/models/bn254.py`.
Python ints only (no torch, no jax), so the host-side interop and the native
binding import it cheaply.

Limb layout: a 256-bit value is 16 little-endian 16-bit limbs, limbs first,
one limb per 32-bit lane — the JAX package's wire format, which both
packages accept. The CUDA kernels read the same value as 8 little-endian
32-bit words (word i = limb 2i | limb 2i+1 << 16).
"""

from __future__ import annotations

LIMB_BITS = 16
LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R = 1 << (LIMB_BITS * LIMBS)  # Montgomery radix 2^256

# Base field prime (coordinates live in Fp) and scalar field prime (the
# group order; scalars live in Fr).
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# y^2 = x^3 + 3 (a = 0, b = 3, so b3 = 3b = 9 in the RCB formulas);
# generator (1, 2), cofactor 1.
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
