"""The yardstick: the H100's published peaks and the work an MSM's inputs
need, counted from the algorithm and never from the program under test.

Peaks (one NVIDIA H100 SXM5, the card's power limit beside every reading):

* SMS = 132: NVIDIA H100 Tensor Core GPU Architecture whitepaper (H100 SXM5).
* BOOST_HZ = 1.98e9: the published maximum boost clock of the H100 SXM5.
* INT32_MUL_PER_CLOCK_PER_SM = 64: CUDA C++ Programming Guide, "Throughput of
  Native Arithmetic Instructions", compute capability 9.0, row "32-bit
  integer multiply, multiply-add, extended-precision multiply-add".
* HBM_BYTES_PER_S = 3.35e12: NVIDIA H100 datasheet, SXM, HBM3.

Work (what the inputs need, whatever implements it):

* A field product is the 8-word CIOS Montgomery product (Koc, Acar and
  Kaliski 1996): per row of the operand, 8 word products a·b[i] and 8 of
  m·p, each 32x32->64 and so counted as its low and high halves, and one
  low product m = t[0]·p' mod 2^32. 8 · (2·8 + 1 + 2·8) = 264 multiplies.
* A mixed addition (projective + affine) is Renes, Costello and Batina 2015,
  Algorithm 8 (a = 0): 11 general products (its two products by 3b are by a
  small constant and not counted).
* The bucket accumulation of Pippenger's method with c-bit windows needs one
  mixed addition for every (point, window) whose digit is nonzero.
* Bytes: the affine table (64 bytes a point), the scalars (32 bytes a point)
  and the W·(2^c - 1) projective buckets (96 bytes each) once; for the digit
  sort, each (point, window) key read once and its int32 index written once.
"""

from __future__ import annotations

SMS = 132
BOOST_HZ = 1.98e9
INT32_MUL_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12

WORDS = 8  # 32-bit words of a 254-bit field element
MULS_PER_PRODUCT = WORDS * (2 * WORDS + 1 + 2 * WORDS)  # 264
PRODUCTS_PER_MADD = 11

TABLE_BYTES_PER_POINT = 64
SCALAR_BYTES_PER_POINT = 32
BUCKET_BYTES = 96
SORT_BYTES_PER_KEY = 4 + 4


def mul_rate() -> float:
    """32-bit multiplies a second on the whole card at the boost clock."""
    return SMS * INT32_MUL_PER_CLOCK_PER_SM * BOOST_HZ


def windows(scalar_bits: int, c: int) -> int:
    return -(-scalar_bits // c)


def accumulation_s(digits: int, n: int, scalar_bits: int, c: int) -> float:
    """Least seconds of the bucket accumulation: the larger of its
    multiplies at the card's rate and its bytes at HBM's. `digits`: the
    nonzero (point, window) digits, one mixed addition each."""
    ops = digits * PRODUCTS_PER_MADD * MULS_PER_PRODUCT / mul_rate()
    buckets = windows(scalar_bits, c) * ((1 << c) - 1)
    moved = (n * (TABLE_BYTES_PER_POINT + SCALAR_BYTES_PER_POINT)
             + buckets * BUCKET_BYTES)
    return max(ops, moved / HBM_BYTES_PER_S)


def sort_s(n: int, scalar_bits: int, c: int) -> float:
    """Least seconds of sorting every window's digits: each key read once
    and its int32 index written once, at HBM's rate."""
    return windows(scalar_bits, c) * n * SORT_BYTES_PER_KEY / HBM_BYTES_PER_S


def nonzero_digits(limbs, c: int, scalar_bits: int) -> int:
    """How many (point, window) digits of c bits are nonzero, over (16, n)
    int tensors of 16-bit limbs (c at most 16, so a digit spans at most two
    limbs). The unsigned digits: the mixed additions the inputs need."""
    if not 1 <= c <= 16:
        raise ValueError(f"window bits must be 1 to 16, got {c}")
    total = 0
    for w in range(windows(scalar_bits, c)):
        limb, shift = divmod(w * c, 16)
        d = limbs[limb].long() >> shift
        if shift + c > 16 and limb + 1 < limbs.shape[0]:
            d = d | (limbs[limb + 1].long() << (16 - shift))
        total += int(((d & ((1 << c) - 1)) != 0).sum())
    return total
