"""256-bit limb arithmetic on torch tensors (counterpart of
`tpu_msm/ops/u256.py`): `zeros`, `from_const` (and `const`, a cached constant
shaped like a tensor), `add`/`sub` with carry out, `geq`, `mul_full`,
`mul_lo`, `mul_const`, `shl`, `shr`, `test_bit`, `extract_bits`.

A value is a (k, *batch) integer tensor of little-endian 16-bit limbs,
limbs first (k = 16 for a 256-bit value). Any signed integer dtype with room
for a 17-bit limb sum works (the pipeline passes int32, the plain kernels
compute in int64); the products compute in int64 and return the input's
dtype. Where the JAX package resolves carries by scans for the TPU, these
ripple them limb by limb (`normalize`): the same canonical limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_msm_torch.models.bn254 import LIMB_BITS, LIMB_MASK, LIMBS


def zeros(batch_shape, limbs: int = LIMBS, device="cpu",
          dtype=torch.int32) -> torch.Tensor:
    return torch.zeros((limbs, *batch_shape), dtype=dtype, device=device)


def from_const(limbs_np, batch_ndim: int = 1, device="cpu",
               dtype=torch.int32) -> torch.Tensor:
    """A constant limb vector (e.g. bn254.P_LIMBS) -> a (k, 1, ..., 1)
    tensor with `batch_ndim` unit axes, which broadcasts over a batch."""
    t = torch.as_tensor(np.asarray(limbs_np, dtype=np.int64), dtype=dtype,
                        device=device)
    return t.reshape(t.shape[0], *([1] * batch_ndim))


def const(value: int, like: torch.Tensor, limbs: int = LIMBS) -> torch.Tensor:
    """(limbs, 1, ..., 1) tensor of `value`'s limbs (mod 2^(16·limbs)) that
    broadcasts against `like`, on its device and in its dtype. Read-only: it
    is cached, so a plain op on the card does not copy the constant to the
    device on every call. Under `torch.export` (or any compile) it is made
    anew, so that no traced tensor enters the cache."""
    if torch.compiler.is_compiling():
        return _const.__wrapped__(value, like.dtype, like.device, like.dim(),
                                  limbs)
    return _const(value, like.dtype, like.device, like.dim(), limbs)


@functools.lru_cache(maxsize=64)
def _const(value: int, dtype, device, ndim: int, limbs: int) -> torch.Tensor:
    vals = [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(limbs)]
    t = torch.tensor(vals, dtype=dtype, device=device)
    return t.reshape((limbs,) + (1,) * (ndim - 1))


def normalize(cols: torch.Tensor):
    """Exact sequential carry propagation over the limb axis.

    cols: (k, *batch) limb columns of either sign (a column may hold a sum
    of products or a negative difference). Returns (canonical limbs, final
    carry); the carry is negative when the value was negative (a borrow),
    since the arithmetic shift keeps the sign."""
    rows = []
    carry = None
    for v in cols.unbind(0):
        if carry is not None:
            v = v + carry
        rows.append(v)
        carry = v >> LIMB_BITS
    return torch.stack(rows) & LIMB_MASK, carry


def add(a, b):
    """a + b -> (limbs mod 2^(16k), carry out in {0, 1})."""
    return normalize(a + b)


def sub(a, b):
    """a - b -> (limbs mod 2^(16k), borrow out in {0, 1})."""
    limbs, carry = normalize(a - b)
    return limbs, -carry


def geq(a, b):
    """a >= b, per batch element."""
    return sub(a, b)[1] == 0


def test_bit(a, k: int):
    """Bit k of each batch element (0 or 1)."""
    limb, bit = divmod(k, LIMB_BITS)
    return (a[limb] >> bit) & 1


# The widest field extract_bits takes: two adjacent limbs hold any 17 bits
# (the JAX package asserts the same bound).
EXTRACT_MAX_BITS = LIMB_BITS + 1


def extract_bits(a, start: int, width: int):
    """Bits [start, start + width) of each batch element, 0 < width <=
    EXTRACT_MAX_BITS (`tpu_msm/ops/u256.py:278-290`). The high limb is
    masked before its shift, so the result stays below 2^width in any
    integer dtype."""
    if not 0 < width <= EXTRACT_MAX_BITS:
        raise ValueError(f"extract_bits takes 1 to {EXTRACT_MAX_BITS} bits, "
                         f"got {width}")
    limb, bit = divmod(start, LIMB_BITS)
    v = a[limb] >> bit
    low = LIMB_BITS - bit  # bits that the first limb gives
    if low < width and limb + 1 < a.shape[0]:
        v = v | ((a[limb + 1] & ((1 << (width - low)) - 1)) << low)
    return v & ((1 << width) - 1)


def mul_const(a, b_int: int, n_out: int):
    """(k, *batch) limbs times the integer constant b_int -> n_out limbs,
    exact mod 2^(16·n_out). One multiply-add of the (k, *batch) slab per
    nonzero limb of b_int into int64 columns (each below 2^37 for k <= 32),
    then one carry ripple; no (k, k, *batch) outer product."""
    k = a.shape[0]
    cols = torch.zeros((n_out + k, *a.shape[1:]), dtype=torch.int64,
                       device=a.device)
    a64 = a.to(torch.int64)
    nb = -(-max(b_int.bit_length(), 1) // LIMB_BITS)
    for j in range(min(nb, n_out)):
        bj = (b_int >> (LIMB_BITS * j)) & LIMB_MASK
        if bj:
            cols[j:j + k].add_(a64, alpha=bj)
    limbs, _ = normalize(cols[:n_out])
    return limbs.to(a.dtype)


def product_columns(a, b, n_out: int):
    """The int64 column sums of a·b below limb n_out (no carries): column k
    holds sum_i a_i·b_(k-i), below 16·2^32 = 2^36."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    cols = torch.zeros((n_out, *batch), dtype=torch.int64, device=a.device)
    for i in range(min(a.shape[0], n_out)):
        width = min(b.shape[0], n_out - i)
        cols[i:i + width].addcmul_(a64[i], b64[:width])
    return cols


def mul_full(a, b):
    """(k, *batch) x (k, *batch) -> the exact (2k, *batch) product."""
    limbs, _ = normalize(product_columns(a, b, a.shape[0] + b.shape[0]))
    return limbs.to(a.dtype)


def mul_lo(a, b):
    """The product's low k limbs, a·b mod 2^(16k)."""
    limbs, _ = normalize(product_columns(a, b, a.shape[0]))
    return limbs.to(a.dtype)


def shl(a, k: int):
    """Logical left shift by k bits, mod 2^(16·limbs)."""
    return _shift(a, k)


def shr(a, k: int):
    """Logical right shift by k bits."""
    return _shift(a, -k)


def _shift(a, k: int):
    """a·2^k (k >= 0) mod 2^(16·limbs), or floor(a·2^k) (k < 0): each limb
    is the two source limbs it straddles."""
    n = a.shape[0]
    limb_off, bit_off = divmod(k, LIMB_BITS)  # floor: bit_off in [0, 16)
    zero = torch.zeros_like(a[0])
    rows = []
    for i in range(n):
        lo, hi = i - limb_off, i - limb_off - 1
        v = ((a[lo] << bit_off) & LIMB_MASK) if 0 <= lo < n else zero
        if bit_off and 0 <= hi < n:
            v = v | (a[hi] >> (LIMB_BITS - bit_off))
        rows.append(v)
    return torch.stack(rows)


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(cond, a, b):
    """Per-lane select: cond is (*batch) bool, a and b (16, *batch)."""
    return torch.where(cond, a, b)

