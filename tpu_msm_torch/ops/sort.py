"""The sort stage's stable digit sort (`csrc/radix_sort.cu`).

The fused route sorts each window's digits for the permutation its scan
reads (`pippenger._window_heavy`), the per-window route for its sorted
points and digits (`pippenger._msm_window`). The JAX package left this sort
to XLA: `jax.lax.sort_key_val(digits, idx0)` with int32 indices, at
`tpu_msm/ops/pippenger.py:291` (the "rank" layout) and `:514` (the
per-window route).

`digit_sort(digits, key_bits, want_keys=False)` sorts each row of (G, n) or
(n,) int32 digits in [0, 2^key_bits) stably and returns (the sorted digits,
or None unless `want_keys`; the int32 permutation). It calls the operator
`torch.ops.tpu_msm_torch.digit_sort` (ops/library.py): on CUDA tensors the
LSD radix sort of `csrc/radix_sort.cu` (ceil(key_bits / 9) passes, the
whole group of rows in one C call), on CPU tensors `digit_sort_plain`,
torch.sort(stable=True) with its indices cast to int32. A stable sort's
permutation is unique, so the two agree bit for bit. No path leads from
one to the other: a CUDA tensor launches the kernels or raises.
`digit_sort.launches` (one a C call: three kernel launches a pass) and
`digit_sort_plain.calls` count the two versions.
"""

from __future__ import annotations

import torch

from tpu_msm_torch import _build
from tpu_msm_torch.ops import library

# csrc/radix_sort.cu: at most 9 digit bits a pass and two passes.
PASS_BITS = 9
MAX_KEY_BITS = 2 * PASS_BITS
# The two int32 a key and window that a two-pass sort keeps between its
# passes (the first pass's keys and indices), beside its tile counts.
SCRATCH_BYTES_PER_KEY = 8


def key_bits(m: int) -> int:
    """The bits of window digits in [0, m + 1]: m buckets and the padding
    sentinel m + 1 (17 for c = 16 unsigned, 16 for c = 16 signed)."""
    return (m + 1).bit_length()


def _check(digits: torch.Tensor, bits: int) -> None:
    if digits.dim() not in (1, 2) or digits.dtype != torch.int32:
        raise ValueError(f"digit_sort keys must be (n,) or (G, n) int32, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    if not 1 <= bits <= MAX_KEY_BITS:
        raise ValueError(f"digit_sort sorts keys of 1 to {MAX_KEY_BITS} "
                         f"bits, got {bits}")


def digit_sort_plain(digits: torch.Tensor, key_bits: int,
                     want_keys: bool = False):
    """(sorted digits or None, int32 permutation) of each row of the (n,)
    or (G, n) int32 digits: torch.sort(stable=True) along the last axis.
    key_bits is checked, not used."""
    digit_sort_plain.calls += 1
    _check(digits, key_bits)
    keys, perm = torch.sort(digits, dim=-1, stable=True)
    return (keys if want_keys else None), perm.to(torch.int32)


digit_sort_plain.calls = 0


def _digit_sort_fake(keys, key_bits, want_keys):
    perm = torch.empty_like(keys, dtype=torch.int32)
    return (torch.empty_like(keys) if want_keys else keys.new_empty((0,)),
            perm)


def _digit_sort_cuda(keys, key_bits, want_keys):
    _check(keys, key_bits)
    if keys.dim() != 2:
        raise ValueError(f"digit_sort rows must be (G, n), got "
                         f"{tuple(keys.shape)}")
    out, perm = _digit_sort_fake(keys, key_bits, want_keys)
    g, n = keys.shape
    if g and n:
        words = _build.load().tpu_msm_digit_sort_scratch(g, n, key_bits)
        if words < 0:
            raise ValueError(f"digit_sort takes at most 65535 rows of fewer "
                             f"than 2^31 - 4096 keys, got {(g, n)}")
        scratch = torch.empty(words, dtype=torch.int32, device=keys.device)
        _build.launch("tpu_msm_digit_sort", keys.device, keys, perm,
                      out if want_keys else None, scratch, g, n, key_bits)
        digit_sort.launches += 1
    return out, perm


def _digit_sort_cpu(keys, key_bits, want_keys):
    out, perm = digit_sort_plain(keys, key_bits, want_keys)
    return (keys.new_empty((0,)) if out is None else out), perm


_DIGIT_SORT = library.define(
    "digit_sort(Tensor keys, int key_bits, bool want_keys) -> (Tensor, Tensor)",
    cuda=_digit_sort_cuda, cpu=_digit_sort_cpu, fake=_digit_sort_fake)


def digit_sort(digits: torch.Tensor, key_bits: int, want_keys: bool = False):
    """Kernel wrapper of digit_sort_plain (same arguments and result), one C
    call for all rows."""
    _build.on_cuda(digits)
    rows = digits.reshape(1, -1) if digits.dim() == 1 else digits
    keys, perm = _DIGIT_SORT(rows.contiguous(), key_bits, want_keys)
    if digits.dim() == 1:
        keys, perm = keys.reshape(-1), perm.reshape(-1)
    return (keys if want_keys else None), perm


digit_sort.launches = 0
