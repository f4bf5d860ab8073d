"""Bucket segment starts from a digit histogram (counterpart of
`tpu_msm/ops/hist.py`).

The pipeline needs s_b = #{i : digit_i < b} for every bucket b = 1..m. With
hist[d] = #{i : digit_i == d}, s_b = cumsum(hist)[b-1]. The histogram is
order-free, so it is fed the unsorted digits and does not wait for the sort.

`digit_hist` dispatches on the device: CPU tensors run `digit_hist_plain`
(torch.bincount), CUDA tensors launch the kernel in `csrc/hist.cu`, which
replaces both TPU histogram kernels of `tpu_msm/ops/hist.py`:
digit_hist_pallas2 (:171, segment_starts="hist") and digit_hist_pallas
(:107, "hist_cols"). The two compute one function; the second fed the
digits to the TPU's matrix unit in two layouts. What bounds the kernel and
what its design does about that is written in `csrc/hist.cu`.
`digit_hist.launches` and `digit_hist_plain.calls` count the two versions.
"""

from __future__ import annotations

import torch

from tpu_msm_torch import _build


def num_bins(m: int) -> int:
    """Histogram length H·256 with H = ((m+1) >> 8) + 1 rounded up to a
    multiple of 8, the JAX kernel's (H, 256) output (136·256 at m = 2^15)."""
    h = ((m + 1) >> 8) + 1
    return -(-h // 8) * 8 * 256


def digit_hist_plain(digits: torch.Tensor, m: int) -> torch.Tensor:
    """(n,) int32 digits with values <= m+1 -> (num_bins(m),) int32 counts.
    Values past the last bin are not counted, as in the kernels."""
    digit_hist_plain.calls += 1
    nb = num_bins(m)
    return torch.bincount(digits.to(torch.int64), minlength=nb)[:nb].to(
        torch.int32)


digit_hist_plain.calls = 0


def digit_hist(digits: torch.Tensor, m: int) -> torch.Tensor:
    """Kernel wrapper of digit_hist_plain (same arguments and result)."""
    if not _build.on_cuda(digits):
        return digit_hist_plain(digits, m)
    if digits.dim() != 1:
        raise ValueError(f"digits must be 1-D, got {tuple(digits.shape)}")
    nb = num_bins(m)
    out = torch.zeros(nb, dtype=torch.int32, device=digits.device)
    if digits.shape[0]:
        _build.launch("tpu_msm_digit_hist", digits.device, digits,
                      digits.shape[0], out, nb)
        digit_hist.launches += 1
    return out


digit_hist.launches = 0


def segment_starts_hist(digits: torch.Tensor, m: int) -> torch.Tensor:
    """s_b for b = 1..m from UNSORTED (n,) digits with values <= m+1 (the
    value m+1 is the padding sentinel, counted and dropped). int32 (m,)."""
    return torch.cumsum(digit_hist(digits, m)[:m], dim=0, dtype=torch.int32)


def segment_starts_hist_cols(sorted_digits: torch.Tensor, m: int) -> torch.Tensor:
    """segment_starts="hist_cols" (`tpu_msm/ops/hist.py:137`
    segment_starts_hist_pallas): the same s_b from the SORTED digits, as the
    JAX pipeline feeds that option, through the same `digit_hist` kernel."""
    return segment_starts_hist(sorted_digits, m)
