"""Bucket segment starts from a digit histogram (counterpart of
`tpu_msm/ops/hist.py`).

The pipeline needs s_b = #{i : digit_i < b} for every bucket b = 1..m. With
hist[d] = #{i : digit_i == d}, s_b = cumsum(hist)[b-1]. The histogram is
order-free, so it is fed the unsorted digits and does not wait for the sort.

`digit_hist` counts one window's digits, (n,) -> (num_bins(m),), or a group
of G windows' in one launch, (G, n) -> (G, num_bins(m)). It dispatches on
the device: CPU tensors run `digit_hist_plain` (torch.bincount), CUDA
tensors launch the kernel in `csrc/hist.cu`, which replaces both TPU
histogram kernels of `tpu_msm/ops/hist.py`: digit_hist_pallas2 (:171,
segment_starts="hist") and digit_hist_pallas (:107, "hist_cols"). The two
compute one function; the second fed the digits to the TPU's matrix unit in
two layouts. The kernel counts in shared memory, one block a chunk of one
window; `plan` picks its regime from the bins the digits can reach (m + 2),
and `csrc/hist.cu` says what bounds each.
`digit_hist` calls the operator `torch.ops.tpu_msm_torch.digit_hist`
(ops/library.py) on the (G, n) rows, with the launch plan as its integer
arguments: the kernel is its CUDA implementation, `digit_hist_plain` its
CPU one. `digit_hist.launches` (counted by the CUDA implementation) and
`digit_hist_plain.calls` count the two versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_msm_torch import _build
from tpu_msm_torch.ops import library

# csrc/hist.cu's threads a block, and the shared memory of the H100 (sm_90):
# what one block may take as dynamic shared memory (227 KB), and an SM's
# (228 KB, of which the runtime keeps 1 KB for each resident block).
THREADS = 1024
SMEM_BLOCK = 232448
SMEM_SM = 233472
THREADS_SM = 2048
# The most digits a block counts with 16-bit counters (none can overflow).
U16_CHUNK = 0xFFFF


def num_bins(m: int) -> int:
    """Histogram length H·256 with H = ((m+1) >> 8) + 1 rounded up to a
    multiple of 8, the JAX kernel's (H, 256) output (136·256 at m = 2^15)."""
    h = ((m + 1) >> 8) + 1
    return -(-h // 8) * 8 * 256


class Plan(NamedTuple):
    """One launch of the histogram kernel (csrc/hist.cu)."""
    regime: str     # "fits", "split" or "u16"
    held: int       # bins [0, held) are counted in shared memory
    parts: int      # blocks that share a chunk, each a range of the bins
    part_bins: int  # bins a block holds
    chunk: int      # digits a block reads
    chunks: int     # chunks a window
    smem: int       # bytes of dynamic shared memory a block


def plan(g: int, n: int, m: int, sm_count: int,
         big: str | None = None) -> Plan:
    """The kernel's launch for G windows of n digits with m buckets on a
    card of `sm_count` SMs. The digits reach bins 0..m+1 (m+1 is the
    padding sentinel), so held = min(num_bins(m), m+2) bins live in shared
    memory: int32 counters in one block where they fit (every c <= 15, c =
    16 signed), else the regime `big` names: 16-bit counters ("u16") where
    their chunks of at most U16_CHUNK digits give every SM a block (the
    faster at (16, 2^20) on the H100), else the bins split over blocks
    ("split", which can cut a few windows finer). Chunks fill one wave of
    blocks, but a chunk holds at least a quarter of a block's bins, so that
    its flush reads at most four counters a digit."""
    if big is None:
        big = "u16" if g * -(-n // U16_CHUNK) >= sm_count else "split"
    held = min(num_bins(m), m + 2)
    if held * 4 <= SMEM_BLOCK:
        regime, counter = "fits", 4
    elif big in ("split", "u16"):
        regime, counter = big, 4 if big == "split" else 2
    else:
        raise ValueError(f"unknown histogram regime {big!r}")
    parts = -(-held * counter // SMEM_BLOCK)
    part_bins = -(-held // parts)
    part_bins += part_bins % 2 if counter == 2 else 0  # whole words
    parts = -(-held // part_bins)
    smem = part_bins * counter
    per_sm = max(1, min(SMEM_SM // (smem + 1024), THREADS_SM // THREADS))
    chunks = max(1, sm_count * per_sm // (g * parts))
    chunk = max(-(-n // chunks), -(-part_bins // 4))
    if regime == "u16":
        chunk = min(chunk, U16_CHUNK)
    return Plan(regime, held, parts, part_bins, chunk, -(-n // chunk), smem)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def digit_hist_plain(digits: torch.Tensor, m: int) -> torch.Tensor:
    """(n,) or (G, n) int32 digits -> (num_bins(m),) or (G, num_bins(m))
    int32 counts: torch.bincount of row·nb + digit. Values past the last
    bin are not counted, as in the kernels."""
    digit_hist_plain.calls += 1
    nb = num_bins(m)
    rows = digits if digits.dim() == 2 else digits.reshape(1, -1)
    g = rows.shape[0]
    d = rows.to(torch.int64)
    offset = nb * torch.arange(g, device=d.device)[:, None]
    flat = torch.where(d < nb, d + offset, g * nb).reshape(-1)
    out = torch.bincount(flat, minlength=g * nb + 1)[:g * nb].view(g, nb)
    out = out.to(torch.int32)
    return out if digits.dim() == 2 else out[0]


digit_hist_plain.calls = 0


def _digit_hist_fake(rows, m, held, part_bins, parts, chunk, u16):
    return torch.empty((rows.shape[0], num_bins(m)), dtype=torch.int32,
                       device=rows.device)


def _digit_hist_cuda(rows, m, held, part_bins, parts, chunk, u16):
    # The C entry checks the rest of the plan; bins past num_bins(m) would
    # be written past each row of the output.
    if rows.dim() != 2:
        raise ValueError(f"digit_hist rows must be (G, n), got "
                         f"{tuple(rows.shape)}")
    g, n = rows.shape
    nb = num_bins(m)
    if held > nb:
        raise ValueError(f"digit_hist plan holds {held} bins of {nb}")
    out = torch.zeros((g, nb), dtype=torch.int32, device=rows.device)
    if g and n:
        _build.launch("tpu_msm_digit_hist", rows.device, rows, g, n, out, nb,
                      held, part_bins, parts, chunk, u16)
        digit_hist.launches += 1
    return out


def _digit_hist_cpu(rows, m, held, part_bins, parts, chunk, u16):
    return digit_hist_plain(rows, m)


_DIGIT_HIST = library.define(
    "digit_hist(Tensor rows, int m, int held, int part_bins, int parts, "
    "int chunk, int u16) -> Tensor",
    cuda=_digit_hist_cuda, cpu=_digit_hist_cpu, fake=_digit_hist_fake)


def digit_hist(digits: torch.Tensor, m: int,
               big: str | None = None) -> torch.Tensor:
    """Kernel wrapper of digit_hist_plain (same arguments and result), one
    launch for all rows; `big` forces `plan`'s regime for bins that do not
    fit one block as int32 ("split" or "u16")."""
    launch = (0,) * 5  # the CPU has no launch plan
    if _build.on_cuda(digits):
        if digits.dim() not in (1, 2):
            raise ValueError(f"digits must be (n,) or (G, n), got "
                             f"{tuple(digits.shape)}")
        g, n = digits.shape if digits.dim() == 2 else (1, digits.shape[0])
        if g and n:  # else no launch
            p = plan(g, n, m, _sm_count(digits.device), big)
            launch = (p.held, p.part_bins, p.parts, p.chunk,
                      int(p.regime == "u16"))
    rows = digits if digits.dim() == 2 else digits.reshape(1, -1)
    out = _DIGIT_HIST(rows, m, *launch)
    return out if digits.dim() == 2 else out[0]


digit_hist.launches = 0


def segment_starts_hist(digits: torch.Tensor, m: int) -> torch.Tensor:
    """s_b for b = 1..m from (n,) or (G, n) digits in any order with values
    <= m+1 (the value m+1 is the padding sentinel, counted and dropped).
    int32 (m,) or (G, m)."""
    return torch.cumsum(digit_hist(digits, m)[..., :m], dim=-1,
                        dtype=torch.int32)


def segment_starts_hist_cols(sorted_digits: torch.Tensor, m: int) -> torch.Tensor:
    """segment_starts="hist_cols" (`tpu_msm/ops/hist.py:137`
    segment_starts_hist_pallas): the same s_b from the SORTED digits, as the
    JAX pipeline feeds that option, through the same `digit_hist` kernel."""
    return segment_starts_hist(sorted_digits, m)
