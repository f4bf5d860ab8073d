"""MSM configuration of the PyTorch port (counterpart of
`tpu_msm/utils/config.py:15-202`).

The JAX package's knobs that only chose a TPU schedule are gone:
`field_impl` (the CUDA kernels have one field core), `scan_step_batch`,
`window_batch`, `backend` (the tensor's device decides) and `sort_impl`.
`window_bits` and `segment_starts` take every value the JAX package takes.
`select_config` reads the port's own autotune table (`utils/autotune.py`,
rows measured on the H100 and keyed by "cuda") and falls back to the JAX
package's size heuristic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_msm_torch.ops.u256 import EXTRACT_MAX_BITS

SEGMENT_STARTS = ("bincount", "ss_scan", "ss_sort", "ss_2level", "hist",
                  "hist_cols")


@dataclass(frozen=True)
class MsmConfig:
    """Static configuration of the Pippenger pipeline. The defaults are the
    JAX package's large-size TPU row (c = 16 signed windows, 4096 scan
    lanes, fanout 2048), not the port's tuned row: `select_config` reads
    that from the autotune table (on the H100, c = 16 unsigned and 8192
    lanes at 2^16-2^20, fanout 2048 up to 2^18 and 1024 at 2^20)."""

    # Window size in bits, 1 to 17 (`u256.EXTRACT_MAX_BITS`, the widest
    # field the JAX package's digit extraction takes). With 16 and 8 the
    # digits are the u16 limbs or their halves; other widths are extracted
    # bit by bit (`pippenger.window_digits`).
    window_bits: int = 16
    # Independent lanes of the per-window prefix scan (one CUDA thread each).
    scan_lanes: int = 4096
    # Lane width the X(s_b) batch is folded down to before the rolled tree.
    reduce_fanout: int = 2048
    # Significant scalar bits; scalars MUST be < 2^scalar_bits.
    scalar_bits: int = 254
    # Balanced digits in [-2^(c-1), 2^(c-1)]: half the buckets, and the
    # M·X(n) term becomes c-1 doublings.
    signed_digits: bool = True
    # How the bucket segment starts s_b are found (`pippenger._segment_starts`,
    # the JAX package's six values): "hist" counts the unsorted digits with
    # the digit_hist kernel on the fused path, "hist_cols" the sorted ones,
    # as the JAX pipeline feeds its two histogram kernels (the per-window
    # path counts the sorted digits either way); "bincount" is
    # torch.bincount of the sorted digits and a cumsum; "ss_scan",
    # "ss_sort" and "ss_2level" are torch.searchsorted of 1..m in the
    # sorted digits (the JAX package's three search schedules for the TPU).
    # All give the same exact starts.
    segment_starts: str = "hist"
    # GLV split (ops/glv.py): each scalar becomes two signed halves below
    # 2^127 and the points are doubled with phi(P) = (BETA·x, y), so the
    # pipeline runs 2n points over half the windows. Requires signed_digits
    # and scalar_bits = 254 (window_sums raises otherwise).
    glv: bool = False

    def __post_init__(self):
        if not 1 <= self.window_bits <= EXTRACT_MAX_BITS:
            raise ValueError(f"window_bits must be 1 to {EXTRACT_MAX_BITS}, "
                             f"got {self.window_bits}")
        if self.segment_starts not in SEGMENT_STARTS:
            raise ValueError(
                f"unknown segment_starts {self.segment_starts!r}")
        for name in ("scan_lanes", "reduce_fanout", "scalar_bits"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    def num_windows(self) -> int:
        bits = self.scalar_bits + (1 if self.signed_digits else 0)
        return -(-bits // self.window_bits)

    def buckets_per_window(self) -> int:
        if self.signed_digits:
            return 1 << (self.window_bits - 1)
        return (1 << self.window_bits) - 1


def _clamp_lanes(lanes: int, n: int) -> int:
    """Halve the scan lanes until inputs are not spread thinner than two
    points per lane (`tpu_msm/utils/config.py:171-173`)."""
    while lanes > 8 and lanes * 2 > n:
        lanes //= 2
    return lanes


def select_config(n: int, device=None) -> MsmConfig:
    """The configuration for an MSM of n points on `device` (None means
    "cuda"): the nearest measured row of the autotune table for the
    device's type (`autotune.lookup`), else the JAX package's heuristic
    (`tpu_msm/utils/config.py:184-202`, without `field_impl`): c = 8
    unsigned below 2^17 points, c = 16 signed from there, 8192 lanes,
    fanout 4096. There are no "cpu" rows, so the CPU gets the heuristic."""
    from tpu_msm_torch.utils import autotune

    platform = torch.device("cuda" if device is None else device).type
    tuned = autotune.lookup(n, platform)
    if tuned is not None:
        return MsmConfig(
            window_bits=tuned["window_bits"],
            scan_lanes=_clamp_lanes(tuned["scan_lanes"], n),
            reduce_fanout=tuned["reduce_fanout"],
            signed_digits=tuned["signed_digits"],
            segment_starts=tuned.get("segment_starts", "hist"),
            glv=tuned.get("glv", False))
    big = n >= 1 << 17
    return MsmConfig(window_bits=16 if big else 8,
                     scan_lanes=_clamp_lanes(8192, n), reduce_fanout=4096,
                     signed_digits=big)
