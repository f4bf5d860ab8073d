"""MSM configuration of the PyTorch port (counterpart of
`tpu_msm/utils/config.py:15-202`).

The JAX package's knobs that only chose a TPU schedule are gone:
`field_impl` (the CUDA kernels have one field core), `scan_step_batch`,
`window_batch`, `backend` (the tensor's device decides) and the
`segment_starts` options other than the two histograms. `select_config`
reads the port's own autotune table (`utils/autotune.py`, rows measured on
the H100 and keyed by "cuda") and falls back to the JAX package's size
heuristic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MsmConfig:
    """Static configuration of the Pippenger pipeline. The defaults are the
    tuned 2^20 row: c = 16 signed windows, 4096 scan lanes, fanout 2048."""

    # Window size in bits; 16 and 8 align digits with the u16 limbs, so
    # digit extraction is a limb slice (other widths are not ported).
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
    # Bucket segment starts from the digit histogram (ops/hist.py): "hist"
    # counts the unsorted digits on the fused path, "hist_cols" the sorted
    # ones, as the JAX pipeline feeds its two histogram kernels. The
    # per-window path counts the sorted digits either way.
    segment_starts: str = "hist"
    # GLV split (ops/glv.py): each scalar becomes two signed halves below
    # 2^127 and the points are doubled with phi(P) = (BETA·x, y), so the
    # pipeline runs 2n points over half the windows. Requires signed_digits
    # and scalar_bits = 254 (window_sums raises otherwise).
    glv: bool = False

    def __post_init__(self):
        if self.window_bits not in (8, 16):
            raise ValueError(
                f"window_bits must be 8 or 16, got {self.window_bits}")
        if self.segment_starts not in ("hist", "hist_cols"):
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
