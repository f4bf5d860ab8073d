"""MSM configuration of the PyTorch port (counterpart of
`tpu_msm/utils/config.py:15-202`).

The JAX package's knobs that only chose a TPU schedule are gone:
`field_impl` (the CUDA kernels have one field core), `scan_step_batch`,
`window_batch`, `backend` (the tensor's device decides) and the
`segment_starts` options other than the two histograms. GLV and the autotune
table are not ported yet, so `select_config` returns the tuned 2^20 row of
`tpu_msm/utils/tuned_configs.json` for every size.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


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


def select_config(n: int) -> MsmConfig:
    """The tuned row for every n, with the scan lanes clamped so that small
    inputs are not spread thinner than two points per lane
    (`tpu_msm/utils/config.py:171-173`)."""
    cfg = MsmConfig()
    lanes = cfg.scan_lanes
    while lanes > 8 and lanes * 2 > n:
        lanes //= 2
    return replace(cfg, scan_lanes=lanes)
