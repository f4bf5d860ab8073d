"""tpu_msm_torch: BN254 G1 multi-scalar multiplication in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of `tpu_msm` (JAX on a TPU), which stays in the repository as the
reference. Same entry points, same wire format, same results:

    msm_best(scalars, points, device=None)   adaptive dispatcher
    msm(points, scalars, cfg=None, device=None)
    msm_device(px, py, scalar_limbs, cfg)    the device pipeline on tensors
    ops.streaming.msm_streamed(...)          the chunked pipeline (n above
                                             STREAM_THRESHOLD)
    hybrid.msm_hybrid(...)                   card + native CPU engine split
    parallel.sharded.msm_sharded(...)        D shards in one process
    parallel.distributed.msm_distributed(...)  one shard a process
                                             (torch.distributed)
    bindings.embed.msm_best_wire(...)        wire bytes in, 64 bytes out;
                                             the C ABI's backend

Inputs are Python lists (int scalars, (x, y) int points with None for
infinity) or the JAX package's (16, N) limb arrays: Montgomery-form affine
points with (0, 0) as infinity, standard-form scalars, as uint32 numpy or
int32 tensors (on the card, they stay there).
`device` names where the pipeline runs; None means "cuda", and raises as
"cuda" does when there is no card (the CPU runs only when asked for). On
CUDA tensors every kernel of the path runs on the card; on CPU tensors
their plain PyTorch versions run.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_msm_torch.models import bn254
from tpu_msm_torch.ops import pippenger
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint
from tpu_msm_torch.utils import interop
from tpu_msm_torch.utils.config import MsmConfig, select_config
from tpu_msm_torch.utils.profiling import span

__version__ = "0.1.0"

Affine = Optional[Tuple[int, int]]

# msm_best drops zero scalars when at least this share is zero.
ZERO_FILTER_THRESHOLD = 0.30

# Below this size msm_best runs the native C++ CPU engine instead of the
# device: the measured crossover on an NVIDIA H100 80GB HBM3 (700.00 W)
# with the machine's 8 host cores (`benches/dispatch_benchmark.py
# --crossover`, medians of 10 on bench.py's inputs). The card's route
# takes 6.7 ms at 2^11 against the engine's 10.7, and 7.0 against 19.9 at
# 2^12; below 2^11 the scan lanes fall under 1024, the per-window route
# runs and takes 94-110 ms against 3.8-7.5. Override:
# TPU_MSM_CPU_THRESHOLD, read at import as the JAX package reads it.
CPU_THRESHOLD = int(os.environ.get("TPU_MSM_CPU_THRESHOLD", 1 << 11))

# Above this size msm (and so msm_best) runs the chunked pipeline
# (ops/streaming.py) in chunks of the largest power of two not above it.
# The default is the JAX package's, kept for parity. Override:
# TPU_MSM_STREAM_THRESHOLD, read at import as the JAX package reads it.
STREAM_THRESHOLD = int(os.environ.get("TPU_MSM_STREAM_THRESHOLD", 1 << 22))


def msm_device(px: torch.Tensor, py: torch.Tensor, scalar_limbs: torch.Tensor,
               cfg: MsmConfig) -> ProjPoint:
    """Device MSM on (16, N) int32 limb tensors (see limbs_to_device):
    Montgomery affine points, standard-form scalars. Returns a ProjPoint of
    (16, 1) tensors on the inputs' device."""
    return pippenger.msm_projective(AffinePoint(px, py), scalar_limbs, cfg)


def _limb_pair(points) -> bool:
    """Whether `points` is an (x_limbs, y_limbs) pair of limb arrays."""
    return (isinstance(points, (list, tuple)) and len(points) == 2
            and hasattr(points[0], "shape"))


def msm(points, scalars, cfg: MsmConfig | None = None, device=None) -> Affine:
    """MSM of oracle-style or limb-array inputs -> affine int point.

    points: list of (x, y) int tuples (None = infinity) OR an (x_limbs,
    y_limbs) pair of (16, N) Montgomery limb arrays. scalars: list of ints
    OR a (16, N) standard-form limb array. A limb array is uint32 numpy or
    an int32 tensor (`interop.limb_tensor`); tensors already on `device`
    stay there, with no host round trip. Above STREAM_THRESHOLD points the
    chunked pipeline runs (`ops/streaming.msm_streamed`, chunks of the
    largest power of two not above the threshold), as in the JAX package."""
    dev = interop.resolve_device(device)
    if _limb_pair(points):
        px, py = points
    else:
        px, py = interop.affine_points_to_limbs(points)
    if hasattr(scalars, "shape"):
        slimbs = scalars
    else:
        slimbs = interop.ints_to_limbs([int(s) % bn254.FR for s in scalars])
    n = px.shape[1]
    if n == 0:
        return None
    if n > STREAM_THRESHOLD:
        from tpu_msm_torch.ops import streaming

        res = streaming.msm_streamed(
            px, py, slimbs, cfg, chunk_log=STREAM_THRESHOLD.bit_length() - 1,
            device=dev)
    else:
        if cfg is None:
            cfg = select_config(n, dev)
        res = msm_device(*interop.limbs_to_device(px, py, slimbs, dev), cfg)
    with span("tpu_msm_torch.msm.readback"):
        [pt] = interop.proj_limbs_to_affine_points(
            *(interop.tensor_to_limbs(a) for a in res))
    return pt


def _coerce_inputs(scalars, points):
    """Normalize msm_best inputs to (16, N) px, py, scalar_limbs.

    Two forms, as `tpu_msm._coerce_inputs`:
      * lists: scalars = ints (reduced mod r here), points = (x, y) tuples
      * arrays: scalars = (16, N) standard-form limbs, already < r; points =
        a (px, py) pair of (16, N) Montgomery limb arrays.
    Arrays come back as contiguous uint32 numpy; if any of the three is a
    tensor, all three come back as int32 tensors on that tensor's device
    (`interop.limb_tensor`)."""
    if hasattr(scalars, "shape") and getattr(scalars, "ndim", 0) == 2:
        slimbs = scalars
    else:
        slimbs = interop.ints_to_limbs([int(s) % bn254.FR for s in scalars])
    px, py = (points if _limb_pair(points)
              else interop.affine_points_to_limbs(points))
    arrays = (px, py, slimbs)
    tensor = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    if tensor is not None:
        px, py, slimbs = interop.limbs_to_device(*arrays, tensor.device)
    else:
        px, py, slimbs = (np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
                          for a in arrays)
        if slimbs.ndim != 2 or slimbs.shape[0] != bn254.LIMBS:
            raise ValueError(f"scalar limb arrays must be ({bn254.LIMBS}, N)"
                             f", got {slimbs.shape}")
        if px.ndim != 2 or px.shape[0] != bn254.LIMBS or px.shape != py.shape:
            raise ValueError(f"point limb arrays must be ({bn254.LIMBS}, N) "
                             f"pairs, got {px.shape} / {py.shape}")
    if slimbs.shape[1] != px.shape[1] or px.shape != py.shape:
        raise ValueError("scalars and points must have equal length")
    return px, py, slimbs


def msm_best(scalars, points, device=None) -> Affine:
    """Adaptive MSM dispatcher (scalars first, as `tpu_msm.msm_best`).

    Drops zero scalars when at least ZERO_FILTER_THRESHOLD of them are zero,
    then runs the native C++ engine below CPU_THRESHOLD points and the
    device pipeline (`msm`, streamed above STREAM_THRESHOLD) from there up.
    Limb tensors on the card stay there (the zero scan and filter run where
    they lie); only the native engine's inputs come to the host."""
    with span("tpu_msm_torch.msm_best"):
        dev = interop.resolve_device(device)
        px, py, slimbs = _coerce_inputs(scalars, points)
        n = slimbs.shape[1]
        if n == 0:
            return None
        with span("tpu_msm_torch.msm_best.zero_scan"):
            nonzero = (slimbs != 0).any(0)
            num_zeros = n - int(nonzero.sum())
            if num_zeros == n:
                return None
            if num_zeros >= ZERO_FILTER_THRESHOLD * n:
                px, py, slimbs = (a[:, nonzero] for a in (px, py, slimbs))
        if slimbs.shape[1] < CPU_THRESHOLD:
            from tpu_msm_torch.bindings import native

            if native.available():
                return native.msm(*(interop.tensor_to_limbs(a)
                                    if isinstance(a, torch.Tensor) else a
                                    for a in (px, py, slimbs)))
        return msm((px, py), slimbs, device=dev)
