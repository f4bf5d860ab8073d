"""tpu_msm_torch: BN254 G1 multi-scalar multiplication in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of `tpu_msm` (JAX on a TPU), which stays in the repository as the
reference. Same entry points, same wire format, same results:

    msm_best(scalars, points, device=None)   adaptive dispatcher
    msm(points, scalars, cfg=None, device=None)
    msm_device(px, py, scalar_limbs, cfg)    the device pipeline on tensors

Inputs are Python lists (int scalars, (x, y) int points with None for
infinity) or the JAX package's (16, N) uint32 limb arrays: Montgomery-form
affine points with (0, 0) as infinity, standard-form scalars.
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

__version__ = "0.1.0"

Affine = Optional[Tuple[int, int]]

# msm_best drops zero scalars when at least this share is zero.
ZERO_FILTER_THRESHOLD = 0.30

# Below this size msm_best runs the native C++ CPU engine instead of the
# device. The default is inherited from the JAX package for parity and has
# not been measured on the H100 yet. Override: TPU_MSM_CPU_THRESHOLD, read
# at import as the JAX package reads it.
CPU_THRESHOLD = int(os.environ.get("TPU_MSM_CPU_THRESHOLD", 1 << 12))


def _device(device) -> torch.device:
    """The device the pipeline runs on: None means "cuda". Asking for CUDA
    without a card raises rather than running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available")
    return device


def msm_device(px: torch.Tensor, py: torch.Tensor, scalar_limbs: torch.Tensor,
               cfg: MsmConfig) -> ProjPoint:
    """Device MSM on (16, N) int32 limb tensors (see limbs_to_device):
    Montgomery affine points, standard-form scalars. Returns a ProjPoint of
    (16, 1) tensors on the inputs' device."""
    return pippenger.msm_projective(AffinePoint(px, py), scalar_limbs, cfg)


def msm(points, scalars, cfg: MsmConfig | None = None, device=None) -> Affine:
    """MSM of oracle-style or limb-array inputs -> affine int point.

    points: list of (x, y) int tuples (None = infinity) OR an (x_limbs,
    y_limbs) pair of (16, N) Montgomery limb arrays. scalars: list of ints
    OR a (16, N) standard-form limb array. No streaming route yet: every
    size runs unstreamed (see pippenger._window_heavy for the memory)."""
    dev = _device(device)
    if isinstance(points, (list, tuple)) and len(points) == 2 \
            and hasattr(points[0], "shape"):
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
    if cfg is None:
        cfg = select_config(n, dev)
    res = msm_device(*interop.limbs_to_device(px, py, slimbs, dev), cfg)
    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


def _coerce_inputs(scalars, points):
    """Normalize msm_best inputs to ((16, N) px, py, scalar_limbs) numpy.

    Two forms, as `tpu_msm._coerce_inputs`:
      * lists: scalars = ints (reduced mod r here), points = (x, y) tuples
      * arrays: scalars = (16, N) standard-form limbs, already < r; points =
        a (px, py) pair of (16, N) Montgomery limb arrays."""
    if hasattr(scalars, "shape") and getattr(scalars, "ndim", 0) == 2:
        slimbs = np.ascontiguousarray(np.asarray(scalars, dtype=np.uint32))
        if slimbs.shape[0] != bn254.LIMBS:
            raise ValueError(f"scalar limb arrays must be ({bn254.LIMBS}, N), "
                             f"got {slimbs.shape}")
    else:
        slimbs = interop.ints_to_limbs([int(s) % bn254.FR for s in scalars])
    if (isinstance(points, (list, tuple)) and len(points) == 2
            and hasattr(points[0], "shape")):
        px = np.ascontiguousarray(np.asarray(points[0], dtype=np.uint32))
        py = np.ascontiguousarray(np.asarray(points[1], dtype=np.uint32))
        if px.shape[0] != bn254.LIMBS or px.shape != py.shape:
            raise ValueError(f"point limb arrays must be ({bn254.LIMBS}, N) "
                             f"pairs, got {px.shape} / {py.shape}")
    else:
        px, py = interop.affine_points_to_limbs(points)
    if slimbs.shape[1] != px.shape[1]:
        raise ValueError("scalars and points must have equal length")
    return px, py, slimbs


def msm_best(scalars, points, device=None) -> Affine:
    """Adaptive MSM dispatcher (scalars first, as `tpu_msm.msm_best`).

    Drops zero scalars when at least ZERO_FILTER_THRESHOLD of them are zero,
    then runs the native C++ engine below CPU_THRESHOLD points and the
    device pipeline (`msm`) from there up."""
    dev = _device(device)
    px, py, slimbs = _coerce_inputs(scalars, points)
    n = slimbs.shape[1]
    if n == 0:
        return None
    nonzero = (slimbs != 0).any(axis=0)
    num_zeros = n - int(np.count_nonzero(nonzero))
    if num_zeros == n:
        return None
    if num_zeros >= ZERO_FILTER_THRESHOLD * n:
        px = np.ascontiguousarray(px[:, nonzero])
        py = np.ascontiguousarray(py[:, nonzero])
        slimbs = np.ascontiguousarray(slimbs[:, nonzero])
    if slimbs.shape[1] < CPU_THRESHOLD:
        from tpu_msm_torch.bindings import native

        if native.available():
            return native.msm(px, py, slimbs)
    return msm((px, py), slimbs, device=dev)
