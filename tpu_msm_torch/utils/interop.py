"""Host <-> device data interop for the PyTorch port.

Python ints and oracle-style affine points <-> the (16, N) uint32 limb arrays
both packages take (little-endian u16 limbs, limbs first; points in
Montgomery form with (0, 0) as infinity; scalars in standard form), and
those numpy arrays -> the port's device tensors (`limbs_to_device`).
Counterpart of `tpu_msm/utils/interop.py:33-119`; the arkworks and
halo2curves byte formats are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_msm_torch.models.bn254 import LIMB_BITS, LIMBS, P, R

Affine = Optional[Tuple[int, int]]

_R_INV = pow(R, -1, P)


def ints_to_limbs(values: Sequence[int]) -> np.ndarray:
    """List of ints (< 2^256) -> (16, n) uint32 little-endian u16 limbs."""
    n = len(values)
    buf = np.frombuffer(
        b"".join(int(v).to_bytes(32, "little") for v in values), dtype="<u2"
    ).reshape(n, LIMBS)
    return np.ascontiguousarray(buf.T).astype(np.uint32)


def limbs_to_ints(limbs) -> List[int]:
    """(k, n) array of canonical (< 2^16) limbs -> list of Python ints."""
    limbs = np.asarray(limbs)
    k, n = limbs.shape
    if n and limbs.max(initial=0) >= (1 << LIMB_BITS):
        raise ValueError("limbs must be canonical (< 2^16)")
    data = np.ascontiguousarray(limbs.T.astype("<u2")).tobytes()
    step = 2 * k
    return [int.from_bytes(data[j * step:(j + 1) * step], "little")
            for j in range(n)]


def affine_points_to_limbs(points: Sequence[Affine]):
    """Oracle points (None = infinity) -> Montgomery (x_limbs, y_limbs), each
    (16, n), with (0, 0) for infinity."""
    xs = [0 if p is None else p[0] * R % P for p in points]
    ys = [0 if p is None else p[1] * R % P for p in points]
    return ints_to_limbs(xs), ints_to_limbs(ys)


def limbs_to_affine_points(x_limbs, y_limbs) -> List[Affine]:
    """Montgomery (16, n) limb pairs -> oracle points, (0, 0) -> None."""
    xs = [x * _R_INV % P for x in limbs_to_ints(x_limbs)]
    ys = [y * _R_INV % P for y in limbs_to_ints(y_limbs)]
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def proj_limbs_to_affine_points(x_limbs, y_limbs, z_limbs) -> List[Affine]:
    """Homogeneous-projective Montgomery limbs -> oracle affine points, on
    the host: x = X/Z, y = Y/Z, infinity iff Z == 0."""
    xs, ys, zs = ([v * _R_INV % P for v in limbs_to_ints(a)]
                  for a in (x_limbs, y_limbs, z_limbs))
    out: List[Affine] = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zinv = pow(z, P - 2, P)
            out.append((x * zinv % P, y * zinv % P))
    return out


def limbs_to_device(px, py, scalars, device) -> Tuple[torch.Tensor, ...]:
    """(16, N) uint32 numpy limb arrays -> (16, N) int32 tensors on `device`.

    int32 carries the u32 bit pattern (a zero-copy numpy view); torch's
    uint32 lacks sort, index_select, cumsum and where on CUDA. Limbs are
    < 2^16, so the values are the same either way."""
    out = []
    for a in (px, py, scalars):
        arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        if arr.ndim != 2 or arr.shape[0] != LIMBS:
            raise ValueError(f"limb arrays must be ({LIMBS}, N), got {arr.shape}")
        out.append(torch.from_numpy(arr.view(np.int32)).to(device))
    return tuple(out)


def tensor_to_limbs(t: torch.Tensor) -> np.ndarray:
    """(16, N) int32 limb tensor (any device) -> (16, N) uint32 numpy."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
