"""Host <-> device data interop for the PyTorch port.

Python ints and oracle-style affine points <-> the (16, N) uint32 limb arrays
both packages take (little-endian u16 limbs, limbs first; points in
Montgomery form with (0, 0) as infinity; scalars in standard form), those
arrays <-> the wire formats of the Rust reference's two backends (arkworks'
big-endian (n, 8) u32 limbs, halo2curves' (n, 32) little-endian bytes), and
the limb arrays -> the port's device tensors (`limbs_to_device`).
Counterpart of `tpu_msm/utils/interop.py:33-184`.
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


def fp_ints_to_mont_limbs(values: Sequence[int]) -> np.ndarray:
    """Standard-form field ints -> Montgomery-form (16, n) limbs."""
    return ints_to_limbs([v * R % P for v in values])


def mont_limbs_to_fp_ints(limbs) -> List[int]:
    """Montgomery-form (16, n) limbs -> standard-form field ints."""
    return [v * _R_INV % P for v in limbs_to_ints(limbs)]


def affine_points_to_limbs(points: Sequence[Affine], mont: bool = True):
    """Oracle points (None = infinity) -> (x_limbs, y_limbs), each (16, n),
    with (0, 0) for infinity; Montgomery form unless mont=False."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    if mont:
        xs = [x * R % P for x in xs]
        ys = [y * R % P for y in ys]
    return ints_to_limbs(xs), ints_to_limbs(ys)


def limbs_to_affine_points(x_limbs, y_limbs, mont: bool = True
                           ) -> List[Affine]:
    """(16, n) limb pairs (Montgomery form unless mont=False) -> oracle
    points, (0, 0) -> None."""
    xs, ys = limbs_to_ints(x_limbs), limbs_to_ints(y_limbs)
    if mont:
        xs = [x * _R_INV % P for x in xs]
        ys = [y * _R_INV % P for y in ys]
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xs, ys)]


def _to_affine(x_limbs, y_limbs, z_limbs, zx: int, zy: int) -> List[Affine]:
    """Montgomery (X, Y, Z) limbs -> oracle affine points, on the host:
    (X / Z^zx, Y / Z^zy), infinity iff Z == 0."""
    xs, ys, zs = ([v * _R_INV % P for v in limbs_to_ints(a)]
                  for a in (x_limbs, y_limbs, z_limbs))
    out: List[Affine] = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zinv = pow(z, P - 2, P)
            out.append((x * pow(zinv, zx, P) % P, y * pow(zinv, zy, P) % P))
    return out


def proj_limbs_to_affine_points(x_limbs, y_limbs, z_limbs) -> List[Affine]:
    """Homogeneous-projective Montgomery limbs -> oracle affine points, on
    the host: x = X/Z, y = Y/Z, infinity iff Z == 0."""
    return _to_affine(x_limbs, y_limbs, z_limbs, 1, 1)


def jac_limbs_to_affine_points(x_limbs, y_limbs, z_limbs) -> List[Affine]:
    """Jacobian Montgomery limbs -> oracle affine points, on the host:
    x = X/Z^2, y = Y/Z^3, infinity iff Z == 0."""
    return _to_affine(x_limbs, y_limbs, z_limbs, 2, 3)


# The Rust reference's wire formats (`limbs_conversion.rs`).

def to_ark_u32_limbs(limbs) -> np.ndarray:
    """(16, n) u16 limbs -> arkworks' big-endian (n, 8) u32 limbs: column 0
    holds the most significant 32 bits (`limbs_conversion.rs:87-106`)."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    words = limbs[0::2] | (limbs[1::2] << np.uint32(16))  # (8, n), LE words
    return np.ascontiguousarray(words[::-1].T)


def from_ark_u32_limbs(ark) -> np.ndarray:
    """arkworks' big-endian (n, 8) u32 limbs -> (16, n) u16 limbs."""
    words = np.asarray(ark, dtype=np.uint32).T[::-1]  # (8, n), LE words
    out = np.empty((LIMBS, words.shape[1]), dtype=np.uint32)
    out[0::2] = words & np.uint32(0xFFFF)
    out[1::2] = words >> np.uint32(16)
    return out


def to_h2c_bytes(limbs) -> np.ndarray:
    """(16, n) limbs -> halo2curves' (n, 32) little-endian bytes (the
    reference's byte reversal, `limbs_conversion.rs:239-280`)."""
    limbs16 = np.asarray(limbs, dtype=np.uint32).astype("<u2")
    return np.ascontiguousarray(limbs16.T).view(np.uint8).reshape(-1, 32)


def from_h2c_bytes(data) -> np.ndarray:
    """halo2curves' (n, 32) little-endian bytes -> (16, n) limbs."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    limbs16 = data.view("<u2").reshape(-1, LIMBS)
    return np.ascontiguousarray(limbs16.T).astype(np.uint32)


def resolve_device(device) -> torch.device:
    """The device the pipeline runs on: None means "cuda". Asking for CUDA
    without a card raises rather than running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available")
    return device


def limb_tensor(a, device) -> torch.Tensor:
    """One (16, N) limb array -> a (16, N) int32 tensor on `device`.

    A tensor must already be int32 (the port's layout) and moves only if it
    lies elsewhere: one on `device` is returned as it is, with no host
    round trip. A numpy array (uint32) is viewed as int32 and copied over.
    int32 carries the u32 bit pattern; torch's uint32 lacks sort,
    index_select, cumsum and where on CUDA. Limbs are < 2^16, so the values
    are the same either way."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.int32:
            raise ValueError(f"limb tensors must be int32, got {a.dtype}")
        t = a
    else:
        arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        t = torch.from_numpy(arr.view(np.int32))
    if t.dim() != 2 or t.shape[0] != LIMBS:
        raise ValueError(f"limb arrays must be ({LIMBS}, N), got "
                         f"{tuple(t.shape)}")
    return t.to(device).contiguous()


def limbs_to_device(px, py, scalars, device) -> Tuple[torch.Tensor, ...]:
    """(16, N) limb arrays (uint32 numpy, or int32 tensors on any device)
    -> (16, N) int32 tensors on `device` (see limb_tensor)."""
    return tuple(limb_tensor(a, device) for a in (px, py, scalars))


def tensor_to_limbs(t: torch.Tensor) -> np.ndarray:
    """(16, N) int32 limb tensor (any device) -> (16, N) uint32 numpy."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
