"""ctypes bindings to the native C++ CPU MSM engine (native/msm_cpu.cpp),
without jax (counterpart of `tpu_msm/bindings/native.py:43-118`).

Loads the same `native/build/libtpu_msm_cpu.so` the JAX package uses; set
TPU_MSM_NATIVE_DIR to point at another `native` tree (a prebuilt one), as
for the JAX package. When the library is missing or older than its source
it is built with `make -C <dir>` into a temporary directory and renamed into
place, so a process that has the old library mapped never sees a
half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpu_msm_torch.models import bn254

_NATIVE_DIR = Path(os.environ.get("TPU_MSM_NATIVE_DIR",
                                  Path(__file__).resolve().parents[2]
                                  / "native"))
_SO = _NATIVE_DIR / "build" / "libtpu_msm_cpu.so"

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()

Affine = Optional[Tuple[int, int]]


class NativeBuildError(RuntimeError):
    pass


def _build() -> Path:
    src = _NATIVE_DIR / "msm_cpu.cpp"
    if _SO.exists() and _SO.stat().st_mtime >= src.stat().st_mtime:
        return _SO
    _SO.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_SO.parent) as tmp:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR), f"BUILD={tmp}"],
                           check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise NativeBuildError(f"native engine build failed: {detail}") from e
        os.replace(Path(tmp) / _SO.name, _SO)
    return _SO


def _load() -> ctypes.CDLL:
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.tpu_msm_cpu_msm.argtypes = [
                u32p, u32p, u32p, ctypes.c_size_t, u32p]
            lib.tpu_msm_cpu_msm.restype = None
            lib.tpu_msm_cpu_to_affine.argtypes = [u32p, u32p]
            lib.tpu_msm_cpu_to_affine.restype = None
            lib.tpu_msm_cpu_ec_mul_batch.argtypes = [
                u32p, u32p, ctypes.c_size_t, u32p, u32p]
            lib.tpu_msm_cpu_ec_mul_batch.restype = None
            lib.tpu_msm_cpu_abi_version.argtypes = []
            lib.tpu_msm_cpu_abi_version.restype = ctypes.c_int
            if lib.tpu_msm_cpu_abi_version() != 1:
                raise NativeBuildError("native engine ABI version is not 1")
            _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except (NativeBuildError, OSError):
        return False


def _as_u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.uint32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def msm_jacobian_limbs(px, py, scalars) -> np.ndarray:
    """CPU MSM on (16, n) limb arrays (Montgomery points, standard-form
    scalars) -> the engine's (48,) uint32 Jacobian result X‖Y‖Z, Montgomery
    limbs."""
    lib = _load()
    px, py, scalars = _as_u32(px), _as_u32(py), _as_u32(scalars)
    if not (px.shape == py.shape == scalars.shape and px.shape[0] == bn254.LIMBS):
        raise ValueError(f"limb arrays must be ({bn254.LIMBS}, n) and agree")
    xyz = np.zeros(48, dtype=np.uint32)
    lib.tpu_msm_cpu_msm(_ptr(px), _ptr(py), _ptr(scalars), px.shape[1],
                        _ptr(xyz))
    return xyz


def msm(px, py, scalars) -> Affine:
    """CPU MSM on (16, n) limb arrays (Montgomery points, standard-form
    scalars) -> affine int point, or None for infinity."""
    from tpu_msm_torch.utils import interop

    xyz = msm_jacobian_limbs(px, py, scalars)
    lib = _load()
    xy = np.zeros(32, dtype=np.uint32)
    lib.tpu_msm_cpu_to_affine(_ptr(xyz), _ptr(xy))
    if not xy.any():
        return None
    [pt] = interop.limbs_to_affine_points(xy[:16].reshape(16, 1),
                                          xy[16:].reshape(16, 1))
    return pt


def ec_mul_batch(base: Affine, scalars) -> Tuple[np.ndarray, np.ndarray]:
    """out[j] = scalars[j] * base for a (16, n) standard-form scalar array;
    returns Montgomery affine (px, py) limb arrays, each (16, n)."""
    from tpu_msm_torch.utils import interop

    lib = _load()
    scalars = _as_u32(scalars)
    n = scalars.shape[1]
    bx, by = interop.affine_points_to_limbs([base])
    base_xy = np.ascontiguousarray(np.concatenate([bx[:, 0], by[:, 0]]))
    out_px = np.zeros((bn254.LIMBS, n), dtype=np.uint32)
    out_py = np.zeros((bn254.LIMBS, n), dtype=np.uint32)
    lib.tpu_msm_cpu_ec_mul_batch(_ptr(base_xy), _ptr(scalars), n,
                                 _ptr(out_px), _ptr(out_py))
    return out_px, out_py
