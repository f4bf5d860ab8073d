"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, `build/tpu_msm_torch/libtpu_msm_torch_kernels.so` under
the repository root (git-ignored), at first use and again whenever a source
is newer than the library. ctypes loads it. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "tpu_msm_torch"
LIB_PATH = BUILD_DIR / "libtpu_msm_torch_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit

    if CUDA_HOME is None:
        raise KernelBuildError("no CUDA toolkit found (CUDA_HOME is unset "
                               "and nvcc is not on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> dict:
    """Compile the kernels if the library is missing or stale. Returns
    {"built": bool, "seconds": float, "log": nvcc's output (ptxas registers
    and spills), "lib": path}."""
    srcs = _sources()
    newest = max(p.stat().st_mtime for p in srcs)
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        log = LOG_PATH.read_text() if LOG_PATH.exists() else ""
        return {"built": False, "seconds": 0.0, "log": log, "lib": str(LIB_PATH)}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # Build in a temporary directory and rename the library into place, so
    # a process that has the old library loaded never sees a half-written
    # one.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [p for p in srcs if p.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in cus]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", o, str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cus, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        failed = [p.name for p, proc in zip(cus, procs) if proc.returncode]
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{log}")
        out = Path(tmp) / LIB_PATH.name
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
                               *objs], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{log}")
        os.replace(out, LIB_PATH)
    LOG_PATH.write_text(log)
    return {"built": True, "seconds": time.perf_counter() - t0, "log": log,
            "lib": str(LIB_PATH)}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry's argtypes
    set (c_void_p for pointers and the stream, so none is cut to 32 bits)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            signatures = {
                "tpu_msm_scan_madd": [vp, vp, vp, i32, i32, i32, vp],
                "tpu_msm_padd": [vp] * 9 + [i64, vp],
                "tpu_msm_padd_group": [vp] * 9 + [i64, vp],
                "tpu_msm_window_tail": [vp] * 9 + [i32, i32, i32, vp],
                "tpu_msm_horner": [vp] * 6 + [i32, i32, vp],
                "tpu_msm_fold_add": [vp] * 6 + [i32, i32, vp],
                "tpu_msm_fold_add_group": [vp] * 6 + [i32, i32, vp],
                "tpu_msm_digit_hist": [vp, i32, i64, vp, i32, i32, i32, i32,
                                       i64, i32, vp],
                "tpu_msm_pmadd": [vp] * 8 + [i64, vp],
                "tpu_msm_pmadd_group": [vp] * 8 + [i64, vp],
                "tpu_msm_jac_madd": [vp] * 8 + [i64, vp],
                "tpu_msm_jac_add": [vp] * 9 + [i64, vp],
                "tpu_msm_scan_madd_rows": [vp] * 6 + [i32, i32, i32, vp],
                "tpu_msm_montmul_chain": [vp] * 3 + [i64, i32, i32, i32, vp],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def on_cuda(*tensors) -> bool:
    """Which version a kernel wrapper runs: False for CPU tensors (the plain
    version), True for CUDA tensors (the kernel, after checking dtype and
    layout). Any other device, or operands on two devices, raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel operands lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operands must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return True


def launch(name: str, device, *args) -> None:
    """Call C entry `name` on `device`'s current stream. Tensors pass as
    their data pointers; a non-zero return (cudaGetLastError) raises."""
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
