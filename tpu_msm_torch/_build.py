"""Build and load the port's CUDA kernels, and build its C ABI.

`nvcc` compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, `build/tpu_msm_torch/libtpu_msm_torch_kernels.so` under
the repository root (git-ignored), at first use and again whenever a source
is newer than the library. ctypes loads it.

`build_embed` compiles the C ABI (`csrc/tpu_msm_torch_embed.cpp`, which
embeds CPython) with g++ into `libtpu_msm_torch_embed.so` beside it, and
its smoke host program (`csrc/test_embed_main.c`) with gcc into
`test_embed`, with `python3-config`'s flags, at first use and again
whenever a source is newer. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import site
import subprocess
import sys
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
EMBED_LIB = BUILD_DIR / "libtpu_msm_torch_embed.so"
EMBED_HOST = BUILD_DIR / "test_embed"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


class EmbedBuildError(RuntimeError):
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
                "tpu_msm_scan_layout": [vp] * 5 + [i32, i64, i32, vp],
                "tpu_msm_scan_madd_sorted": [vp] * 4 + [i32, i64, i32, vp],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def on_cuda(*tensors) -> bool:
    """Which version a kernel wrapper runs: False for CPU tensors (the plain
    version), True for CUDA tensors (the kernel). Any other device, or
    operands on two devices, raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel operands lie on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    return True


def launch(name: str, device, *args, dtypes=(torch.int32,)) -> None:
    """Call C entry `name` on `device`'s current stream. Tensors pass as
    their data pointers, after checking that each is a contiguous tensor on
    `device` of one of `dtypes` (int32 alone unless the caller names more);
    None passes as a null pointer. A non-zero return (cudaGetLastError)
    raises."""
    for t in args:
        if isinstance(t, torch.Tensor):
            if t.dtype not in dtypes:
                raise TypeError(f"kernel operands must be one of {dtypes}, "
                                f"got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("kernel operands must be contiguous")
            if t.device != device:
                raise ValueError(f"kernel operand on {t.device}, the launch "
                                 f"on {device}")
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _python_config() -> str:
    """The python3-config of this interpreter's version: beside the
    interpreter, else on PATH."""
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}-config"
    here = Path(sys.executable).parent
    for cand in (here / ver, here / "python3-config"):
        if cand.exists():
            return str(cand)
    found = shutil.which(ver) or shutil.which("python3-config")
    if found is None:
        raise EmbedBuildError("no python3-config found: the C ABI embeds "
                              "CPython and needs its headers and library")
    return found


def _config_flags(cfg: str, *args: str) -> list:
    proc = subprocess.run([cfg, *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise EmbedBuildError(f"{cfg} {' '.join(args)} failed:\n"
                              f"{proc.stderr}")
    return proc.stdout.split()


def build_embed() -> dict:
    """Build the C ABI library and its smoke host program if either is
    missing or older than its sources. Returns {"built": bool, "seconds": float, "lib":
    path, "host": path}."""
    lib_src = _CSRC / "tpu_msm_torch_embed.cpp"
    host_src = _CSRC / "test_embed_main.c"
    newest = max(lib_src.stat().st_mtime, host_src.stat().st_mtime)
    if all(p.exists() and p.stat().st_mtime >= newest
           for p in (EMBED_LIB, EMBED_HOST)):
        return {"built": False, "seconds": 0.0, "lib": str(EMBED_LIB),
                "host": str(EMBED_HOST)}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cfg = _python_config()
    includes = _config_flags(cfg, "--includes")
    ldflags = _config_flags(cfg, "--embed", "--ldflags")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / EMBED_LIB.name
        host = Path(tmp) / EMBED_HOST.name
        for cmd in (
                ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
                 *includes, "-shared", "-o", str(lib), str(lib_src),
                 *ldflags],
                ["gcc", "-O2", "-Wall", "-o", str(host), str(host_src),
                 f"-L{tmp}", "-ltpu_msm_torch_embed", "-Wl,-rpath,$ORIGIN",
                 *ldflags]):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise EmbedBuildError(f"{cmd[0]} failed ({proc.returncode}):"
                                      f"\n{proc.stdout}{proc.stderr}")
        os.replace(lib, EMBED_LIB)
        os.replace(host, EMBED_HOST)
    return {"built": True, "seconds": time.perf_counter() - t0,
            "lib": str(EMBED_LIB), "host": str(EMBED_HOST)}


def embed_env(env=None) -> dict:
    """`env` (default os.environ) for a process that loads the C ABI: the
    repository root and this interpreter's site-packages on PYTHONPATH, so
    the embedded interpreter imports this checkout's tpu_msm_torch, torch
    and numpy."""
    env = dict(os.environ if env is None else env)
    paths = [str(BUILD_DIR.parents[1]), *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env
