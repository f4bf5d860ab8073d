"""The environment overrides the port reads, as the JAX package reads them:
TPU_MSM_CPU_THRESHOLD (`tpu_msm/__init__.py:52`) and
TPU_MSM_STREAM_THRESHOLD (`:63`) at import, and TPU_MSM_NATIVE_DIR
(`tpu_msm/bindings/native.py:26`). One fresh process runs with all three
set; the defaults and the dispatch on the CPU threshold are checked in this
one."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tpu_msm_torch  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402

ROOT = Path(tpu_msm_torch.__file__).resolve().parents[1]
EIGHT = list(range(1, 9)), [(bn254.GX, bn254.GY)] * 8

# In the fresh process: the threshold, which route msm_best gives eight
# points (with `msm`, the device route, replaced by a spy), the native
# library's path and its MSM of (px, py, sl).
_CHILD = """
import sys, numpy as np, tpu_msm_torch
from tpu_msm_torch.bindings import native
from tpu_msm_torch.models import bn254
tpu_msm_torch.msm = lambda *a, **k: "device"
got = tpu_msm_torch.msm_best(list(range(1, 9)), [(bn254.GX, bn254.GY)] * 8,
                             device="cpu")
px, py, sl = (np.array(eval(a), np.uint32) for a in sys.argv[1:4])
print(tpu_msm_torch.CPU_THRESHOLD)
print("device" if got == "device" else "native")
print(native.msm(px, py, sl))
print(native._lib._name)
print(tpu_msm_torch.STREAM_THRESHOLD)
"""


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """A native tree elsewhere, its library already built (its source older
    than the library: no rebuild), and the fresh process's five lines with
    TPU_MSM_CPU_THRESHOLD=5, TPU_MSM_STREAM_THRESHOLD=100 and
    TPU_MSM_NATIVE_DIR pointing at it."""
    assert native.available()
    tree = tmp_path_factory.mktemp("native")
    shutil.copy(native._NATIVE_DIR / "msm_cpu.cpp", tree)
    (tree / "build").mkdir()
    shutil.copy(native._SO, tree / "build")
    os.utime(tree / "msm_cpu.cpp", (0, 0))
    px, py = interop.affine_points_to_limbs([(bn254.GX, bn254.GY)] * 3)
    sl = interop.ints_to_limbs([3, 5, 7])
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_MSM_")}
    env.update(TPU_MSM_CPU_THRESHOLD="5", TPU_MSM_STREAM_THRESHOLD="100",
               TPU_MSM_NATIVE_DIR=str(tree))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, *(str(a.tolist()) for a in (px, py, sl))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return tree, native.msm(px, py, sl), proc.stdout.splitlines()


def test_cpu_threshold_env(child):
    """Read at import: 5, so eight points take the device route."""
    _, _, (threshold, route, _, _, _) = child
    assert (threshold, route) == ("5", "device")


def test_native_dir_env(child):
    """The library of the tree the variable names is loaded and computes."""
    tree, want, (_, _, got, lib, _) = child
    assert Path(lib) == tree / "build" / "libtpu_msm_cpu.so"
    assert got == str(want) != "None"


@pytest.mark.parametrize("threshold,route", [(None, "native"), (5, "device"),
                                             (9, "native")])
def test_msm_best_dispatches_on_cpu_threshold(monkeypatch, threshold,
                                              route):
    """msm_best reads the module's threshold at each call: below it the
    native engine, from it the device route. The default is 2^11, the
    crossover measured on the H100, where the variable is not set."""
    if threshold is None:
        if "TPU_MSM_CPU_THRESHOLD" not in os.environ:
            assert tpu_msm_torch.CPU_THRESHOLD == 1 << 11
    else:
        monkeypatch.setattr(tpu_msm_torch, "CPU_THRESHOLD", threshold)
    monkeypatch.setattr(tpu_msm_torch, "msm", lambda *a, **k: "device")
    got = tpu_msm_torch.msm_best(*EIGHT, device="cpu")
    assert ("device" if got == "device" else "native") == route


def test_stream_threshold_env(child):
    """Read at import: 100, which msm streams above in chunks of 2^6
    (tests/test_torch_streaming.py). The default is 2^22 where the variable
    is not set."""
    _, _, (_, _, _, _, threshold) = child
    assert threshold == "100"
    if "TPU_MSM_STREAM_THRESHOLD" not in os.environ:
        assert tpu_msm_torch.STREAM_THRESHOLD == 1 << 22
