"""The port's profiler CLI (tpu_msm_torch.cli.profiler), its device-time
profile (tpu_msm_torch.cli.trace) and its fixture layer
(tpu_msm_torch.utils.preprocess / oracle) on the CPU.

The fixtures must be the JAX package's, array for array, and share its npz
files. The run modes take an explicit device, so their logic runs here on
CPU tensors (plain kernel versions) at a small size; `main` and
`--check-kernels` need a card and must refuse to run without one.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_msm_torch  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.cli import profiler, trace  # noqa: E402
from tpu_msm_torch.utils import oracle, preprocess  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

# 64 points with scalars below 2^32: five c = 8 windows, cheap on the CPU.
SMALL = MsmConfig(window_bits=8, scan_lanes=16, reduce_fanout=64,
                  scalar_bits=32)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_MSM_CACHE_DIR", str(tmp_path))
    return tmp_path / "msm_vecs"


@pytest.fixture(scope="module")
def small_inst():
    [inst] = preprocess.generate_msm_instances(6, 1, seed=3)
    inst.scalars[2:] = 0  # below 2^32
    return inst


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_instances_match_jax_package():
    from tpu_msm.utils import preprocess as jpre

    got = preprocess.generate_msm_instances(8, 2, seed=11)
    want = jpre.generate_msm_instances(8, 2, seed=11)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for f in ("px", "py", "scalars"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            assert getattr(g, f).dtype == getattr(w, f).dtype
    # Points on the curve, scalars below 2^254 (not all below r).
    from tpu_msm_torch.utils import interop

    pts = interop.limbs_to_affine_points(got[0].px[:, :8], got[0].py[:, :8])
    assert all(oracle.is_on_curve(pt) for pt in pts)
    assert max(interop.limbs_to_ints(got[0].scalars)) < 1 << 254


def test_npz_round_trip_shared_with_jax_package(cache):
    from tpu_msm.utils import preprocess as jpre

    made = preprocess.get_or_create_msm_instances(5, 2, seed=4)
    path = cache / "msm_5x2.npz"
    assert path.exists()
    for loaded in (preprocess.get_or_create_msm_instances(5, 2),
                   preprocess.load_msm_instances(path),
                   jpre.load_msm_instances(path)):
        for a, b in zip(made, loaded):
            np.testing.assert_array_equal(a.px, b.px)
            np.testing.assert_array_equal(a.scalars, b.scalars)
    with pytest.raises(preprocess.HarnessError):
        preprocess.load_msm_instances(cache / "missing.npz")


def test_main_cpu_mode_returns_0(cache):
    assert profiler.main(["8", "1", "cpu", "1"]) == 0
    assert (cache / "msm_8x1.npz").exists()


def test_check_mode_function_on_cpu(small_inst):
    want = native.msm(small_inst.px, small_inst.py, small_inst.scalars)
    assert want is not None
    got, cpu = profiler.run_check(small_inst, SMALL, "cpu")
    assert got == cpu == want


@pytest.mark.parametrize("mode", ["gpu", "best", "cpu"])
def test_parallel_mode_function_on_cpu(small_inst, mode):
    want = native.msm(small_inst.px, small_inst.py, small_inst.scalars)
    assert profiler.run_parallel(small_inst, SMALL, mode, 2, "cpu") == want


def test_stream_mode_function_on_cpu(small_inst):
    """The stream mode's call at chunks of 2^4 (four chunks of 16)."""
    want = native.msm(small_inst.px, small_inst.py, small_inst.scalars)
    res = profiler.run_stream(small_inst, SMALL, "cpu", chunk_log=4)
    assert profiler._affine(res) == want


def test_hybrid_mode_function_on_cpu(small_inst):
    want = native.msm(small_inst.px, small_inst.py, small_inst.scalars)
    assert profiler.run_hybrid(small_inst, SMALL, "cpu") == want


@pytest.fixture
def cpu_card(monkeypatch, cache, small_inst):
    """main's card modes on the CPU: the card is the CPU, the instances are
    small_inst and the configuration SMALL."""
    from tpu_msm_torch.utils import config

    monkeypatch.setattr(profiler, "_card", lambda: torch.device("cpu"))
    monkeypatch.setattr(preprocess, "get_or_create_msm_instances",
                        lambda log_n, num: [small_inst])
    monkeypatch.setattr(config, "select_config", lambda n, device=None: SMALL)


@pytest.mark.parametrize("mode", ["stream", "hybrid"])
def test_stream_and_hybrid_modes_check_against_native(cpu_card, mode,
                                                      monkeypatch, caplog):
    """The two modes hold their warm-up result against the native engine:
    rc 0 and the line that says so where they agree, rc 1 where the engine
    gives another point."""
    caplog.set_level("INFO")
    assert profiler.main(["6", "1", mode, "1"]) == 0
    assert f"instance 0: {mode} == cpu" in caplog.text
    monkeypatch.setattr(profiler, "run_cpu", lambda inst: oracle.GEN)
    assert profiler.main(["6", "1", mode, "1"]) == 1
    assert "MISMATCH at instance 0" in caplog.text


def test_card_modes_refuse_to_run_without_a_card(cache, no_card):
    for mode in ("gpu", "best", "check", "stream", "hybrid"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            profiler.main(["6", "1", mode, "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiler.main(["--check-kernels"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiler.check_kernels("cpu")
    assert not list(cache.glob("*.npz"))  # refused before any work


def test_parallel_runs_only_for_single_device_modes():
    with pytest.raises(SystemExit):
        profiler.main(["6", "1", "check", "1", "2"])


def test_kernel_check_routes_on_cpu():
    """The check's comparisons on the CPU, where every wrapper runs its
    plain version: all thirteen routes (both kernels of padd, of pmadd and
    of fold_add, and the histogram of one window and of a group of three,
    among them) agree with the curve-level ops and with searchsorted."""
    failed = profiler._check_routes("cpu")
    assert set(failed) == {
        "pmadd", "pmadd_group", "padd", "padd_group", "jac_madd", "jac_add",
        "scan_madd_rows", "scan_madd", "fold_add", "fold_add_group",
        "digit_hist[hist]", "digit_hist[hist_cols]", "digit_hist[group]"}
    assert not any(failed.values()), failed


def test_import_leaves_jax_out():
    code = ("import sys, tpu_msm_torch.cli.profiler, tpu_msm_torch.cli.trace, "
            "tpu_msm_torch.ops.streaming, tpu_msm_torch.hybrid, "
            "tpu_msm_torch.utils.preprocess, tpu_msm_torch.utils.oracle; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(tpu_msm_torch.__file__).parents[1], timeout=120)


@pytest.mark.parametrize("route", ["rule", "fused", "per_window"])
def test_trace_routes_match_native(small_inst, route):
    from tpu_msm_torch.utils import interop

    dev = torch.device("cpu")
    ts = interop.limbs_to_device(small_inst.px, small_inst.py,
                                 small_inst.scalars, dev)
    res = trace.msm_on_route(*ts, SMALL, route)
    [got] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    assert got == native.msm(small_inst.px, small_inst.py, small_inst.scalars)


def test_trace_summarize_attributes_device_time():
    """Busy time is the union of the device's intervals; kernels are named,
    host events are left out."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "pmadd_kernel", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void padd_kernel(int const*)",
         "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "at::native::elementwise",
         "ts": 90, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0, "dur": 500},
        {"ph": "i", "cat": "kernel", "name": "pmadd_kernel", "ts": 200},
    ]
    got = trace.summarize(events)
    assert got["busy_ms"] == pytest.approx(0.030)
    assert got["span_ms"] == pytest.approx(0.100)
    assert got["idle_share"] == pytest.approx(0.7)
    assert got["device_events"] == 4
    assert got["kernels"] == {"pmadd_kernel": [0.01, 1],
                              "padd_kernel": [0.01, 1],
                              "copies": [0.005, 1], "torch": [0.01, 1]}
    with pytest.raises(RuntimeError, match="no device activity"):
        trace.summarize(events[4:])


def test_trace_refuses_to_run_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA device"):
        trace.main(["6"])
