"""The trace's readers on a synthetic Chrome trace: the window, the idle
share, PyTorch's kernels by namespace, launches and the breakdown."""

import types

import pytest

from msmbench.spec import Bench
from msmbench.trace import CALL_SPAN, Trace, is_torch_kernel, short_name

TORCH_NAMES = [
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int>>(int, F, A)",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, unsigned int, 2>(T*, P)",
    "void at_cuda_detail::cub::DeviceScanKernel<P, int*>(int*)",
    "void cub::CUB_200200_900_NS::DeviceRadixSortOnesweepKernel<P>(int*)",
    "void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_out<int>>(int, F)",
]
PORT_NAMES = [
    "(anonymous namespace)::scan_madd_sorted_kernel(int const*, unsigned int const*, int)",
    "void radix_scatter_kernel<true, false>(int const*, int*, int)",
    "padd_kernel(unsigned int const*, unsigned int*, long long)",
    # No kernel of the port has this name today: it must count as the port's.
    "void fused_bucket_reduce_kernel<4>(unsigned int const*, unsigned int*)",
]


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic():
    """Two calls of 100 us each at 0 and 150 (a gap of 50 between them).
    Call 1: torch kernel 10-30, scan 30-70, copy 80-90; call 2: torch 160-170,
    a new port kernel 170-230. Host: aten::ne 0-10, cudaMemcpyAsync 90-100,
    python from 100 to 150 outside any call."""
    return [
        ev("user_annotation", CALL_SPAN, 0, 100),
        ev("user_annotation", CALL_SPAN, 150, 100),
        ev("cpu_op", "aten::ne", 0, 10),
        ev("cuda_runtime", "cudaMemcpyAsync", 90, 10),
        ev("kernel", TORCH_NAMES[0], 10, 20),
        ev("kernel", PORT_NAMES[0], 30, 40),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 80, 10),
        ev("kernel", TORCH_NAMES[1], 160, 10),
        ev("kernel", PORT_NAMES[3], 170, 60),
        ev("kernel", "before the window", -50, 10),
        ev("gpu_user_annotation", CALL_SPAN, 0, 100),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]


@pytest.mark.parametrize("name", TORCH_NAMES)
def test_torch_kernels_by_namespace(name):
    assert is_torch_kernel(name)


@pytest.mark.parametrize("name", PORT_NAMES)
def test_every_other_kernel_is_the_ports(name):
    assert not is_torch_kernel(name)


def test_short_names():
    assert short_name(TORCH_NAMES[0]) == "at::native::vectorized_elementwise_kernel"
    assert short_name(PORT_NAMES[0]) == "scan_madd_sorted_kernel"
    assert short_name(PORT_NAMES[1]) == "radix_scatter_kernel"


def test_window_busy_and_gaps():
    t = Trace(synthetic())
    assert t.calls == 2
    assert t.window_s == pytest.approx(250e-6)
    assert len(t.device) == 5  # the event before the window is left out
    assert t.busy_s() == pytest.approx(140e-6)
    flat = [x for gap in t.gaps() for x in gap]
    assert flat == pytest.approx([0, 10e-6, 70e-6, 80e-6, 90e-6, 160e-6,
                                  230e-6, 250e-6])


def test_breakdown_names_what_the_host_did():
    b = Trace(synthetic()).breakdown()
    ops = dict(b["device_ops"])
    assert ops["fused_bucket_reduce_kernel"] == pytest.approx(60e-6)
    assert ops["scan_madd_sorted_kernel"] == pytest.approx(40e-6)
    idle = dict(b["idle_gaps"])
    assert idle["aten::ne"] == pytest.approx(10e-6)
    assert idle["between calls"] == pytest.approx(70e-6)  # midpoint 125
    assert idle[f"python in {CALL_SPAN}"] == pytest.approx(30e-6)
    assert [v for _, v in b["device_ops"]] == sorted(
        (v for _, v in b["device_ops"]), reverse=True)


def record(trace):
    cell = types.SimpleNamespace(config={"window_bits": 16, "scalar_bits": 254})
    from msmbench.run import Record

    rec = Record(cell=cell, n=1 << 10, trace=trace, trace_sets=[0, 1],
                 digits={0: 16 << 10, 1: 16 << 10})
    return rec


def test_readers_on_the_synthetic_trace():
    bench = Bench()
    rec = record(Trace(synthetic()))
    assert bench.reader("idle_share")(rec) == pytest.approx(100 * (1 - 140 / 250))
    assert bench.reader("torch_ms")(rec) == pytest.approx(30e-3 / 2)
    assert bench.reader("launches")(rec) == 2.5
    scan = bench.reader("scan_roofline")(rec)
    from msmbench import roofline

    least = roofline.accumulation_s(16 << 10, 1 << 10, 254, 16)
    assert scan == pytest.approx(100 * least / 20e-6)
    # No radix kernel ran: the sort's roofline is left out, not 0.
    assert bench.reader("sort_roofline")(rec) is None


def test_readers_find_nothing_without_a_trace():
    bench = Bench()
    rec = record(None)
    for name in ("idle_share", "torch_ms", "launches", "scan_roofline",
                 "sort_roofline", "entry_ms", "points_per_s",
                 "msm_ms_p95", "peak_mem_mib"):
        assert bench.reader(name)(rec) is None, name
