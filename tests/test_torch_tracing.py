"""The program's spans (`utils/profiling.span`), on the CPU.

Under torch.profiler every stage of an MSM opens one span named
`tpu_msm_torch.<stage>` on the caller's thread, nested by time in the
call's `tpu_msm_torch.msm_best`; without a profiler no span is entered and
the answers are the same. The MSMs here run the fused route at CPU_THRESHOLD
(2^11) points with 16-bit scalars and 8-bit windows (W = 2), so the plain
EC ops of two windows keep each call to seconds; the group budget is cut to
one window a group, so the call has two groups.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_msm_torch
from tpu_msm_torch.bindings import export, native
from tpu_msm_torch.models import bn254
from tpu_msm_torch.ops import pippenger, streaming
from tpu_msm_torch.utils import interop, profiling
from tpu_msm_torch.utils.config import MsmConfig

N = tpu_msm_torch.CPU_THRESHOLD
CFG = MsmConfig(window_bits=8, scan_lanes=1024, reduce_fanout=64,
                scalar_bits=16, signed_digits=False, segment_starts="hist")
W = CFG.num_windows()
P = "tpu_msm_torch."


def _inputs(seed, n, zero_share=0.0):
    """Seeded numpy limb arrays: n points k_i·G and n 16-bit scalars, a
    `zero_share` of them zero."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    scalars = [int(s) for s in rng.randint(1, 1 << 16, size=n)]
    for i in rng.permutation(n)[:int(zero_share * n)]:
        scalars[i] = 0
    return px, py, interop.ints_to_limbs(scalars)


@pytest.fixture
def small_msm(monkeypatch):
    """msm_best at N points takes CFG on the fused route, one window a
    group; the streamed route's chunks take CFG too."""
    for mod in (tpu_msm_torch, streaming):
        monkeypatch.setattr(mod, "select_config",
                            lambda n, device=None: CFG)
    monkeypatch.setattr(pippenger, "CPU_GROUP_BUDGET",
                        N * pippenger.GROUP_BYTES_PER_POINT)
    assert pippenger.fused_route(pippenger._scan_lanes(N, CFG))


def _traced(fn):
    """fn() under torch.profiler (CPU activity): its result and the
    program's spans as (name, start, end, thread) in ns, in order of start.
    They are read from the profiler's raw events: its `events()` would
    build the tree of the 10^5-10^6 plain ops of a call, for minutes."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(P)]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _names(spans):
    return collections.Counter(s[0][len(P):] for s in spans)


def test_span_is_null_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span(P + "msm_best")
    assert off is profiling.span(P + "pippenger.group")  # one shared context
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span(P + "test") as on:
            torch.ones(2).add_(1)
    assert isinstance(on, torch.profiler.record_function)
    [e] = [e for e in prof.events() if e.name == P + "test"]
    assert "aten::add_" in [c.name for c in e.cpu_children]


def test_span_tree_of_the_fused_route(small_msm):
    px, py, sl = _inputs(1, N)
    got, spans = _traced(lambda: tpu_msm_torch.msm_best(sl, (px, py),
                                                         device="cpu"))
    assert got == native.msm(px, py, sl)
    groups = -(-W // pippenger.window_group_size(W, N, "cpu"))
    assert groups == W == 2
    assert _names(spans) == {"msm_best": 1, "msm_best.zero_scan": 1,
                             "pippenger.operands": 1,
                             "pippenger.group": groups,
                             "pippenger.sides": 1, "pippenger.horner": 1,
                             "msm.readback": 1}
    [call] = [s for s in spans if s[0] == P + "msm_best"]
    assert len({s[3] for s in spans}) == 1  # all on the caller's thread
    assert all(_within(s, call) for s in spans)
    # The stages follow one another, each closed before the next opens.
    order = [s[0][len(P):] for s in spans if s is not call]
    assert order == (["msm_best.zero_scan", "pippenger.operands"]
                     + ["pippenger.group"] * groups
                     + ["pippenger.sides", "pippenger.horner",
                        "msm.readback"])
    inner = [s for s in spans if s is not call]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_span_tree_of_the_streamed_route(small_msm, monkeypatch):
    """STREAM_THRESHOLD = N / 2: N + 5 points run k = 3 chunks of N / 2,
    each one chunk span over its operands, groups and sides, then k - 1
    accumulates and one horner."""
    chunk = N // 2
    monkeypatch.setattr(tpu_msm_torch, "STREAM_THRESHOLD", chunk)
    k = 3
    px, py, sl = _inputs(2, (k - 1) * chunk + 5)
    got, spans = _traced(lambda: tpu_msm_torch.msm_best(sl, (px, py),
                                                         device="cpu"))
    assert got == native.msm(px, py, sl)
    groups = -(-W // pippenger.window_group_size(W, chunk, "cpu"))
    assert _names(spans) == {"msm_best": 1, "msm_best.zero_scan": 1,
                             "streaming.chunk": k,
                             "streaming.accumulate": k - 1,
                             "pippenger.operands": k,
                             "pippenger.group": k * groups,
                             "pippenger.sides": k, "pippenger.horner": 1,
                             "msm.readback": 1}
    [call] = [s for s in spans if s[0] == P + "msm_best"]
    assert all(_within(s, call) for s in spans)
    chunks = [s for s in spans if s[0] == P + "streaming.chunk"]
    for s in spans:  # each stage of a chunk's window sums in one chunk
        if s[0] in (P + "pippenger.operands", P + "pippenger.group",
                    P + "pippenger.sides"):
            assert sum(_within(s, c) for c in chunks) == 1, s
    for s in spans:  # accumulates and the horner fold lie between chunks
        if s[0] in (P + "streaming.accumulate", P + "pippenger.horner"):
            assert not any(_within(s, c) for c in chunks), s
    # Accumulate j follows chunk j + 1.
    acc = [s for s in spans if s[0] == P + "streaming.accumulate"]
    assert all(c[2] <= a[1] for c, a in zip(chunks[1:], acc))


def test_no_profiler_enters_no_span(small_msm, monkeypatch):
    """Without a profiler record_function is never entered, and the fused
    and streamed answers are those of the native engine."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    px, py, sl = _inputs(3, N + 5)
    want = native.msm(px, py, sl)
    assert tpu_msm_torch.msm_best(sl, (px, py), device="cpu") == want
    monkeypatch.setattr(tpu_msm_torch, "STREAM_THRESHOLD", N // 2)
    assert tpu_msm_torch.msm_best(sl, (px, py), device="cpu") == want


@pytest.mark.parametrize("share, filtered", [(0.4, True), (0.1, False)])
def test_zero_filter_runs_in_the_zero_scan_span(share, filtered):
    """msm_best drops the zero-scalar points inside its zero scan's span:
    from ZERO_FILTER_THRESHOLD (0.30) of zeros on, the three limb tensors
    are indexed by the nonzero mask there, below it none is; the answer is
    the native engine's either way."""
    n = 200
    px, py, sl = _inputs(4, n, zero_share=share)
    assert int((sl == 0).all(0).sum()) == int(share * n)
    tpx, tpy, tsl = interop.limbs_to_device(px, py, sl, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tpu_msm_torch.msm_best(tsl, (tpx, tpy), device="cpu")
    assert got == native.msm(px, py, sl)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    [scan] = [e for e in events if e[0] == P + "msm_best.zero_scan"]
    index = [e for e in events if e[0] == "aten::index"]
    assert sum(_within(e, scan) for e in index) == (3 if filtered else 0)


@pytest.mark.parametrize("profiled", [False, True])
def test_export_holds_no_profiler_op(monkeypatch, profiled):
    """export_msm traces the fused route's stages, spans and all, into a
    graph of torch ops and the port's operators alone, with a profiler
    running or not."""
    programs = []
    real = torch.export.export

    def keep(*args, **kwargs):
        programs.append(real(*args, **kwargs))
        return programs[-1]

    monkeypatch.setattr(torch.export, "export", keep)
    n = CFG.scan_lanes
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            data = export.export_msm(n, CFG, device="cpu")
    else:
        data = export.export_msm(n, CFG, device="cpu")
    assert data
    [program] = programs
    targets = {str(node.target) for node in program.graph.nodes
               if node.op == "call_function"}
    assert "tpu_msm_torch.scan_madd_sorted.default" in targets
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]
