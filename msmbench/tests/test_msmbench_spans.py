"""The readers of the program's spans (`msmbench/spans.py`) on a synthetic
Chrome trace: device time by the launch's correlation and thread, idle
gaps split by overlap, launches outside every program span, and None from
every reader where the program has no spans."""

import time

import pytest

import tpu_msm_torch
from msmbench import run, spans
from msmbench.spans import device_by_span, idle_by_span
from msmbench.spec import Bench
from msmbench.trace import CALL_SPAN, Trace

from conftest import TINY, make_root
from test_msmbench_trace import record, synthetic

P = "tpu_msm_torch."
READERS = ["operands_ms", "groups_ms", "sides_ms", "entry_idle_ms",
           "pipeline_idle_ms", "stream_ms", "stream_idle_ms"]


def span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def device(corr, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts,
            "dur": end - ts, "tid": 7, "args": {"correlation": corr}}


def program_trace():
    """Two calls on thread 1, times in us. Call 1 (0-100) on the fused
    route: msm_best 1-100 over zero_scan 2-10, operands 10-20, group 20-58,
    sides 58-80, horner 80-85, readback 90-100. Call 2 (150-250) streamed:
    msm_best 150-250 over chunk 155-200 (a group 160-190 inside), accumulate
    200-210, horner 210-220, readback 240-250. Thread 2 holds a sides span
    0-100 of its own. Device: A 5-8 launched at 0.5, outside every program
    span; B 15-25 (operands); C 25-55 (launched at 30 in the group); L
    30-40, launched at 35 on thread 2; D 60-75 (sides); E 82-84 (horner);
    a copy F 95-98 (readback); a copy G 158-168 (chunk); H 168-188 (group);
    I 205-208 (accumulate); J 212-215 (horner); K 230-232, whose launch
    is not in the trace."""
    return [
        span(CALL_SPAN, 0, 100), span(CALL_SPAN, 150, 250),
        span(P + "msm_best", 1, 100), span(P + "msm_best.zero_scan", 2, 10),
        span(P + "pippenger.operands", 10, 20),
        span(P + "pippenger.group", 20, 58),
        span(P + "pippenger.sides", 58, 80),
        span(P + "pippenger.horner", 80, 85),
        span(P + "msm.readback", 90, 100),
        span(P + "msm_best", 150, 250), span(P + "streaming.chunk", 155, 200),
        span(P + "pippenger.group", 160, 190),
        span(P + "streaming.accumulate", 200, 210),
        span(P + "pippenger.horner", 210, 220),
        span(P + "msm.readback", 240, 250),
        span(P + "pippenger.sides", 0, 100, tid=2),
        launch(0, 0.5), device(0, 5, 8),
        launch(1, 12), device(1, 15, 25),
        launch(2, 30), device(2, 25, 55),
        launch(10, 35, tid=2), device(10, 30, 40),
        launch(3, 65), device(3, 60, 75),
        launch(4, 82), device(4, 82, 84),
        launch(5, 95), device(5, 95, 98, cat="gpu_memcpy"),
        launch(6, 156), device(6, 158, 168, cat="gpu_memcpy"),
        launch(7, 165), device(7, 168, 188),
        launch(8, 205), device(8, 205, 208),
        launch(9, 212), device(9, 212, 215),
        device(99, 230, 232),
    ]


def us(d):
    return {k: pytest.approx(v * 1e-6) for k, v in d.items()}


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    """By correlation, on the launch's thread: C (launched in the group,
    while thread 2 sat in a sides span) is the group's, L (launched on
    thread 2) that span's; G and H in the chunk are the chunk's and its
    group's."""
    got = device_by_span(Trace(program_trace()))
    assert got == us({None: 3 + 2, P + "pippenger.operands": 10,
                      P + "pippenger.group": 30 + 20,
                      P + "pippenger.sides": 10 + 15,
                      P + "pippenger.horner": 2 + 3, P + "msm.readback": 3,
                      P + "streaming.chunk": 10,
                      P + "streaming.accumulate": 3})


def test_a_gap_is_split_by_overlap():
    """The gap 55-60 straddles the group (to 58) and the sides (from 58);
    98-158 runs from the readback through no span into the next call."""
    got = idle_by_span(Trace(program_trace()))
    assert got == us({None: 1 + 50, P + "msm_best": 1 + 5 + 5 + 10 + 8,
                      P + "msm_best.zero_scan": 3 + 2,
                      P + "pippenger.operands": 5,
                      P + "pippenger.group": 3 + 2,
                      P + "pippenger.sides": 2 + 5,
                      P + "pippenger.horner": 2 + 1 + 2 + 5,
                      P + "msm.readback": 5 + 2 + 10,
                      P + "streaming.chunk": 3 + 10,
                      P + "streaming.accumulate": 5 + 2})
    trace = Trace(program_trace())
    assert sum(got.values()) == pytest.approx(
        sum(t - s for s, t in trace.gaps()))


def test_a_launch_outside_every_program_span_counts_for_no_stage():
    events = program_trace()
    outside = device_by_span(Trace(events))[None]
    events.append(launch(11, 120))  # between the calls
    events.append(device(11, 120, 130))
    got = device_by_span(Trace(events))
    assert got[None] == pytest.approx(outside + 10e-6)
    assert sum(v for k, v in got.items() if k is not None) == pytest.approx(
        sum(v for k, v in device_by_span(Trace(program_trace())).items()
            if k is not None))


def test_stages_by_dotted_name():
    assert spans.in_stage(P + "msm_best.zero_scan", [P + "msm_best"])
    assert not spans.in_stage(P + "msm_best", [P + "msm"])
    assert spans.in_stage(P + "msm.readback", [P + "msm"])
    assert not spans.in_stage(None, [P + "msm"])
    # Two spans that start together: the shorter is the inner one.
    tied = [(0.0, 10.0, "outer"), (0.0, 5.0, "inner")]
    tied.sort(key=lambda s: (s[0], -s[1]))
    assert spans.innermost(tied, [0.0, 2.0, 7.0, 11.0]) == [
        "inner", "inner", "outer", None]


@pytest.mark.parametrize("name, want_us", [
    ("operands_ms", 10), ("groups_ms", 50), ("sides_ms", 25),
    ("stream_ms", 10 + 3), ("entry_idle_ms", 29 + 5 + 17),
    ("pipeline_idle_ms", 5 + 5 + 7 + 10), ("stream_idle_ms", 13 + 7),
])
def test_readers_on_the_program_trace(name, want_us):
    """Each reader's ms a call over the trace's two calls, under its own
    name and the 2^24 cell's."""
    bench = Bench()
    rec = record(Trace(program_trace()))
    assert bench.reader(name)(rec) == pytest.approx(want_us / 2 / 1e3)
    assert bench.reader(name + ".2p24")(rec) == bench.reader(name)(rec)


@pytest.mark.parametrize("name", READERS)
def test_without_program_spans_every_reader_gives_none(name):
    bench = Bench()
    assert bench.reader(name)(record(Trace(synthetic()))) is None
    assert bench.reader(name)(record(None)) is None


def test_a_stage_missing_from_the_trace_gives_none():
    """Without its streaming spans (the fused route alone) the streaming
    readers find nothing; the pipeline's still read."""
    events = [e for e in program_trace()
              if not e["name"].startswith(P + "streaming.")]
    bench = Bench()
    rec = record(Trace(events))
    assert bench.reader("stream_ms")(rec) is None
    assert bench.reader("stream_idle_ms")(rec) is None
    assert bench.reader("groups_ms")(rec) > 0


def test_no_device_events_no_reading():
    """A traced run on the CPU has program spans but no device events:
    nothing is read, as the other device readers read nothing."""
    events = [e for e in program_trace()
              if e["cat"] not in ("kernel", "gpu_memcpy")]
    rec = record(Trace(events))
    for name in READERS:
        assert Bench().reader(name)(rec) is None, name


def test_every_new_entry_has_its_reader():
    bench = Bench()
    names = [m["name"] for m in bench.spec["per_layer"]
             if m["name"].split(".")[0] in READERS]
    assert len(names) == 13  # 12 of the uniform cells, entry_idle_ms.host
    for name in names:
        assert bench.reader(name)(record(None)) is None


@pytest.mark.cuda
def test_every_new_entry_reads_on_the_card(tmp_path, card, monkeypatch):
    """A traced run of a 2^12 cell on the card, streamed in two chunks of
    2^11: all thirteen entries of the span readers read, and every device event of the
    window was launched inside a program span."""
    monkeypatch.setattr(tpu_msm_torch, "STREAM_THRESHOLD", 1 << 11)
    bench = Bench(make_root(tmp_path, log_size=12))
    traces = []
    reader = bench.reader

    def keep(name):
        def read(rec):
            traces.append(rec.trace)
            return reader(name)(rec)
        return read

    monkeypatch.setattr(bench, "reader", keep)
    out = run.run_cell(bench, bench.cell(TINY), 2**31 + 11, 0.5, True, card,
                       time.perf_counter())
    assert out["correct"] is True
    new = {m["name"] for m in bench.spec["per_layer"]
           if m["name"].split(".")[0] in READERS}
    assert len(new) == 13 and new <= set(out["metrics"])
    by_span = device_by_span(traces[0])
    assert by_span.get(None, 0.0) == 0.0
    assert by_span[P + "streaming.chunk"] > 0
