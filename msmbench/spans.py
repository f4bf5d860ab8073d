"""What the traced run reads of the program's own spans.

While torch.profiler records, the program opens a span at each stage of a
call (`tpu_msm_torch.utils.profiling.span`): a `user_annotation` event named
`tpu_msm_torch.<stage>` on the calling thread, on the profiler's clock.
Spans nest by time; the innermost span that holds an instant is the stage
the host was in then. A stage names its span and every span under its
dotted name: `tpu_msm_torch.msm_best` holds `tpu_msm_torch.msm_best.zero_scan`,
`tpu_msm_torch.pippenger` every pipeline stage.

Two attributions, each over the traced window (`trace.Trace`):

* device time: each kernel, copy or set of the window goes to the
  innermost program span that holds the start of its launching runtime
  call, matched by `args.correlation`, on that call's thread;
* idle time: each idle gap (`Trace.gaps()`) is split by overlap over the
  innermost program span on the calls' thread (the thread of the
  benchmark's call spans) at each instant.

Time that no program span holds goes to None. A reader returns None where
the trace holds no span of its stages, so a program without spans reports
nothing. Times are in seconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from msmbench.trace import CALL_SPAN, _interval

PREFIX = "tpu_msm_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Span = Tuple[float, float, str]


def in_stage(name: Optional[str], stages: Iterable[str]) -> bool:
    """Whether span `name` is one of `stages` or lies under one by its
    dotted name."""
    return name is not None and any(
        name == s or name.startswith(s + ".") for s in stages)


def program_spans(trace) -> Dict[object, List[Span]]:
    """The program's spans by thread, each (start, end, name), ordered by
    start, the outer of two that start together first."""
    out: Dict[object, List[Span]] = {}
    for e in trace.events:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PREFIX)):
            out.setdefault(e.get("tid"), []).append(
                _interval(e) + (e["name"],))
    for spans in out.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
    return out


def innermost(spans: List[Span], times: List[float]) -> List[Optional[str]]:
    """The innermost of `spans` (one thread's, as `program_spans` orders
    them) that holds each of the ascending `times`, or None."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        out.append(active[-1][2] if active else None)
    return out


def device_by_span(trace) -> Dict[Optional[str], float]:
    """Device seconds of the window by the innermost program span that
    holds each event's launch."""
    launches = {}
    for e in trace.events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = (_interval(e)[0], e.get("tid"))
    by_thread: Dict[object, List[Tuple[float, float]]] = {}
    out: Dict[Optional[str], float] = {}
    for e in trace.device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            out[None] = out.get(None, 0.0) + trace.seconds([e])
        else:
            by_thread.setdefault(launch[1], []).append(
                (launch[0], trace.seconds([e])))
    spans = program_spans(trace)
    for tid, items in by_thread.items():
        items.sort()
        names = innermost(spans.get(tid, []), [t for t, _ in items])
        for (_, dur), name in zip(items, names):
            out[name] = out.get(name, 0.0) + dur
    return out


def idle_by_span(trace) -> Dict[Optional[str], float]:
    """Idle seconds of the window by the innermost program span on the
    calls' thread at each instant of each gap."""
    threads = {e.get("tid") for e in trace.events
               if e.get("cat") == "user_annotation"
               and e.get("name") == CALL_SPAN}
    by_thread = program_spans(trace)
    spans = sorted((s for tid in threads for s in by_thread.get(tid, [])),
                   key=lambda s: (s[0], -s[1]))
    # Between two consecutive span boundaries the innermost span is one.
    cuts = sorted({t for s in spans for t in s[:2]})
    pieces = list(zip(cuts, cuts[1:]))
    names = innermost(spans, [(a + b) / 2 for a, b in pieces])
    out: Dict[Optional[str], float] = {}
    j = 0
    for s, t in trace.gaps():
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < t:
            a, b = max(pieces[k][0], s), min(pieces[k][1], t)
            if b > a:
                out[names[k]] = out.get(names[k], 0.0) + (b - a)
                covered += b - a
            k += 1
        out[None] = out.get(None, 0.0) + (t - s) - covered
    return out


def stage_ms(rec, stages: Iterable[str],
             idle: bool = False) -> Optional[float]:
    """Device ms a call (idle ms with `idle`) whose innermost program span
    lies in `stages` (full span names); None without a traced stretch on
    the device, or where no span of `stages` is in the trace."""
    trace = rec.trace
    if trace is None or not trace.calls or not trace.device:
        return None
    stages = tuple(stages)
    if not any(in_stage(s[2], stages)
               for spans in program_spans(trace).values() for s in spans):
        return None
    by_span = idle_by_span(trace) if idle else device_by_span(trace)
    spent = sum(v for k, v in by_span.items() if in_stage(k, stages))
    return 1e3 * spent / trace.calls
