"""What the traced run reads from torch.profiler's Chrome trace.

The traced run profiles a steady stretch of whole calls, each inside a
host span named CALL_SPAN (`torch.profiler.record_function`). The window is
from the first such span's start to the last one's end; the device events
are the kernels, copies and sets whose start lies in it. A kernel is
PyTorch's when its name is in PyTorch's namespaces (`at::`, and the `cub`
and `thrust` kernels PyTorch launches); every other kernel is the port's,
whatever its name, so a kernel a later change adds counts as the port's.
Times in the trace are in microseconds; everything here returns seconds.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Iterable, List, Tuple

CALL_SPAN = "msmbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TORCH_KERNEL = re.compile(r"\bat::|\bat_cuda_detail::|\bcub::|\bthrust::")


def export_events(prof) -> list:
    """The trace events of a finished torch.profiler run, by way of a
    Chrome trace file under TMPDIR that is removed again."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _interval(e) -> Tuple[float, float]:
    s = float(e["ts"]) / 1e6
    return s, s + float(e.get("dur", 0)) / 1e6


class Trace:
    """The events of one traced stretch of calls."""

    def __init__(self, events: Iterable[dict]):
        self.events = [e for e in events if e.get("ph") == "X"]
        spans = [_interval(e) for e in self.events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == CALL_SPAN]
        self.calls = len(spans)
        if spans:
            self.start = min(s for s, _ in spans)
            self.end = max(e for _, e in spans)
        else:
            self.start = self.end = 0.0
        self.device = sorted(
            (e for e in self.events if e.get("cat") in DEVICE_CATS
             and self.start <= _interval(e)[0] <= self.end),
            key=lambda e: float(e["ts"]))

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> list:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def busy_s(self) -> float:
        """The union of the device's intervals, clipped to the window."""
        return sum(e - s for s, e in self._busy_intervals())

    def _busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for e in self.device:
            s, t = _interval(e)
            s, t = max(s, self.start), min(t, self.end)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def seconds(self, events) -> float:
        return sum(b - a for a, b in map(_interval, events))

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's idle intervals: no kernel, copy or set running."""
        out, at = [], self.start
        for s, t in self._busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.end > at:
            out.append((at, self.end))
        return out

    def host_activity(self, times: List[float]) -> List[str]:
        """What the host was doing at each of the ascending `times`: the
        innermost op or runtime call whose span holds it, else the call
        span, else nothing."""
        host = sorted((_interval(e) + (e["name"],) for e in self.events
                       if e.get("cat") in HOST_CATS))
        calls = [_interval(e) for e in self.events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == CALL_SPAN]
        out, active, i = [], [], 0
        for t in times:
            while i < len(host) and host[i][0] <= t:
                active.append(host[i])
                i += 1
            active = [a for a in active if a[1] >= t]
            if active:
                out.append(max(active, key=lambda a: a[0])[2])
            elif any(s <= t <= u for s, u in calls):
                out.append(f"python in {CALL_SPAN}")
            else:
                out.append("between calls")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each the `top` largest, in seconds over
        the window."""
        ops = {}
        for e in self.device:
            name = short_name(e.get("name", ""))
            ops[name] = ops.get(name, 0.0) + self.seconds([e])
        idle = {}
        gaps = self.gaps()
        names = self.host_activity([(s + t) / 2 for s, t in gaps])
        for (s, t), name in zip(gaps, names):
            idle[name] = idle.get(name, 0.0) + (t - s)

        def largest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]

        return {"device_ops": largest(ops), "idle_gaps": largest(idle)}


def is_torch_kernel(name: str) -> bool:
    return TORCH_KERNEL.search(name) is not None


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters: `void at::native::foo<int, 4>(int*)`
    -> `at::native::foo`."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name
