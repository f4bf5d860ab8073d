"""Device-time profile of one MSM on the card, by torch.profiler.

    python -m tpu_msm_torch.cli.trace                 # 2^20, three routes
    python -m tpu_msm_torch.cli.trace 16 --routes fused:4096

Each route is `name:lanes` with name one of

    rule        `msm_device`: the route the lane count selects
    fused       the fused route (`pippenger._fused_sums`) at any lane count
    per_window  the per-window route (`pippenger._per_window_sums`)

and c = 16 signed windows, fanout 2048 (the tuned row) otherwise. For each,
one call warms up, then one call runs under torch.profiler (CUDA activity
only) and one JSON line is printed:

    busy_ms     the union of the device's intervals: kernels, copies, sets
    span_ms     from the first device interval's start to the last one's end
    idle_share  1 - busy_ms / span_ms
    kernels     {name: [device ms, count]}: the port's kernels by name,
                torch's own kernels together as "torch", copies and sets
                as "copies"

The profiler slows the host, so a host-bound call spans more time profiled
than unprofiled; device times are the device's own. The inputs are
`utils.preprocess.generate_msm_instances(log_n, 1, seed)`. Needs a CUDA
device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile

import torch

from tpu_msm_torch.ops import pippenger
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint
from tpu_msm_torch.utils.config import MsmConfig

KERNELS = ("scan_madd_kernel", "scan_madd_rows_kernel",
           "scan_madd_rows_totals_kernel", "scan_madd_rows_prefix_kernel",
           "padd_kernel", "padd_group_kernel", "window_tail_kernel",
           "horner_kernel", "pmadd_kernel", "pmadd_group_kernel",
           "fold_add_kernel", "fold_add_group_kernel", "jac_madd_kernel",
           "jac_add_kernel", "digit_hist_kernel", "scan_layout_kernel",
           "scan_madd_sorted_kernel")
_DEVICE_CATS = {"kernel": None, "gpu_memcpy": "copies", "gpu_memset": "copies"}

ROUTES = {"rule": pippenger.window_sums,
          "fused": pippenger._fused_sums,
          "per_window": pippenger._per_window_sums}


def msm_on_route(px, py, scalar_limbs, cfg: MsmConfig, route: str) -> ProjPoint:
    """`msm_device` with the window sums of `route` (a key of ROUTES)."""
    wsums = ROUTES[route](AffinePoint(px, py), scalar_limbs, cfg)
    return pippenger.horner_fold(wsums, cfg.window_bits)


def kernel_name(name: str) -> str:
    """The port's kernel a device event's name names, else "torch"."""
    for k in KERNELS:
        if re.search(rf"(?<!\w){k}(?!\w)", name):
            return k
    return "torch"


def _busy_ms(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def profile(fn) -> dict:
    """Runs fn() once to warm up and once under torch.profiler; returns the
    device's busy and span ms, its idle share and the time per kernel."""
    return summarize(trace_events(fn))


def trace_events(fn, host: bool = False) -> list:
    """Runs fn() once to warm up and once under torch.profiler (CUDA
    activity, and the host's ops too where `host`); returns the events of
    the profiled call's Chrome trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                            else [])
    with tprofile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_events(events) -> list:
    """The trace's device events (kernels, copies, sets) in order of
    start."""
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in _DEVICE_CATS),
                  key=lambda e: float(e["ts"]))


def summarize(events) -> dict:
    """profile()'s numbers from the events of a Chrome trace (ts and dur
    in µs)."""
    intervals, kernels = [], {}
    for e in device_events(events):
        s, d = float(e["ts"]), float(e.get("dur", 0))
        intervals.append((s, s + d))
        key = _DEVICE_CATS[e["cat"]] or kernel_name(e.get("name", ""))
        ms, count = kernels.get(key, (0.0, 0))
        kernels[key] = (ms + d / 1e3, count + 1)
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _busy_ms(intervals)
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
    return {"busy_ms": busy, "span_ms": span, "idle_share": 1 - busy / span,
            "device_events": len(intervals),
            "kernels": {k: [ms, n] for k, (ms, n) in sorted(kernels.items())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=20)
    ap.add_argument("--routes", nargs="+",
                    default=["rule:4096", "rule:16384", "fused:16384"])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA device and none is "
                           "available")
    from tpu_msm_torch.utils import interop, preprocess

    [inst] = preprocess.generate_msm_instances(args.log_n, 1, seed=args.seed)
    dev = torch.device("cuda")
    px, py, sl = interop.limbs_to_device(inst.px, inst.py, inst.scalars, dev)
    for spec in args.routes:
        route, lanes = spec.split(":")
        cfg = MsmConfig(scan_lanes=int(lanes))
        rec = profile(lambda: msm_on_route(px, py, sl, cfg, route))
        print(json.dumps({"log_n": args.log_n, "route": route,
                          "lanes": int(lanes), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
