"""scan_madd_rows on the card at several chunk counts K, in turns.

    python -m tpu_msm_torch.benches.scan_rows_benchmark \\
        --shapes 256:4096 256:1024 --chunks 1 8 16 32 64 --turns 2

For each shape (steps:lanes) the inputs are seeded affine points (8192
multiples of G by the native engine, each step a lane-roll of them, tiled
to the lanes). Each K's output is held against K = 1's by projective
equality, then every K is timed in turns (the K list forward, then back,
`--turns` times): the device time of one call, from a CUDA graph of 20
calls replayed by CUDA events. Last, one torch.profiler run of 5 calls a K
gives each of the three kernels' device ms a launch (totals, prefix,
rescan; csrc/ec_kernels.cu). One JSON line per shape, with the rule's K
(`cuda_curve.scan_rows_chunks`) and the card's name and power limit.
Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

GRAPH_CALLS = 20
PHASES = {"scan_madd_rows_totals_kernel": "totals",
          "scan_madd_rows_prefix_kernel": "prefix",
          "scan_madd_rows_kernel": "rescan"}


def inputs(steps: int, lanes: int, device, seed: int = 9):
    """(16, steps, lanes) int32 x and y rows: step k is 8192 seeded
    multiples of G rolled by k lanes, tiled to `lanes`."""
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=8192)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    out = []
    for a in (px, py):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
        t = t.repeat(1, -(-lanes // t.shape[1]))
        out.append(torch.stack([t.roll(k, dims=1)[:, :lanes]
                                for k in range(steps)], dim=1).contiguous())
    return out


def graph_ms(fn) -> float:
    """Device ms of one fn() call: GRAPH_CALLS calls in one CUDA graph, its
    replay timed by CUDA events (median of 3)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / GRAPH_CALLS)
    return statistics.median(runs)


def phases_ms(fn) -> dict:
    """Device ms a launch of each of the three kernels over 5 fn() calls,
    by torch.profiler (cli/trace.py)."""
    from tpu_msm_torch.cli import trace

    rec = trace.profile(lambda: [fn() for _ in range(5)])["kernels"]
    return {PHASES[k]: ms / n for k, (ms, n) in rec.items() if k in PHASES}


def run(steps: int, lanes: int, chunks, turns: int = 2) -> dict:
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import curve
    from tpu_msm_torch.utils import profiling

    dev = profiling.require_card("the scan_madd_rows benchmark")
    gx, gy = inputs(steps, lanes, dev)
    ks = sorted({cc.scan_rows_chunking(steps, k)[0] for k in chunks})
    serial = curve.ProjPoint(*cc.scan_madd_rows(gx, gy, chunks=1))
    for k in ks:
        got = curve.ProjPoint(*cc.scan_madd_rows(gx, gy, chunks=k))
        if not bool(curve.proj_eq(got, serial).all()):
            raise AssertionError(f"K = {k} differs from K = 1 at "
                                 f"({steps}, {lanes})")
    del got, serial
    runs = {k: [] for k in ks}
    for _ in range(turns):
        for k in ks + ks[::-1]:
            runs[k].append(graph_ms(lambda: cc.scan_madd_rows(gx, gy,
                                                              chunks=k)))
    out = {k: {"ms": statistics.mean(r), "ms_runs": r} for k, r in
           runs.items()}
    for k in ks:
        out[k]["phases_ms"] = phases_ms(lambda: cc.scan_madd_rows(
            gx, gy, chunks=k))
    return {"steps": steps, "lanes": lanes,
            "rule": cc.scan_rows_chunks(steps, lanes, profiling.sm_count(dev)),
            "fastest": min(out, key=lambda k: out[k]["ms"]), "chunks": out,
            "card": profiling.card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["256:4096"])
    ap.add_argument("--chunks", nargs="+", type=int,
                    default=[1, 8, 16, 32, 64])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    for shape in args.shapes:
        steps, lanes = (int(v) for v in shape.split(":"))
        print(json.dumps(run(steps, lanes, args.chunks, args.turns)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
