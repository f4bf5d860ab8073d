#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_msm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, times both at the shapes of
the paths that run them, then drives four paths and requires the native
C++ engine's result exactly:

  * the main path: `tpu_msm_torch.msm_best` at n = 2^12 and n = 2^20 on
    bench-style inputs, with the tuned row `select_config` reads from the
    autotune table (the fused route: scan_madd_sorted and digit_hist over
    groups of windows, padd, fold_add, window_tail, horner; no scan_layout
    or scan_madd launch, which the counts assert);
  * the per-window path: `tpu_msm_torch.msm` at n = 2^20 with 16384 scan
    lanes, once with each segment-start option (pmadd, padd, fold_add,
    digit_hist, window_tail, horner);
  * the profiler CLI: `--check-kernels` (every kernel, among them
    jac_madd, jac_add and scan_madd_rows) and `20 1 check 1`, each in a
    subprocess;
  * the roofline and tuning path: the field core's microbench
    (`tpu_msm_torch.benches.montmul_benchmark`, the montmul_chain kernel)
    at ilp 1 and 4 and `utils.profiling.roofline(20)` with its rate
    (phase 7); `msm` with GLV at 2^18 and 2^20, timed beside the same
    configuration without it (phase 8); `select_config` from the "cuda"
    rows of the autotune table at 2^16, 2^18 and 2^20,
    `bindings.benchmarks.benchmark_gpu_msm_best(16)` and `msm_best` at 2^16
    (phase 9);
  * the options the tuned row does not take (phase 10): `msm_device` at
    2^20 with c = 13 signed windows and at 2^16 with
    segment_starts="bincount" and "ss_scan", each against the tuned row's
    result;
  * the streamed route (phase 11): `msm_best` at 2^24 from numpy limb
    arrays (the 512 bench points tiled, scalars below 2^253) in chunks of
    2^22, its chunks and launches asserted, against the MSM folded onto
    the 512 base points (`benches/dispatch_benchmark.tiled_expected`);
    every kernel the route launches held against its plain version at
    each shape it launches it at; the same inputs through `msm_streamed`
    resident and host-streamed (bit-identical) and unstreamed
    `msm_device`, timed, with peak memory and G;
  * the card + CPU split (phase 12): `hybrid.msm_hybrid` at 2^20 at shares
    1/3, 1/2, 2/3 and 1.0, each timed beside `msm` alone;
  * the golden vectors (phase 13): every MSM case of
    tests/vectors/bn254_golden.json through `msm` on the card;
  * limb tensors on the card (phase 14): `msm` and `msm_best` on (16, 2^20)
    int32 CUDA tensors, with and without the zero filter;
  * the sharded and multi-process MSM (phase 15): `parallel.sharded.
    msm_sharded` at 2^20 over 1, 2 and 4 shards on cuda:0 in both
    collectives (D = 1 byte-identical to `msm_device`), each timed beside
    `msm_device`, every `padd`, `padd_group` and `horner` launch of those
    runs held against its plain version at its shape (`sharded_shapes`,
    `sharded_launches` in the JSON line); two processes of
    `python -m tpu_msm_torch.parallel.distributed` over gloo, both on
    cuda:0, at 2^21 in both collectives, their digests equal to each other
    and to in-process `msm_sharded` over two shards; one process over NCCL
    at world size 1, its digest that of `msm_device`'s bytes; the CLI's
    `20 1 sharded 1`;
  * the C ABI (phase 16): `libtpu_msm_torch_embed.so` and its smoke host
    program built with g++, the program fed the 2^20 inputs as wire bytes, its 64 bytes
    equal to the native engine's, its calls timed beside `msm_best_wire`
    and `msm_best` in Python;
  * the exported MSM (phase 17): `bindings.export.export_msm` at 2^20 with
    the tuned row on cuda:0, saved, loaded (`load_msm`) and held against
    eager `msm_device` bit for bit and against the native engine, with
    equal kernel launches, both timed in turns; an artifact saved at 2^12
    loaded and run in a fresh process that imports only the loader; the
    per-window route at 2^12 exported and held against eager likewise;
  * the micro-benches (phase 18, in this process): `tpu_msm_torch.benches.
    conversion_benchmark` at 2^20 (each converter against a formulation
    written here, both round trips), `sort_benchmark` part (a) at
    2^16-2^22 (against np.sort and the stable np.argsort's gather) and part
    (b) at the tuned 2^20 row (its `_sorted_scan_inputs` layout bit for
    bit that of the permutation `msm_device`'s own first scan takes; a
    profiled call split into its sort, its scan_layout launch and the rest,
    the sort's share of torch's own kernels in a profiled `msm_device`,
    which launches no scan_layout), and
    `msm_benchmark` at 2^20 over 2 instances (instance 0 against the native
    engine); their JSON lines logged as phase 18's lines.

Phase 5 also runs the CLI's `22 1 stream 1` and `20 1 hybrid 1`, each of
which holds its result against the native engine.

Phase 2 holds scan_madd_sorted (the main path's scan, which reads each
step's point from the point-major table in sort order) against its plain
version at a small shape (2 windows, 8 steps, 1024 lanes, signed and
unsigned, with indices outside the table), and against the unfused pair
it replaced on the main path, scan_madd(scan_layout(...)), bit for bit,
at each shape the paths give it: the tuned 2^20 row, MsmConfig()'s signed
4096 lanes at 2^20, a streamed 2^22 chunk's group and the 2^12 call;
there it times the two by CUDA graph in turns, beside the bound. At the
same shapes it holds scan_layout (csrc/layout.cu, now the reference of
scan_madd_sorted and the sort bench's layout) against its plain version
and against the torch formulation it replaced (the lane-major copy of the
permutation and two 4-byte column gathers, written here as
`replaced_layout`, bit for bit), and times the three. Phases 11, 15 and 17
hold scan_madd_sorted on each route's own inputs against the pair and, on
its first 8 steps, against its plain version (the streamed and sharded
calls through RouteSpy, the loaded export artifact through `op_calls`).
Phase 2 holds the histogram in each of its regimes (ops/hist.py, `plan`)
against its plain version and times the two regimes for the tuned row's
65,536 bins (split bins, 16-bit counters) in turns; it holds both kernels
of padd, fold_add and pmadd (one thread or eight lanes an element) and
times them in turns where the rule between them (cuda_curve.kernel_path)
is placed, pmadd at 8, 64, 4096, 8192, 16384, 65,536 and 2^20 elements
(8 and 64: the scan lanes of the golden vectors' configurations, the
widths the group kernel runs at in phase 13, where each pmadd launch is
also held against the plain version on its own inputs). It holds
scan_madd_rows, a reduce-then-scan over K chunks of the steps, against its
plain version at the same K (the rule's, cuda_curve.scan_rows_chunks, at
(16, 3, 1024), a ragged (16, 101, 3000) and (16, 256, 4096); K = 1 there
too), the rule's K against the serial scan by projective equality, and
times K = 1 and the rule's K in turns; phase 6 times its three kernels
apart by torch.profiler. Phase 4
asserts the per-window route's pmadd launches, one a scan step, each on
the kernel the rule gives its width. Phase 7 holds montmul_chain at every
ilp 1-8 with accumulators >= P, 0, P - 1 and 2^256 - 1, and settles the
bound model: at ilp 4 and 8, on 65,536 lanes, the rate against one
product's SASS by kind says whether a wide IMAD takes one issue slot of
the multiply pipe or two (`phase_bound_model`). Phase 4 also times
the fused route at the per-window path's 16384 lanes, which the route rule
does not take there. Phase 6, last so that no timing runs after the
profiler, profiles `msm_device` at 2^20 with the tuned row and on each
route, and with and without GLV at 2^18 and 2^20 (`tpu_msm_torch.cli.trace`):
the device's busy time, idle share and time per kernel. Beside each
kernel's time stand its bound (the larger of its 32-bit integer multiplies
over the card's rate and its bytes over the memory rate, counted from this
run's inputs) and, for the histogram, `torch.bincount`'s and
`torch.searchsorted`'s times. The serial tail (window_tail, horner) is
bound by latency instead: its serial adds x 2 dependent products x the
least time one product can take, the card's pipe floor (the product's
multiply-pipe issue slots in the built SASS, two for a wide IMAD, at 2
clocks each); beside it the
same chain at the latency of one product of the port's own field core (the
montmul_chain kernel on one lane), and the chain of width-16 and
width-1 `padd` launches it replaced, timed in the same run.

horner's plain version takes 7-11 s at the main path's (16, 16, 1): each
shape is held against it once in the run, and a later route that launches
horner at a shape already checked reuses that verdict (HORNER_VERDICTS);
its entry in that route's shapes of the JSON line names the phase whose
verdict it took (`verdict_from`), since it was not checked on its own inputs.

The kernel counters are set to 0 just before each path and read just after.
Lines on stdout carry their phase and the seconds since the start; then the
kernels' JSON line (with each phase's seconds, `phase_seconds`), the card's
`nvidia-smi` name and power limit, and last
`{"ok": true, "device": {...}}`. Any failure raises: the script exits
non-zero with the traceback and prints no `ok` line. Without a CUDA device,
or outside the repository, it fails the same way. Imports no jax.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
# Bench-style inputs (bench.py:51-71): 512 distinct points G·(1 + i·step),
# tiled, and seeded scalars below r.
BASE_POINTS = 512
POINT_STEP = 0xDEADBEEF


T0 = time.perf_counter()


def log(phase, msg):
    """One line of phase `phase`, with the seconds since the script
    started."""
    print(f"[{phase} +{time.perf_counter() - T0:.1f}s] {msg}", flush=True)


# The least span of one timing, in ms: a call that takes less is repeated
# back to back, so that the host's share of a call (its Python and launch,
# before the first kernel) does not set the mean of a short kernel.
TIMING_SPAN_MS = 10.0


def _events_ms(fn, inner):
    """The mean time of `inner` back-to-back calls, in ms, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


# A call at least this long (ms) is timed once: its warm-up call is the
# timing (the plain versions take 0.2-12 s at the main path's shapes).
LONG_CALL_MS = 200.0


def cuda_ms(fn, runs=3, inner=None):
    """Median over `runs` of the mean time of `inner` back-to-back calls,
    in ms, by CUDA events (after one warm-up call, which is the timing when
    it takes LONG_CALL_MS or more). inner=None: as many calls as fill
    TIMING_SPAN_MS, judged by one timed call, at most 50."""
    first = _events_ms(fn, 1)
    if first >= LONG_CALL_MS:
        return first
    if inner is None:
        inner = min(50, math.ceil(TIMING_SPAN_MS / _events_ms(fn, 1)))
    return statistics.median(_events_ms(fn, inner) for _ in range(runs))


def graph_ms(fn):
    """The device time of one call of `fn`, in ms: GRAPH_CALLS back-to-back
    calls captured in one CUDA graph, whose replays cuda_ms times, so that
    the host's share of a call (its Python and launch) is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the warm-up that capture wants, on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    return cuda_ms(graph.replay) / GRAPH_CALLS


GRAPH_CALLS = 20


def once(fn):
    """(fn(), its time in ms by CUDA events): one call, as cuda_ms times a
    call of LONG_CALL_MS or more, where its result is wanted too."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, want):
    """Largest |kernel - plain| over every output; 0 when bit-identical.
    The difference of outputs that differ is taken 2^26 elements at a time,
    in int64: a scan group's output is 9 GiB of int32 at 2^22."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if torch.equal(g, w):
            continue
        g, w = g.reshape(-1), w.reshape(-1)
        for i in range(0, g.numel(), 1 << 26):
            diff = (g[i:i + (1 << 26)].to(torch.int64)
                    - w[i:i + (1 << 26)].to(torch.int64)).abs()
            err = max(err, int(diff.max().item()))
    return err


# --------------------------------------------------------------------------
# Inputs on the card.
# --------------------------------------------------------------------------

def base_points(n, seed):
    """n affine points k_i·G with seeded 30-bit k_i, Montgomery (16, n)."""
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    return native.ec_mul_batch((bn254.GX, bn254.GY), interop.ints_to_limbs(ks))


def edge_affine(dev, n, seed):
    """Two affine batches on `dev` with Q == P on lanes [64, 128) (the add
    doubles), Q == -P on [128, 192) (it cancels) and infinities every 29
    lanes."""
    import torch

    from tpu_msm_torch.ops import field
    from tpu_msm_torch.utils import interop

    ax, ay, _ = interop.limbs_to_device(*base_points(n, seed),
                                        np.zeros((16, n), np.uint32), dev)
    bx, by, _ = interop.limbs_to_device(*base_points(n, seed + 1),
                                        np.zeros((16, n), np.uint32), dev)
    bx[:, 64:128], by[:, 64:128] = ax[:, 64:128], ay[:, 64:128]
    bx[:, 128:192] = ax[:, 128:192]
    by[:, 128:192] = field.neg_mod(ay[:, 128:192])
    inf = torch.arange(n, device=dev) % 29 == 0
    for x, y, m in ((ax, ay, inf), (bx, by, inf.roll(7))):
        x[:, m] = 0
        y[:, m] = 0
    return (ax, ay), (bx, by)


def scales(dev, n, seed):
    """(16, n) Montgomery λ in [1, P), seeded: a random scale per lane."""
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    rng = np.random.RandomState(seed)
    lam = [int.from_bytes(rng.bytes(32), "little") % (bn254.P - 1) + 1
           for _ in range(n)]
    return interop.limbs_to_device(interop.ints_to_limbs(lam),
                                   np.zeros((16, n), np.uint32),
                                   np.zeros((16, n), np.uint32), dev)[0]


def to_proj(dev, xy, seed):
    """Affine -> projective with a random scale λ per lane: (xλ : yλ : λ);
    the (0, 0) sentinel -> (0 : λ : 0)."""
    import torch

    from tpu_msm_torch.ops import curve, field

    n = xy[0].shape[1]
    lam = scales(dev, n, seed)
    inf = curve.affine_is_infinity(curve.AffinePoint(*xy))
    z = torch.where(inf, 0, lam)
    return (field.mont_mul(xy[0], lam), field.mont_mul(
        torch.where(inf, field.one_mont((n,), dev), xy[1]), lam), z)


def to_jac(dev, xy, seed):
    """Affine -> Jacobian with a random scale λ per lane: (xλ², yλ³, λ);
    the (0, 0) sentinel -> (λ², λ³, 0)."""
    import torch

    from tpu_msm_torch.ops import curve, field

    n = xy[0].shape[1]
    lam = scales(dev, n, seed)
    inf = curve.affine_is_infinity(curve.AffinePoint(*xy))
    one = field.one_mont((n,), dev)
    lam2 = field.mont_mul(lam, lam)
    return (field.mont_mul(torch.where(inf, one, xy[0]), lam2),
            field.mont_mul(torch.where(inf, one, xy[1]),
                           field.mont_mul(lam2, lam)),
            torch.where(inf, 0, lam))


def tile(t, width):
    """(16, k) -> (16, width) by repeating the columns."""
    return t.repeat(1, -(-width // t.shape[1]))[:, :width].contiguous()


def edge_cols(width):
    """`width` (>= 8) column indices of an edge_affine pair that hold every
    edge in the first eight: an infinity on each side (0, 7), a doubling
    (64, 66), a cancelling pair (128, 130), two ordinary adds (1, 2); then
    ordinary lanes from 192 on, with infinities every 29."""
    return [0, 7, 64, 66, 128, 130, 1, 2] + list(range(192, 184 + width))


def checker(entries, phase):
    """check(name, shape, got, want, against="plain"): kernel output
    against its plain version (or the reference `against` names), bit for
    bit; records the shape in entries[name]."""
    import torch

    def check(name, shape, got, want, against="plain"):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel differs from "
                                 f"{against} (max abs err {err})")
        log(phase, f"{name} {shape}: kernel == {against} (bit-identical)")
        rec = entries.setdefault(name, {"max_abs_err": 0, "checked": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # Shapes go into the JSON line as strings: its numbers are all
        # measured in this run.
        rec["checked"].append(str(shape) if against == "plain"
                              else f"{shape} against {against}")

    return check


# The card's peaks for a kernel's bound: the H100 SXM's HBM3 rate of
# 3.35 TB/s, and utils/profiling.py's model of the integer multiply pipe
# (64 lanes' issue slots a clock per SM, two slots for a wide IMAD) at this
# card's SM count and maximum SM clock.
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=1)
def int_ops_per_s():
    from tpu_msm_torch.utils import profiling

    return (profiling.IMAD_PER_CLOCK_PER_SM * profiling.sm_count()
            * profiling.sm_clock_hz())


def ec_work(mont_muls, elems, rows):
    """The work of an EC kernel: `mont_muls` Montgomery products of 264
    multiply-pipe issue slots each (utils/profiling.py), and `elems`
    elements of `rows` 4-byte rows, inputs and outputs together."""
    from tpu_msm_torch.utils import profiling

    return {"ops": mont_muls * profiling.CIOS_MULS_PER_MONT_MUL,
            "bytes": 4 * elems * rows}


def finite(*coords):
    """Columns of (rows, ...) coordinate tensors that are not the (0, 0)
    affine infinity: the mixed adds the kernels skip no work for."""
    import torch

    nz = torch.zeros(coords[0].shape[1:], dtype=torch.bool,
                     device=coords[0].device)
    for c in coords:
        nz |= (c != 0).any(dim=0)
    return int(nz.sum().item())


def bound(work):
    """The least time the card could take: the larger of the operations
    over the integer multiply rate and the bytes over the memory rate."""
    ops_s = work["ops"] / int_ops_per_s()
    bytes_s = work["bytes"] / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def timer(phase):
    """timed(name, shape, kernel_fn, plain_fn, work, ...): the kernel's
    device time (graph_ms) and its time a call back to back with the host's
    share (cuda_ms, `call_ms`), the plain version's (cuda_ms, or `plain_ms`
    where the caller timed it already, by once()), the bound of
    `work` (see bound) beside them, and the library call's time where one
    PyTorch call computes the same function."""

    def timed(name, shape, fn, plain, work, plain_shape=None, inner=None,
              library=None, plain_ms=None):
        ms = graph_ms(fn)
        call_ms = cuda_ms(fn, inner=inner)
        pms = cuda_ms(plain, inner=inner) if plain_ms is None else plain_ms
        lib = cuda_ms(library, inner=inner) if library else None
        rec = {"shape": str(shape), "ms": ms, "call_ms": call_ms,
               "plain_ms": pms, "plain_shape": str(plain_shape or shape),
               **bound(work), "library_ms": lib}
        log(phase, f"time {name} {shape}: kernel {ms:.4f} ms on the device "
            f"({call_ms:.4f} ms a call), plain {pms:.4f} ms"
            + (f" (plain at {plain_shape})" if plain_shape else "")
            + (f", library {lib:.4f} ms" if lib is not None else "")
            + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({work['ops']} int ops, {work['bytes']} bytes)")
        return rec

    return timed


# The two kernels of padd and of fold_add by path (cuda_curve.PATHS), as
# they stand in the kernels' JSON line.
PADD = {"thread": "padd", "group": "padd_group"}
FOLD = {"thread": "fold_add", "group": "fold_add_group"}
PMADD = {"thread": "pmadd", "group": "pmadd_group"}


def time_paths(phase, name, shape, run, plain_ms, work, rule,
               plain_shape=None):
    """Both kernels of a wrapper, run(path), timed by graph_ms in turns
    (thread, group, group, thread); `rule` is the path the wrapper's rule
    takes here. Returns {path: record}."""
    runs = {"thread": [], "group": []}
    for path in ("thread", "group", "group", "thread"):
        runs[path].append(graph_ms(lambda: run(path)))
    ms = {path: statistics.mean(r) for path, r in runs.items()}
    recs = {path: {"shape": str(shape), "ms": ms[path], "ms_runs": runs[path],
                   "plain_ms": plain_ms,
                   "plain_shape": str(plain_shape or shape), **bound(work),
                   "library_ms": None} for path in runs}
    faster = min(ms, key=ms.get)
    log(phase, f"time {name} {shape} on the device: thread "
        f"{runs['thread']} ms, group {runs['group']} ms; plain "
        f"{plain_ms:.4f} ms" + (f" at {plain_shape}" if plain_shape else "")
        + f"; bound {recs['thread']['bound_ms']:.4f} ms by "
        f"{recs['thread']['bound_by']}; faster: {faster}; the rule takes "
        f"{rule}" + ("" if rule == faster else " (not the faster)"))
    return recs


# --------------------------------------------------------------------------
# Phases.
# --------------------------------------------------------------------------

KERNEL_FUNCTIONS = ("scan_madd_rows_kernel", "scan_madd_rows_totals_kernel",
                    "scan_madd_rows_prefix_kernel", "scan_madd_kernel",
                    "jac_madd_kernel", "jac_add_kernel", "pmadd_kernel",
                    "pmadd_group_kernel",
                    "padd_group_kernel", "padd_kernel", "window_tail_kernel",
                    "horner_kernel", "fold_add_group_kernel",
                    "fold_add_kernel", "digit_hist_kernel",
                    "montmul_chain_kernel", "scan_layout_kernel",
                    "scan_madd_sorted_kernel")


def phase_build():
    """Builds the kernels and prints each one's ptxas registers, spills and
    stack frame."""
    from tpu_msm_torch import _build

    res = _build.build()
    log(1, f"build: {'compiled' if res['built'] else 'up to date'} in "
        f"{res['seconds']:.1f} s -> {res['lib']}")
    kernel = None
    for line in res["log"].splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            # Lines that follow a device function's header are not a kernel's.
            kernel = next((k for k in KERNEL_FUNCTIONS if k in line), None)
            # digit_hist_kernel<u16>, scan_layout_kernel<signed>,
            # scan_madd_sorted_kernel<signed>: the mangled template argument.
            args = re.search(
                r"(digit_hist|scan_layout|scan_madd_sorted)_kernelILb(\d)E",
                line)
            if args:
                what = "u16" if args[1] == "digit_hist" else "signed"
                kernel += f"<{what} {args[2]}>"
        elif kernel and ("registers" in line or "spill" in line):
            detail = line.replace("ptxas info    :", "").strip()
            log(1, f"ptxas {kernel}: {detail}")
    _build.load()


def main_shapes(dev, log_n=20):
    """The shapes the main path gives the kernels at n = 2^log_n (2^20; a
    streamed chunk's too): the selected row's scan lanes and steps,
    windows, the windows a scan launch takes (g), buckets (m, padded to
    m_pad), fold fanout, window bits and digit sign, for the 2n points of
    127-bit halves when it splits by GLV."""
    import dataclasses

    from tpu_msm_torch import select_config
    from tpu_msm_torch.ops import pippenger

    n = 1 << log_n
    cfg = select_config(n, dev)
    if cfg.glv:
        n, cfg = 2 * n, dataclasses.replace(cfg, glv=False, scalar_bits=127)
    m = cfg.buckets_per_window()
    return {"n": n, "lanes": cfg.scan_lanes, "steps": n // cfg.scan_lanes,
            "w": cfg.num_windows(),
            "g": pippenger.window_group_size(cfg.num_windows(), n, dev),
            "m": m, "m_pad": 1 << (m - 1).bit_length(),
            "fanout": 1 << (cfg.reduce_fanout.bit_length() - 1),
            "c": cfg.window_bits, "signed": cfg.signed_digits}


def phase_kernels(dev, scalars):
    """Each kernel against its plain version (bit-identical): first on edge
    lanes, then at every shape the main path at 2^20 gives it with the
    tuned row (main_shapes), where both are also timed; the histogram on
    the window digits of `scalars`, bench.py's (16, 2^20) scalar limbs.
    Returns the kernels' JSON entries."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops.pippenger import pack_u16_rows

    entries = {}
    check = checker(entries, 2)

    # ---- edge lanes: infinities, P + P, P + (-P), mid-scan sentinels ----
    a_aff, b_aff = edge_affine(dev, 8192, SEED)
    pa, pb = to_proj(dev, a_aff, SEED + 2), to_proj(dev, b_aff, SEED + 3)
    # Both padd kernels, at 8192 and at a ragged 8191 (not a multiple of
    # either kernel's elements a block).
    for width in (8192, 8191):
        ops = [c[:, :width].contiguous() for c in (*pa, *pb)]
        want = cc.padd_plain(*ops)
        for path, name in PADD.items():
            check(name, [16, width], cc.padd(*ops, path=path), want)

    # fold_add at (16, 64, 8192): the two batches, rolled per step; both
    # kernels, and at a ragged 8191 lanes.
    fold_in = [torch.stack([(pa if k % 2 else pb)[i].roll(k, dims=1)
                            for k in range(64)], dim=1).contiguous()
               for i in range(3)]
    for lanes in (8192, 8191):
        ops = [c[:, :, :lanes].contiguous() for c in fold_in]
        want = cc.fold_add_plain(*ops)
        for path, name in FOLD.items():
            check(name, [16, 64, lanes], cc.fold_add(*ops, path=path), want)

    # scan at (8, 8, 4096): sentinels, repeats (doubling), cancellations.
    xs = [a_aff[0][:, :4096], b_aff[0][:, :4096]]
    ys = [a_aff[1][:, :4096], b_aff[1][:, :4096]]
    gx = torch.stack([pack_u16_rows(xs[k % 2].roll(k // 2, dims=1))
                      for k in range(8)], dim=1).contiguous()
    gy = torch.stack([pack_u16_rows(ys[k % 2].roll(k // 2, dims=1))
                      for k in range(8)], dim=1).contiguous()
    gx[:, 5, 100:110] = 0  # explicit (0, 0) sentinels mid-scan
    gy[:, 5, 100:110] = 0
    check("scan_madd", [8, 8, 4096], cc.scan_madd(gx, gy),
          cc.scan_madd_plain(gx, gy))
    # The same over three windows in one launch, each lane-rolled apart.
    gx3, gy3 = (torch.stack([a.roll(37 * i, dims=2) for i in range(3)])
                for a in (gx, gy))
    check("scan_madd", [3, 8, 8, 4096], cc.scan_madd(gx3, gy3),
          cc.scan_madd_plain(gx3, gy3))

    # ---- the main path's shapes (the tuned row at 2^20): checked, then
    # kernel and plain version timed ----
    timed = timer(2)
    sh = main_shapes(dev)
    n, lanes, steps, w, m = (sh[k] for k in ("n", "lanes", "steps", "w", "m"))
    log(2, f"main path at 2^20: {sh}")

    phase_hist(dev, entries, sh, scalars)

    # The scan: one window at (8, steps, lanes), checked in full, then the
    # main path's group of g windows at (g, 8, steps, lanes) in one launch,
    # checked on its first 8 steps (a prefix scan's first steps depend on
    # nothing after them; one full plain scan takes seconds a window). The
    # plain version is timed at one window's first 8 steps.
    g = sh["g"]
    scan_x = torch.stack([pack_u16_rows(tile(a_aff[0].roll(k, dims=1), lanes))
                          for k in range(steps)], dim=1).contiguous()
    scan_y = torch.stack([pack_u16_rows(tile(a_aff[1].roll(k, dims=1), lanes))
                          for k in range(steps)], dim=1).contiguous()
    check("scan_madd", [8, steps, lanes], cc.scan_madd(scan_x, scan_y),
          cc.scan_madd_plain(scan_x, scan_y))
    one = timed("scan_madd", [8, steps, lanes],
                lambda: cc.scan_madd(scan_x, scan_y),
                lambda: cc.scan_madd_plain(scan_x[:, :8].contiguous(),
                                           scan_y[:, :8].contiguous()),
                ec_work(11 * finite(scan_x, scan_y), steps * lanes, 16 + 48),
                plain_shape=[8, 8, lanes])
    group_x, group_y = (torch.stack([a.roll(i, dims=2) for i in range(g)])
                        for a in (scan_x, scan_y))
    del scan_x, scan_y
    out = cc.scan_madd(group_x, group_y)
    check("scan_madd", [g, 8, steps, lanes, "first 8 steps"],
          out[:, :, :8].contiguous(),
          cc.scan_madd_plain(group_x[:, :, :8].contiguous(),
                             group_y[:, :, :8].contiguous()))
    del out
    entries["scan_madd"].update(timed(
        "scan_madd", [g, 8, steps, lanes],
        lambda: cc.scan_madd(group_x, group_y),
        lambda: cc.scan_madd_plain(group_x[0, :, :8].contiguous(),
                                   group_y[0, :, :8].contiguous()),
        ec_work(11 * finite(group_x.transpose(0, 1), group_y.transpose(0, 1)),
                g * steps * lanes, 16 + 48),
        plain_shape=[8, 8, lanes], plain_ms=one["plain_ms"]),
        other_shapes=[one])
    del group_x, group_y

    # Projective operands for fold_add and padd, tiled to each width. Lane 0
    # (an infinity) is dropped so that the narrow widths add real points.
    big = [c[:, 1:] for c in
           to_proj(dev, edge_affine(dev, 8192, SEED + 5)[0], SEED + 6)]

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # fold_add: _sides_batched folds each window's m_pad X(s_b) down to the
    # fanout, W x fanout lanes; both kernels, at that shape and, to place
    # the crossover (cuda_curve.GROUP_BELOW_PER_SM), at 8192 lanes; the
    # plain version is timed at 8 steps.
    fsteps, fwidth = sh["m_pad"] // sh["fanout"], w * sh["fanout"]
    recs = {name: [] for name in FOLD.values()}
    for width in (fwidth, 8192):
        fold = [tile(c, fsteps * width).reshape(16, fsteps, width)
                for c in big]
        if width == fwidth:  # 8192 lanes were checked on the edge lanes
            want = cc.fold_add_plain(*fold)
            for path, name in FOLD.items():
                check(name, [16, fsteps, width],
                      cc.fold_add(*fold, path=path), want)
        cut = [c[:, :8].contiguous() for c in fold]
        by_path = time_paths(
            2, "fold_add", [16, fsteps, width],
            lambda path: cc.fold_add(*fold, path=path),
            cuda_ms(lambda: cc.fold_add_plain(*cut)),
            ec_work(12 * fsteps * width, (fsteps + 1) * width, 48),
            cc.kernel_path(width, sms), plain_shape=[16, 8, width])
        for path, name in FOLD.items():
            recs[name].append(by_path[path])
        del fold, cut
    for name in FOLD.values():  # the main path's shape first
        first, *others = recs[name]
        entries[name].update(first, other_shapes=others)

    # padd at every width of the main path: W·(m+1) query adds, the
    # W·lanes lane-carry scan, the W·fanout rolled tree (each lane added to
    # its neighbour); and at W and 1, the widths of the chain that
    # window_tail and horner replace (at width 1 the add is a doubling).
    # Both kernels checked at every width; both timed at the three wide
    # widths, at 8192 (below the crossover) and at the per-window route's
    # rolled tree (2048).
    recs = {name: [] for name in PADD.values()}
    for width, timed_too in ((w * (m + 1), True), (w * lanes, True),
                             (w * sh["fanout"], True), (8192, True),
                             (2048, True), (w, False), (1, False)):
        ops = [tile(c, width) for c in big]
        ops += [o.roll(1, dims=1).contiguous() for o in ops]
        want = cc.padd_plain(*ops)
        for path, name in PADD.items():
            check(name, [16, width], cc.padd(*ops, path=path), want)
        if not timed_too:
            continue
        by_path = time_paths(
            2, "padd", [16, width], lambda path: cc.padd(*ops, path=path),
            cuda_ms(lambda: cc.padd_plain(*ops)),
            ec_work(12 * width, width, 96 + 48), cc.kernel_path(width, sms))
        for path, name in PADD.items():
            recs[name].append(by_path[path])
    # padd_kernel's row leads with the query adds' width, padd_group_kernel's
    # with the per-window route's rolled tree's (2048).
    first, *others = recs["padd"]
    entries["padd"].update(first, other_shapes=others)
    *others, first = recs["padd_group"]
    entries["padd_group"].update(first, other_shapes=others)
    phase_tail(dev, entries, sh, big)
    return entries


def layout_work(g, n_pad, row_words, signed):
    """scan_layout's work: no arithmetic; the permutation, the point-major
    table and the masks read once, sgx and sgy written once (bytes)."""
    return {"ops": 0, "bytes": (8 + 64 + signed) * g * n_pad
            + 4 * row_words * n_pad}


def replaced_layout(perm, ppx, ppy, negm, lanes):
    """The torch formulation scan_layout replaced, for the comparison only:
    the lane-major copy of the permutation, then one torch.gather of (G, 8,
    n_pad) 4-byte words each from the planar (8, n_pad) x and (8, n_pad) y,
    or (8, 2·n_pad) y then -y, whose index takes n_pad more where the mask
    negates (the -y index sum, with a third gather of the masks)."""
    import torch

    g, n_pad = perm.shape
    steps = n_pad // lanes
    idx = perm.view(g, lanes, steps).transpose(1, 2).reshape(g, 1, n_pad)

    def lay(pp, index):
        return torch.gather(pp.expand(g, 8, pp.shape[1]), 2,
                            index.expand(g, 8, n_pad)).view(g, 8, steps,
                                                            lanes)

    sgx = lay(ppx, idx)
    if negm is not None:
        idx = idx + n_pad * torch.gather(negm, 1, idx[:, 0])[:, None]
    return sgx, lay(ppy, idx)


def sorted_work(perm, rows, negm):
    """scan_madd_sorted's work: 11 products a step whose point is finite
    (in the table and not the (0, 0) row), and the permutation, the table
    and the masks read once, the 48-row output written once (bytes)."""
    g, n_pad = perm.shape
    nonzero = rows.ne(0).any(dim=1)
    inside = (perm >= 0) & (perm < n_pad)
    finite = int((nonzero[perm.clamp(0, n_pad - 1)] & inside).sum().item())
    return {"ops": ec_work(11 * finite, 0, 0)["ops"],
            "bytes": (8 + 192 + (negm is not None)) * g * n_pad
            + 4 * rows.shape[1] * n_pad}


def sorted_head_plain(perm, rows, negm, lanes, head=8):
    """scan_madd_sorted_plain's first `head` steps, (G, 48, head, lanes): a
    prefix scan's first steps depend on nothing after them, so the plain
    scan runs on the first `head` steps of the plain layout."""
    from tpu_msm_torch.ops import cuda_curve as cc

    return cc.scan_madd_plain(*(a[:, :, :head].contiguous() for a in
                                cc.scan_layout_plain(perm, rows, negm,
                                                     lanes)))


def phase_sorted_small(dev, entries):
    """scan_madd_sorted against its plain version, bit for bit, at a small
    shape: 2 windows of 8 steps x 1024 lanes over a table of seeded curve
    points with infinities (edge_affine), signed and unsigned, the stable
    sort of seeded digits, and three indices outside the table (-1, n_pad,
    2^40), which the kernel takes as the (0, 0) point and the plain version
    is handed as the index of a (0, 0) row."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import field
    from tpu_msm_torch.ops.pippenger import pack_u16_rows

    check = checker(entries, 2)
    lanes, steps, g = 1024, 8, 2
    n_pad = lanes * steps
    (ax, ay), _ = edge_affine(dev, n_pad, SEED + 20)  # column 0: infinity
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    digits = torch.randint(0, 300, (g, n_pad), generator=gen, device=dev,
                           dtype=torch.int32)
    perm = torch.sort(digits, dim=1, stable=True)[1]
    bad = perm.clone()
    bad[0, 3], bad[1, 100], bad[1, 7] = -1, n_pad, 1 << 40
    fixed = bad.clone()
    fixed[(bad < 0) | (bad >= n_pad)] = 0
    for signed in (False, True):
        coords = [ax, ay] + ([field.neg_mod(ay)] if signed else [])
        rows = torch.cat([pack_u16_rows(c) for c in coords]).t().contiguous()
        negm = (torch.rand((g, n_pad), generator=gen, device=dev) < 0.5
                if signed else None)
        for what, p, q in (("", perm, perm),
                           ("indices outside the table", bad, fixed)):
            check("scan_madd_sorted",
                  [g, n_pad, rows.shape[1], lanes] + ([what] if what else []),
                  cc.scan_madd_sorted(p, rows, negm, lanes),
                  cc.scan_madd_sorted_plain(q, rows, negm, lanes))


def phase_layout(dev, entries, inputs):
    """scan_madd_sorted, and scan_layout, at each shape the paths give the
    sorted scan, on the sorted digits of that shape: the tuned 2^20 row and
    MsmConfig()'s defaults (signed, 4096 lanes) on the bench inputs
    (`pippenger.scan_operands`), the first group of a streamed 2^22 chunk
    (the 2^24 route's) on seeded random digits and words, and the 2^12 call
    on its bench inputs. At each: scan_madd_sorted held bit for bit against
    the unfused pair scan_madd(scan_layout(...)), the two timed by CUDA
    graph in turns (sorted, pair, pair, sorted) beside the bound
    (sorted_work), its plain version timed on one window's first 8 steps'
    points; scan_layout held bit for bit against its plain version and
    against `replaced_layout`, the three timed (the replaced one by
    graph_ms too), with its bound (layout_work). First
    phase_sorted_small."""
    import torch

    from tpu_msm_torch import select_config
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import pippenger
    from tpu_msm_torch.ops.curve import AffinePoint
    from tpu_msm_torch.utils import interop
    from tpu_msm_torch.utils.config import MsmConfig

    phase_sorted_small(dev, entries)
    check = checker(entries, 2)
    timed = timer(2)

    def bench_group(log_n, cfg):
        px, py, sl = interop.limbs_to_device(*inputs[log_n], dev)
        cfg, _, digits, negm, rows = pippenger.scan_operands(
            AffinePoint(px, py), sl, cfg)
        g = pippenger.window_group_size(*digits.shape, dev)
        return (digits[:g], None if negm is None else negm[:g], rows,
                cfg.scan_lanes)

    def random_group(log_n):
        sh = main_shapes(dev, log_n)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        g, n_pad = sh["g"], sh["n"]
        digits = torch.randint(0, sh["m"] + 1, (g, n_pad), device=dev,
                               dtype=torch.int32, generator=gen)
        rows = torch.randint(-(1 << 31), 1 << 31,
                             (n_pad, 24 if sh["signed"] else 16), device=dev,
                             dtype=torch.int32, generator=gen)
        negm = (torch.rand((g, n_pad), device=dev, generator=gen) < 0.5
                if sh["signed"] else None)
        return digits, negm, rows, sh["lanes"]

    groups = {"the tuned 2^20 row": bench_group(20, select_config(1 << 20,
                                                                  dev)),
              "MsmConfig() at 2^20": bench_group(20, MsmConfig()),
              "a streamed 2^22 chunk's group": random_group(22),
              "the 2^12 call": bench_group(12, select_config(1 << 12, dev))}
    recs, sorted_recs = [], []
    for what, (digits, negm, rows, lanes) in groups.items():
        g, n_pad = digits.shape
        perm = torch.sort(digits, dim=1, stable=True)[1]
        shape = [g, n_pad, rows.shape[1], lanes]

        # ---- scan_madd_sorted against the pair it replaced ----
        def fused():
            return cc.scan_madd_sorted(perm, rows, negm, lanes)

        def pair():
            return cc.scan_madd(*cc.scan_layout(perm, rows, negm, lanes))

        check("scan_madd_sorted", f"{shape} ({what})", fused(), pair(),
              against="scan_madd(scan_layout)")
        runs = {"sorted": [], "pair": []}
        for which in ("sorted", "pair", "pair", "sorted"):
            runs[which].append(graph_ms(fused if which == "sorted"
                                        else pair))
        # The plain version on one window's first 8 steps' worth of points
        # (8 x lanes of the table, their digits and masks).
        cut = 8 * lanes
        cut_perm = torch.sort(digits[:1, :cut], dim=1, stable=True)[1]
        cut_rows = rows[:cut].contiguous()
        cut_negm = None if negm is None else negm[:1, :cut].contiguous()
        plain_ms = cuda_ms(lambda: cc.scan_madd_sorted_plain(
            cut_perm, cut_rows, cut_negm, lanes))
        rec = {"shape": str(shape), "what": what,
               "ms": statistics.mean(runs["sorted"]),
               "ms_runs": runs["sorted"], "pair_ms_runs": runs["pair"],
               "pair_ms": statistics.mean(runs["pair"]),
               "call_ms": cuda_ms(fused), "plain_ms": plain_ms,
               "plain_shape": str([1, cut, rows.shape[1], lanes]),
               **bound(sorted_work(perm, rows, negm)), "library_ms": None}
        log(2, f"time scan_madd_sorted {shape} ({what}) on the device: "
            f"{runs['sorted']} ms, the pair scan_madd(scan_layout) "
            f"{runs['pair']} ms (sorted / pair "
            f"{rec['ms'] / rec['pair_ms']:.4f}); plain {plain_ms:.4f} ms at "
            f"{rec['plain_shape']}; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} ({rec['ms'] / rec['bound_ms']:.2f} times "
            f"it)")
        sorted_recs.append(rec)

        # ---- scan_layout: its plain version and the replaced gathers ----
        # The planar tables the replaced formulation gathered from, (8,
        # n_pad) x and y, (8, 2·n_pad) y then -y with masks.
        ppx = rows[:, :8].t().contiguous()
        ppy = (torch.cat([rows[:, 8:16].t(), rows[:, 16:24].t()], dim=1)
               if negm is not None else rows[:, 8:16].t().contiguous())
        got = cc.scan_layout(perm, rows, negm, lanes)
        check("scan_layout", f"{shape} ({what})", got,
              cc.scan_layout_plain(perm, rows, negm, lanes))
        err = max_abs_err(got, replaced_layout(perm, ppx, ppy, negm, lanes))
        if err:
            raise AssertionError(f"scan_layout {shape}: differs from the "
                                 f"torch formulation it replaced")
        del got
        rec = timed("scan_layout", shape,
                    lambda: cc.scan_layout(perm, rows, negm, lanes),
                    lambda: cc.scan_layout_plain(perm, rows, negm, lanes),
                    layout_work(g, n_pad, rows.shape[1], negm is not None))
        rec["replaced_ms"] = graph_ms(
            lambda: replaced_layout(perm, ppx, ppy, negm, lanes))
        rec["what"] = what
        # Not a bound: the bytes' time were each window to read its 64
        # bytes of the table a point anew, as the kernel does.
        anew_ms = 1e3 * ((8 + 64 + 64 + (negm is not None)) * g * n_pad
                         / HBM_BYTES_PER_S)
        log(2, f"scan_layout {shape} ({what}): == the replaced torch "
            f"formulation (bit-identical); kernel {rec['ms']:.4f} ms, "
            f"replaced {rec['replaced_ms']:.4f} ms (the lane-major copy and "
            f"the gathers), plain {rec['plain_ms']:.4f} ms; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['ms'] / rec['bound_ms']:.2f} "
            f"times it); {anew_ms:.4f} ms to move the bytes with the table "
            f"read anew each window")
        recs.append(rec)
        del perm, ppx, ppy, digits, negm, rows, cut_perm, cut_rows, cut_negm
    first, *others = recs
    entries["scan_layout"].update(first, other_shapes=others)
    first, *others = sorted_recs
    entries["scan_madd_sorted"].update(first, other_shapes=others)
    torch.cuda.synchronize()


# The histogram's two regimes for bins that do not fit one block as int32
# (ops/hist.py, `plan`): split bins, 16-bit counters.
HIST_REGIMES = ("split", "u16")


def hist_work(g, n, m):
    """The histogram's work: each digit read once and each count written
    once (bytes), one add a digit."""
    from tpu_msm_torch.ops import hist

    return {"ops": g * n, "bytes": 4 * g * (n + hist.num_bins(m))}


def phase_hist(dev, entries, sh, scalars):
    """digit_hist against its plain version (bit-identical), one launch for
    a group of windows: at the main path's (G, 2^20) window digits of
    bench.py's scalars with the tuned row (m = 65535), where the regimes for
    bins that do not fit one block (split bins, 16-bit counters) are timed
    in turns (split, u16, u16, split); at (1, 2^20) sorted;
    at m = 8, 8191 and 32768 (one block's int32 counters); on a one-bin
    skew, a ragged n and n = 0. Each timed shape by CUDA-graph replay
    beside torch.bincount (one call on row·nb + digit) and, for the segment
    starts, torch.searchsorted of 1..m in the sorted rows."""
    import torch

    from tpu_msm_torch import select_config
    from tpu_msm_torch.ops import hist, pippenger

    check = checker(entries, 2)
    timed = timer(2)
    n, m, g = sh["n"], sh["m"], sh["g"]
    cfg = select_config(n, dev)
    sl = torch.from_numpy(scalars.view(np.int32)).to(dev)
    digits = (pippenger.signed_window_digits(sl, cfg)[0] if cfg.signed_digits
              else pippenger.window_digits(sl, cfg))[:g].contiguous()
    del sl
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def lib_calls(d, m):
        """torch.bincount of the flat row·nb + digit, and searchsorted of
        1..m in the sorted rows (the row offsets and the sort made once,
        outside the timing)."""
        nb = hist.num_bins(m)
        rows = d.shape[0]
        flat = (d.to(torch.int64) + nb * torch.arange(
            rows, device=dev)[:, None]).reshape(-1)
        srt = torch.sort(d, dim=1).values
        bvals = torch.arange(1, m + 1, dtype=d.dtype, device=dev).repeat(
            rows, 1)
        return (lambda: torch.bincount(flat, minlength=rows * nb),
                lambda: torch.searchsorted(srt, bvals, side="left",
                                           out_int32=True))

    def timed_hist(label, d, m):
        bincount, search = lib_calls(d, m)
        rec = timed("digit_hist", label, lambda: hist.digit_hist(d, m),
                    lambda: hist.digit_hist_plain(d, m),
                    hist_work(d.shape[0], d.shape[1], m), library=bincount)
        p = hist.plan(d.shape[0], d.shape[1], m, sms)
        rec.update(plan=str(p._asdict()),
                   searchsorted_ms=cuda_ms(search))
        log(2, f"digit_hist {label}: plan {p._asdict()}; torch.searchsorted "
            f"of 1..m in the sorted rows {rec['searchsorted_ms']:.4f} ms")
        return rec

    # ---- the main path's group: both regimes in turns ----
    label = [g, n, f"m {m}", "bench digits"]
    want = hist.digit_hist_plain(digits, m)
    for big in HIST_REGIMES:
        check("digit_hist", label + [big],
              hist.digit_hist(digits, m, big=big), want)
    runs = {big: [] for big in HIST_REGIMES}
    for big in HIST_REGIMES + HIST_REGIMES[::-1]:
        runs[big].append(graph_ms(lambda: hist.digit_hist(digits, m,
                                                          big=big)))
    ms = {big: statistics.mean(r) for big, r in runs.items()}
    log(2, "digit_hist regimes at " + str(label) + ": " + ", ".join(
        f"{big} {runs[big]} ms" for big in HIST_REGIMES) + "; faster: "
        + min(ms, key=ms.get) + "; the plan takes "
        + hist.plan(g, n, m, sms).regime)
    main = timed_hist(label, digits, m)
    main["regimes_ms"] = runs
    entries["digit_hist"].update(main)
    # The one-window (1-D) contract on the first window.
    check("digit_hist", [n, f"m {m}"], hist.digit_hist(digits[0], m),
          hist.digit_hist_plain(digits[0], m))

    # ---- other shapes: (1, n) sorted, the bins of other widths ----
    others = []
    srt = torch.sort(digits[:1], dim=1).values
    check("digit_hist", [1, n, f"m {m}", "sorted"], hist.digit_hist(srt, m),
          hist.digit_hist_plain(srt, m))
    others.append(timed_hist([1, n, f"m {m}", "sorted"], srt, m))
    del srt
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for mm in (8, 8191, 1 << 15):
        d = torch.randint(0, mm + 2, (g, n), generator=gen, device=dev,
                          dtype=torch.int32)
        d[0, : n // 8] = min(12345, mm)  # a heavy bin
        check("digit_hist", [g, n, f"m {mm}"], hist.digit_hist(d, mm),
              hist.digit_hist_plain(d, mm))
        others.append(timed_hist([g, n, f"m {mm}"], d, mm))
    del d
    # ---- edge cases, both regimes ----
    nb = hist.num_bins(m)
    skew = torch.full((3, 1 << 18), 12345, dtype=torch.int32, device=dev)
    skew[2] = m + 1
    ragged = digits[:3, 3:].contiguous()
    ragged[0, :5] = torch.tensor([nb, nb - 1, m + 2, 1 << 30, 0])
    for name, d in (("one bin", skew), ("ragged, past the last bin", ragged),
                    ("n = 0", digits[:, :0])):
        for big in HIST_REGIMES:
            check("digit_hist", [*d.shape, f"m {m}", name, big],
                  hist.digit_hist(d, m, big=big),
                  hist.digit_hist_plain(d, m))
    entries["digit_hist"]["other_shapes"] = others
    torch.cuda.synchronize()


def product_latency_ms(dev):
    """The latency of one Montgomery product with the port's field core:
    the montmul_chain kernel on one lane (chain 64, steps 8, ilp 1, every
    product depending on the one before), its time over the 512 products."""
    from tpu_msm_torch.benches import montmul_benchmark as mb
    from tpu_msm_torch.ops import cuda_curve as cc

    x = mb.inputs(1, dev)
    return cuda_ms(lambda: cc.montmul_chain(x, x, 64, 8, 1)) / (64 * 8)


def product_pipe_floor_ms():
    """A floor on one product's latency that the card sets, whatever the
    carry chains cost: the multiply pipe's issue slots of one product in
    the built montmul_chain kernel's SASS (montmul_benchmark.sass_counts:
    profiling.WIDE_IMAD_SLOTS for each wide or hi IMAD, one for each narrow
    one; not the carry adds and moves that run as IMAD.X and IMAD.MOV),
    each slot holding one scheduler's pipe 32 / (IMAD_PER_CLOCK_PER_SM / 4)
    = 2 clocks for a warp, at the SM clock's maximum. Returns (ms, slots)."""
    from tpu_msm_torch.benches import montmul_benchmark as mb
    from tpu_msm_torch.utils import profiling

    kinds = mb.sass_counts()["per_product_kinds"]
    slots = (profiling.WIDE_IMAD_SLOTS * (kinds["wide"] + kinds["hi"])
             + kinds["narrow"])
    clocks = slots * 32 / (profiling.IMAD_PER_CLOCK_PER_SM / 4)
    return clocks / profiling.sm_clock_hz() * 1e3, slots


def phase_tail(dev, entries, sh, big):
    """window_tail and horner against their plain versions (bit-identical)
    at the main path's W windows and c, signed and unsigned, with infinite
    inputs; then timed at the main path's digit sign beside the chain of
    `padd` launches they replace and their latency bound."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc

    check = checker(entries, 2)
    timed = timer(2)
    w, c = sh["w"], sh["c"]
    # X(n) and sum X(s_b): W seeded projective points; X(n) infinite at
    # window 1, sum X(s_b) at window 2 (the columns of `big` are finite).
    x_n = [tile(a, w) for a in big]
    sums = [tile(a.roll(w, dims=1), w) for a in big]
    x_n[0][:, 1], x_n[2][:, 1] = 0, 0
    sums[0][:, 2], sums[2][:, 2] = 0, 0
    # The plain versions take seconds here: each is timed by the call whose
    # result the check reads (once), the one at the main path's digit sign.
    signed = sh["signed"]
    plain_ms = {}
    for sgn in (True, False):
        want, ms = once(lambda: cc.window_tail_plain(*x_n, *sums, c, sgn))
        if sgn == signed:
            plain_ms["window_tail"] = ms
        check("window_tail", [16, w, f"c {c}", "signed" if sgn else
                              "unsigned"],
              cc.window_tail(*x_n, *sums, c, sgn), want)
    # (W, 16, 1) window sums, window 3 infinite.
    wsums = [tile(a.roll(2 * w, dims=1), w).t().reshape(w, 16, 1).contiguous()
             for a in big]
    wsums[0][3], wsums[2][3] = 0, 0
    want, plain_ms["horner"] = once(lambda: cc.horner_plain(*wsums, c))
    check("horner", [w, 16, 1, f"c {c}"], cc.horner(*wsums, c), want)
    HORNER_VERDICTS[str([w, 16, 1, c])] = 2

    lat = product_latency_ms(dev)
    floor, muls = product_pipe_floor_ms()
    tail_adds = (c - 1) * (1 if signed else 2) + 1
    horner_adds = (w - 1) * (c + 1)
    log(2, f"one Montgomery product's latency with the port's field core "
        f"(montmul_chain, one lane, chain 64, steps 8): {lat * 1e3:.4f} us; "
        f"the card's pipe floor for it "
        f"({muls} multiply-pipe slots at 2 clocks): "
        f"{floor * 1e3:.4f} us; serial adds: window_tail {tail_adds}, "
        f"horner {horner_adds}")
    old_tail = lambda: cc.window_tail_by_adds(  # noqa: E731
        cc.padd, *x_n, *sums, c, signed)
    old_horner = lambda: cc.horner_by_adds(cc.padd, *wsums, c)  # noqa: E731
    # Work: window_tail reads two (16, W) points and writes one, W chains;
    # horner reads W window sums and writes one, one chain.
    for name, fn, plain, adds, work, old in (
            ("window_tail", lambda: cc.window_tail(*x_n, *sums, c, signed),
             lambda: cc.window_tail_plain(*x_n, *sums, c, signed),
             tail_adds, ec_work(12 * tail_adds * w, w, 96 + 48), old_tail),
            ("horner", lambda: cc.horner(*wsums, c),
             lambda: cc.horner_plain(*wsums, c), horner_adds,
             ec_work(12 * horner_adds, w + 1, 48), old_horner)):
        rec = timed(name, [16, w, f"c {c}", "signed" if signed else
                           "unsigned"], fn, plain, work,
                    plain_ms=plain_ms[name])
        latency = adds * 2 * lat
        pipe = adds * 2 * floor
        old_ms = cuda_ms(old)
        # bound_ms: the card's floor (two dependent products an add at the
        # pipe floor, or the throughput bound); latency_bound_ms: the same
        # chain at the port's own product latency, which moves with the
        # field core.
        rec.update(throughput_bound_ms=rec["bound_ms"],
                   pipe_floor_ms=pipe, latency_bound_ms=latency,
                   bound_ms=max(pipe, rec["bound_ms"]),
                   bound_by="operations", bound_kind="serial latency",
                   serial_adds=adds, old_chain_ms=old_ms,
                   old_chain_launches=adds)
        log(2, f"{name}: {rec['ms']:.4f} ms in one launch; latency bound "
            f"with the port's core {latency:.4f} ms ({adds} adds x 2 "
            f"products x {lat * 1e3:.4f} us), the card's pipe floor "
            f"{pipe:.4f} ms; the chain of {adds} padd launches it replaces "
            f"{old_ms:.4f} ms")
        entries[name].update(rec)
    both = cuda_ms(lambda: (cc.window_tail(*x_n, *sums, c, signed),
                            cc.horner(*wsums, c)))
    both_old = cuda_ms(lambda: (old_tail(), old_horner()))
    adds = tail_adds + horner_adds
    log(2, f"the serial tail (window_tail + horner): {both:.4f} ms in 2 "
        f"launches against {both_old:.4f} ms in {adds} padd launches; "
        f"latency bound with the port's core {adds * 2 * lat:.4f} ms, the "
        f"card's pipe floor {adds * 2 * floor:.4f} ms")
    torch.cuda.synchronize()


def bench_inputs(n):
    """bench.py's inputs: 512 distinct points tiled to n, seeded scalars
    (< 2^254, then reduced mod r)."""
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    ks = interop.ints_to_limbs([1 + i * POINT_STEP for i in range(BASE_POINTS)])
    bx, by = native.ec_mul_batch((bn254.GX, bn254.GY), ks)
    reps = -(-n // BASE_POINTS)
    px = np.ascontiguousarray(np.tile(bx, reps)[:, :n])
    py = np.ascontiguousarray(np.tile(by, reps)[:, :n])
    rng = np.random.RandomState(1)
    sl = np.frombuffer(rng.bytes(32 * n), dtype="<u2").reshape(n, 16).T
    sl = sl.astype(np.uint32)
    sl[15] &= 0x3FFF
    sl = interop.ints_to_limbs([s % bn254.FR for s in interop.limbs_to_ints(sl)])
    return px, py, sl


def counters():
    """({kernel name: (wrapper, counter attribute)}, [plain versions]) of
    every kernel. padd.launches counts both padd kernels, padd_group_kernel's
    own are padd.group_launches; fold_add's and pmadd's likewise."""
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist

    kernels = {name: (fn, "launches") for name, fn in (
        ("scan_madd", cc.scan_madd), ("padd", cc.padd),
        ("window_tail", cc.window_tail), ("horner", cc.horner),
        ("fold_add", cc.fold_add), ("digit_hist", hist.digit_hist),
        ("pmadd", cc.pmadd), ("jac_madd", cc.jac_madd),
        ("jac_add", cc.jac_add), ("scan_madd_rows", cc.scan_madd_rows),
        ("montmul_chain", cc.montmul_chain), ("scan_layout", cc.scan_layout),
        ("scan_madd_sorted", cc.scan_madd_sorted))}
    kernels["padd_group"] = (cc.padd, "group_launches")
    kernels["fold_add_group"] = (cc.fold_add, "group_launches")
    kernels["pmadd_group"] = (cc.pmadd, "group_launches")
    plains = [cc.scan_madd_plain, cc.padd_plain, cc.window_tail_plain,
              cc.horner_plain, cc.fold_add_plain, hist.digit_hist_plain,
              cc.pmadd_plain, cc.jac_madd_plain, cc.jac_add_plain,
              cc.scan_madd_rows_plain, cc.montmul_chain_plain,
              cc.scan_layout_plain, cc.scan_madd_sorted_plain]
    return kernels, plains


def reset_counts():
    kernels, plains = counters()
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    for fn in plains:
        fn.calls = 0


MAIN_KERNELS = ("scan_madd_sorted", "padd", "fold_add", "digit_hist",
                "window_tail", "horner")
# The unfused pair scan_madd_sorted replaced: the fused route launches
# neither.
UNFUSED = ("scan_layout", "scan_madd")
# Kernels whose wrapper counts a second kernel's launches too: its own are
# the wrapper's count less the second's.
SHARED_COUNTS = {"padd": "padd_group", "fold_add": "fold_add_group",
                 "pmadd": "pmadd_group"}


def read_counts(phase, path_kernels, absent=()):
    """The counts since reset_counts(); raises unless every kernel of the
    path launched, none of `absent` did and no plain version ran."""
    kernels, plains = counters()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
    calls = {fn.__name__: fn.calls for fn in plains}
    log(phase, f"kernel launches {launches}; plain calls {calls}")
    missing = [k for k in path_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")
    off = {k: launches[k] for k in absent if launches[k]}
    if off:
        raise AssertionError(f"kernels off the path launched: {off}")
    if any(calls.values()):
        raise AssertionError(f"a plain version ran on the card: {calls}")
    return launches


def phase_e2e(dev, inputs, expected):
    """msm_best at 2^12 and 2^20 against the native engine; the kernel
    counters over exactly these runs. Returns the launches and the fused
    msm_device time at 2^20 in ms."""
    import torch

    import tpu_msm_torch

    reset_counts()
    for log_n, (px, py, sl) in inputs.items():
        got = tpu_msm_torch.msm_best(sl, (px, py), device=dev)
        if got != expected[log_n]:
            raise AssertionError(f"msm_best n=2^{log_n}: {got} != native "
                                 f"{expected[log_n]}")
        log(3, f"msm_best n=2^{log_n} == native engine (affine, exact)")
    px, py, sl = inputs[20]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tpu_msm_torch.msm_best(sl, (px, py), device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if got != expected[20]:
            raise AssertionError("msm_best n=2^20 changed between runs")
    med = statistics.median(times)
    log(3, f"msm_best n=2^20: median {med:.4f} s of {[round(t, 4) for t in times]}"
        f" -> {(1 << 20) / med:.1f} points/s")
    launches = read_counts(3, MAIN_KERNELS, UNFUSED)

    # The device pipeline alone on device-resident inputs (no host-side
    # coercion, transfer or affine conversion), as bench.py times it.
    from tpu_msm_torch.utils import interop

    cfg = tpu_msm_torch.select_config(1 << 20)
    dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, dev)
    dev_ms = cuda_ms(lambda: tpu_msm_torch.msm_device(dpx, dpy, dsl, cfg))
    log(3, f"msm_device n=2^20 on device-resident inputs: {dev_ms:.3f} ms "
        f"-> {(1 << 20) / dev_ms * 1e3:.1f} points/s")
    # One call's launches and peak memory: ceil(W / G) scan launches (the
    # sorted scan; no layout, no scan of a written layout), the
    # wide padd calls (lane-carry scan, query adds, rolled tree; each on the
    # kernel kernel_path gives its width) and one launch of each tail kernel.
    from tpu_msm_torch.ops import cuda_curve as cc

    sh = main_shapes(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tpu_msm_torch.msm_device(dpx, dpy, dsl, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    one = read_counts(3, MAIN_KERNELS, UNFUSED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    padd_calls = {  # width: launches
        sh["w"] * sh["lanes"]: (sh["lanes"] - 1).bit_length(),
        sh["w"] * (sh["m"] + 1): 1,
        sh["w"] * sh["fanout"]: (min(sh["m_pad"], sh["fanout"]) - 1)
        .bit_length()}
    paths = {width: cc.kernel_path(width, sms) for width in padd_calls}
    fold_path = cc.kernel_path(sh["w"] * sh["fanout"], sms)
    want = {"scan_madd_sorted": -(-sh["w"] // sh["g"]), "scan_layout": 0,
            "scan_madd": 0,
            "digit_hist": -(-sh["w"] // sh["g"]), "window_tail": 1,
            "horner": 1, "padd": sum(padd_calls.values()),
            "padd_group": sum(k for width, k in padd_calls.items()
                              if paths[width] == "group"),
            "fold_add": 1, "fold_add_group": int(fold_path == "group")}
    if any(one[k] != v for k, v in want.items()):
        raise AssertionError(f"launches of one msm_device call at 2^20: "
                             f"{one}, expected {want}")
    log(3, f"msm_device n=2^20: G = {sh['g']} of {sh['w']} windows a scan "
        f"and histogram launch; launches {json.dumps(one)} (sorted scan "
        f"{one['scan_madd_sorted']}, layout {one['scan_layout']}, scan of a "
        f"layout {one['scan_madd']}, digit_hist "
        f"{one['digit_hist']}, padd {one['padd']}: "
        f"{one['padd'] - one['padd_group']} padd_kernel, "
        f"{one['padd_group']} padd_group_kernel, by width "
        f"{json.dumps({w: [k, paths[w]] for w, k in padd_calls.items()})}; "
        f"fold_add {fold_path}; tail {one['window_tail'] + one['horner']})")
    log(3, f"msm_device n=2^20 peak device memory: max_memory_allocated "
        f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB above its "
        f"inputs")
    return launches, dev_ms


def phase_new_kernels(dev):
    """pmadd, jac_madd, jac_add and scan_madd_rows against their plain
    versions (bit-identical): edge lanes first, then the shapes their paths
    give them, where both are also timed. Returns their JSON entries."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import curve
    from tpu_msm_torch.ops.curve import ProjPoint

    entries = {}
    check = checker(entries, 2)
    timed = timer(2)
    a_aff, b_aff = edge_affine(dev, 8192, SEED + 7)
    pa = to_proj(dev, a_aff, SEED + 8)
    ja, jb = to_jac(dev, a_aff, SEED + 9), to_jac(dev, b_aff, SEED + 10)

    def cut(ts, width):
        return [t[:, :width].contiguous() for t in ts]

    # ---- edge lanes: infinities, P + P, P + (-P) ----
    # Both pmadd kernels, at 8192 and at a ragged 8191, and at the golden
    # configurations' scan lanes, 8 and 64, on the edge columns.
    for width in (8192, 8191):
        ops = (*cut(pa, width), *cut(b_aff, width))
        want = cc.pmadd_plain(*ops)
        for path, name in PMADD.items():
            check(name, [16, width], cc.pmadd(*ops, path=path), want)
    for width in GOLDEN_LANES:
        cols = torch.tensor(edge_cols(width), device=dev)
        ops = [t.index_select(1, cols).contiguous() for t in (*pa, *b_aff)]
        want = cc.pmadd_plain(*ops)
        for path, name in PMADD.items():
            check(name, [16, width], cc.pmadd(*ops, path=path), want)
    for width in (1024, 8192):
        ops = (*cut(ja, width), *cut(b_aff, width))
        check("jac_madd", [16, width], cc.jac_madd(*ops),
              cc.jac_madd_plain(*ops))
        ops = (*cut(ja, width), *cut(jb, width))
        check("jac_add", [16, width], cc.jac_add(*ops), cc.jac_add_plain(*ops))
    # scan_madd_rows, a reduce-then-scan over K chunks of the steps
    # (cuda_curve.scan_rows_chunks): at the rule's K against the plain
    # version at the same K. At (16, 3, 1024), the --check-kernels shape,
    # with a repeat (the accumulator doubles) and mid-scan sentinels; at a
    # ragged (16, 101, 3000), 16 chunks of 6 steps and one of 5 on 132 SMs.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check_rows(gx, gy):
        _, steps, lanes = gx.shape
        k = cc.scan_rows_chunks(steps, lanes, sms)
        check("scan_madd_rows", [16, steps, lanes, f"K {k}"],
              cc.scan_madd_rows(gx, gy), cc.scan_madd_rows_plain(gx, gy, k))

    xs = [a_aff[0][:, :1024], b_aff[0][:, :1024], a_aff[0][:, :1024]]
    ys = [a_aff[1][:, :1024], b_aff[1][:, :1024], a_aff[1][:, :1024]]
    gx = torch.stack(xs, dim=1).contiguous()
    gy = torch.stack(ys, dim=1).contiguous()
    gx[:, 1, 500:520] = 0
    gy[:, 1, 500:520] = 0
    check_rows(gx, gy)
    check_rows(*(torch.stack([a.roll(k, dims=1)[:, :3000] for k in range(101)],
                             dim=1).contiguous() for a in a_aff))

    # ---- the paths' shapes, checked, then kernel and plain timed ----
    # pmadd: both kernels at the golden configurations' 8 and 64 scan
    # lanes, at the per-window route's 16384 lanes (one scan step at 2^20)
    # and, to place their crossover (cuda_curve.GROUP_BELOW_PER_SM), at
    # 4096, 8192, 65,536 and 2^20 elements. At 8 and 16384 also a call over
    # 20 back-to-back calls with the host's launch, as the route makes
    # them; the plain version is timed at each width up to 16384.
    recs = {}
    for width in (*GOLDEN_LANES, 4096, 8192, 16384, 65536, 1 << 20):
        ops = [tile(t[:, 1:], width) for t in (*pa, *b_aff)]
        want = cc.pmadd_plain(*ops)
        for path, name in PMADD.items():
            check(name, [16, width], cc.pmadd(*ops, path=path), want)
        del want
        if width <= 16384:
            plain_ms = cuda_ms(lambda: cc.pmadd_plain(*ops), inner=20)
        by_path = time_paths(
            2, "pmadd", [16, width], lambda path: cc.pmadd(*ops, path=path),
            plain_ms, ec_work(11 * finite(*ops[3:]), width, 80 + 48),
            cc.kernel_path(width, sms),
            plain_shape=[16, 16384] if width > 16384 else None)
        if width in (GOLDEN_LANES[0], 16384):
            for path in PMADD:
                by_path[path]["call_ms"] = cuda_ms(
                    lambda: cc.pmadd(*ops, path=path), inner=20)
            log(2, f"pmadd [16, {width}] a call with the host's launch: "
                f"thread {by_path['thread']['call_ms']:.4f} ms, group "
                f"{by_path['group']['call_ms']:.4f} ms")
        recs[width] = by_path
        del ops
    # Each kernel's entry leads with a width its path launches it at: the
    # thread kernel the per-window route's 16384, the group kernel the
    # golden configurations' 8.
    for (path, name), first in zip(PMADD.items(), (16384, GOLDEN_LANES[0])):
        entries[name].update(recs[first][path], other_shapes=[
            by_path[path] for width, by_path in recs.items()
            if width != first])
    # jac_madd and jac_add at 2^20 elements. Both adders compute every
    # lane (11 and 16 products), and the doubling (7 more) where P == Q.
    big = 1 << 20
    same = tile(((a_aff[0] == b_aff[0]).all(dim=0)
                 & (a_aff[1] == b_aff[1]).all(dim=0)
                 & (a_aff[0] != 0).any(dim=0))[None, 1:], big)
    dbl = int(same.sum().item())
    mops = [tile(t[:, 1:], big) for t in (*ja, *b_aff)]
    check("jac_madd", [16, big], cc.jac_madd(*mops), cc.jac_madd_plain(*mops))
    entries["jac_madd"].update(timed("jac_madd", [16, big],
                                     lambda: cc.jac_madd(*mops),
                                     lambda: cc.jac_madd_plain(*mops),
                                     ec_work(11 * big + 7 * dbl, big,
                                             80 + 48)))
    del mops
    aops = [tile(t[:, 1:], big) for t in (*ja, *jb)]
    check("jac_add", [16, big], cc.jac_add(*aops), cc.jac_add_plain(*aops))
    entries["jac_add"].update(timed("jac_add", [16, big],
                                    lambda: cc.jac_add(*aops),
                                    lambda: cc.jac_add_plain(*aops),
                                    ec_work(16 * big + 7 * dbl, big,
                                            96 + 48)))
    del aops
    # scan_madd_rows at (16, 256, 4096), at one chunk and at the rule's K,
    # each against the plain version at the same K, and the rule's against
    # the serial scan by projective equality; then both timed in turns (1,
    # K, K, 1), the plain version at 8 of the 256 steps in one chunk.
    steps, lanes = 256, 4096
    sx, sy = (torch.stack([a.roll(k, dims=1)[:, :lanes] for k in range(steps)],
                          dim=1).contiguous() for a in a_aff)
    rule = cc.scan_rows_chunks(steps, lanes, sms)
    serial = cc.scan_madd_rows_plain(sx, sy)
    check("scan_madd_rows", [16, steps, lanes, "K 1"],
          cc.scan_madd_rows(sx, sy, chunks=1), serial)
    got = cc.scan_madd_rows(sx, sy)
    check("scan_madd_rows", [16, steps, lanes, f"K {rule}"], got,
          cc.scan_madd_rows_plain(sx, sy, rule))
    if not bool(curve.proj_eq(ProjPoint(*got), ProjPoint(*serial)).all()):
        raise AssertionError(f"scan_madd_rows [16, {steps}, {lanes}] at K = "
                             f"{rule} is not the serial scan's points")
    log(2, f"scan_madd_rows [16, {steps}, {lanes}] at K = {rule} == the "
        f"serial scan (proj_eq)")
    del serial, got
    runs = {1: [], rule: []}
    for k in (1, rule, rule, 1):
        runs[k].append(graph_ms(lambda: cc.scan_madd_rows(sx, sy, chunks=k)))
    plain_ms = cuda_ms(lambda: cc.scan_madd_rows_plain(
        sx[:, :8].contiguous(), sy[:, :8].contiguous()))
    work = ec_work(11 * finite(sx, sy), steps * lanes, 32 + 48)
    recs = {k: {"shape": str([16, steps, lanes]), "chunks": k,
                "ms": statistics.mean(r), "ms_runs": r, "plain_ms": plain_ms,
                "plain_shape": str([16, 8, lanes]), **bound(work),
                "library_ms": None} for k, r in runs.items()}
    log(2, f"time scan_madd_rows [16, {steps}, {lanes}] on the device: K = 1 "
        f"{runs[1]} ms, K = {rule} {runs[rule]} ms; plain {plain_ms:.4f} ms "
        f"at [16, 8, {lanes}]; bound {recs[1]['bound_ms']:.4f} ms by "
        f"{recs[1]['bound_by']} ({work['ops']} int ops, {work['bytes']} "
        f"bytes)")
    entries["scan_madd_rows"].update(
        recs[rule], call_ms=cuda_ms(lambda: cc.scan_madd_rows(sx, sy)),
        other_shapes=[recs[1]])
    return entries


def phase_window_kernels(dev, entries):
    """padd, fold_add and digit_hist against their plain versions
    (bit-identical) at the shapes the per-window path at 2^20 gives them
    (16384 lanes, 64 steps, m = 2^15, fanout 2048); the checked shapes join
    entries. The sorted histogram is also timed."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist

    check = checker(entries, 2)
    big = [c[:, 1:] for c in
           to_proj(dev, edge_affine(dev, 8192, SEED + 11)[0], SEED + 12)]
    # padd: the 14-level lane scan at 16384, the m + 1 query adds, the
    # rolled tree at the fanout.
    for width in (16384, 32769, 2048):
        ops = [tile(c, width) for c in big]
        ops += [o.roll(1, dims=1).contiguous() for o in ops]
        want = cc.padd_plain(*ops)
        for path, name in PADD.items():
            check(name, [16, width], cc.padd(*ops, path=path), want)
    # fold_add: ec_reduce folds the 32768 X(s_b) down to 2048 lanes; both
    # kernels checked and timed.
    fold = [tile(c, 16 * 2048).reshape(16, 16, 2048) for c in big]
    want = cc.fold_add_plain(*fold)
    for path, name in FOLD.items():
        check(name, [16, 16, 2048], cc.fold_add(*fold, path=path), want)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_path = time_paths(2, "fold_add", [16, 16, 2048],
                         lambda path: cc.fold_add(*fold, path=path),
                         cuda_ms(lambda: cc.fold_add_plain(*fold)),
                         ec_work(12 * 16 * 2048, 17 * 2048, 48),
                         cc.kernel_path(2048, sms))
    for path, name in FOLD.items():
        entries[name]["other_shapes"].append(by_path[path])
    # digit_hist on sorted digits: every warp sees runs of equal values.
    m = 1 << 15
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    digits = torch.randint(0, m + 1, (1 << 20,), generator=gen, device=dev,
                           dtype=torch.int32)
    digits[: 1 << 17] = 12345
    digits = torch.sort(digits).values
    check("digit_hist", ["sorted", 1 << 20], hist.digit_hist(digits, m),
          hist.digit_hist_plain(digits, m))
    nb = hist.num_bins(m)
    rec = timer(2)("digit_hist", ["sorted", 1 << 20],
                   lambda: hist.digit_hist(digits, m),
                   lambda: hist.digit_hist_plain(digits, m),
                   {"ops": 1 << 20, "bytes": 4 * ((1 << 20) + nb)},
                   library=lambda: torch.bincount(digits, minlength=nb))
    entries["digit_hist"].setdefault("other_shapes", []).append(rec)


def phase_window(dev, inputs, expected, fused_ms):
    """tpu_msm_torch.msm through the per-window path at 2^20 (16384 scan
    lanes, c = 16 signed, fanout 2048), with each segment-start option,
    against the native engine; its counters, pmadd's launches (one a scan
    step) on the kernel the rule gives the route's width; its msm_device
    time beside the fused path's. Returns the launches."""
    import torch

    import tpu_msm_torch
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.utils import interop
    from tpu_msm_torch.utils.config import MsmConfig

    px, py, sl = inputs[20]
    cfgs = [MsmConfig(scan_lanes=16384),
            MsmConfig(scan_lanes=16384, segment_starts="hist_cols")]
    reset_counts()
    for cfg in cfgs:
        t0 = time.perf_counter()
        got = tpu_msm_torch.msm((px, py), sl, cfg=cfg, device=dev)
        dt = time.perf_counter() - t0
        if got != expected[20]:
            raise AssertionError(f"per-window msm n=2^20 ({cfg.segment_starts})"
                                 f": {got} != native {expected[20]}")
        log(4, f"per-window msm n=2^20 segment_starts={cfg.segment_starts} "
            f"== native engine (affine, exact), {dt:.4f} s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = cfgs[0].scan_lanes
    pmadd_path = cc.kernel_path(lanes, sms)
    launches = read_counts(4, ("pmadd", "padd", "padd_group", "fold_add",
                               "fold_add_group", "digit_hist", "window_tail",
                               "horner")
                           + (("pmadd_group",) if pmadd_path == "group"
                              else ()))
    if launches["scan_madd"]:
        raise AssertionError("the per-window path ran the fused scan")
    # One pmadd launch a scan step: W windows x ceil(n / lanes) steps a call,
    # each on the kernel kernel_path gives the route's width.
    steps = sum(c.num_windows() * -(-(1 << 20) // lanes) for c in cfgs)
    want = {"pmadd": steps,
            "pmadd_group": steps if pmadd_path == "group" else 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"per-window pmadd launches {launches}, "
                             f"expected {want}")
    log(4, f"per-window pmadd launches {launches['pmadd']} "
        f"({launches['pmadd_group']} pmadd_group_kernel): the rule takes "
        f"{pmadd_path} at {lanes} lanes on {sms} SMs")

    dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, dev)
    pw_ms = cuda_ms(lambda: tpu_msm_torch.msm_device(dpx, dpy, dsl, cfgs[0]))
    log(4, f"msm_device n=2^20 per-window path (16384 lanes): {pw_ms:.3f} ms, "
        f"main path (the tuned row): {fused_ms:.3f} ms "
        f"({pw_ms / fused_ms:.2f}x)")

    # The fused route at the same 16384 lanes, which the route rule does
    # not take: what the rule costs on this card.
    from tpu_msm_torch.cli.trace import msm_on_route

    got = affine(msm_on_route(dpx, dpy, dsl, cfgs[0], "fused"))
    if got != expected[20]:
        raise AssertionError(f"fused route at 16384 lanes: {got} != native "
                             f"{expected[20]}")
    f16_ms = cuda_ms(lambda: msm_on_route(dpx, dpy, dsl, cfgs[0], "fused"))
    log(4, f"fused route at 16384 lanes == native engine (affine, exact), "
        f"{f16_ms:.3f} ms; per-window / fused at 16384 lanes "
        f"{pw_ms / f16_ms:.2f}x")
    return launches


def affine(res):
    """A (16, 1) ProjPoint on the card -> affine int point."""
    from tpu_msm_torch.utils import interop

    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


def phase_profile(dev, inputs):
    """One torch.profiler run of msm_device (tpu_msm_torch.cli.trace) at
    2^20 with the tuned row, on each route of MsmConfig's defaults, and at
    2^18 and 2^20 with and without GLV (the tuned row with signed digits): the
    device's busy ms, span, idle share and time and launches per kernel, one
    JSON line each. Last of the phases, so that no timing runs after the
    profiler."""
    import dataclasses

    from tpu_msm_torch import msm_device, select_config
    from tpu_msm_torch.cli.trace import msm_on_route, profile
    from tpu_msm_torch.utils import interop
    from tpu_msm_torch.utils.config import MsmConfig

    def show(rec, **what):
        log(6, "profile " + json.dumps({**what, **rec}))

    dpx, dpy, dsl = interop.limbs_to_device(*inputs[20], dev)
    tuned = select_config(1 << 20, dev)
    show(profile(lambda: msm_device(dpx, dpy, dsl, tuned)), log_n=20,
         route="tuned", **dataclasses.asdict(tuned))
    for route, lanes in (("rule", 4096), ("rule", 16384), ("fused", 16384)):
        cfg = MsmConfig(scan_lanes=lanes)
        show(profile(lambda: msm_on_route(dpx, dpy, dsl, cfg, route)),
             log_n=20, route=route, lanes=lanes)
    for log_n in (18, 20):
        tpx, tpy, tsl = interop.limbs_to_device(*inputs[log_n], dev)
        base = dataclasses.replace(select_config(1 << log_n, dev),
                                   signed_digits=True)
        for g in (False, True):
            cfg = dataclasses.replace(base, glv=g)
            show(profile(lambda: msm_device(tpx, tpy, tsl, cfg)),
                 log_n=log_n, **dataclasses.asdict(cfg))


def phase_scan_rows_phases(dev, entries):
    """The device ms a launch of each of scan_madd_rows' three kernels at
    (16, 256, 4096) and the rule's K, by torch.profiler over 5 calls
    (benches/scan_rows_benchmark.py, its seeded inputs); into the kernel's
    entry as `phases_ms`. In phase 6, after every timing."""
    from tpu_msm_torch.benches import scan_rows_benchmark as srb
    from tpu_msm_torch.ops import cuda_curve as cc

    gx, gy = srb.inputs(256, 4096, dev)
    rec = srb.phases_ms(lambda: cc.scan_madd_rows(gx, gy))
    entries["scan_madd_rows"]["phases_ms"] = rec
    log(6, f"scan_madd_rows [16, 256, 4096] at K = "
        f"{entries['scan_madd_rows']['chunks']}, device ms a launch by "
        f"kernel: {json.dumps(rec)}")


# The CLI's runs in phase 5: the kernel check, and three modes each held
# against the native engine.
CLI_RUNS = (["--check-kernels"], ["16", "1", "check", "1"],
            ["22", "1", "stream", "1"], ["20", "1", "hybrid", "1"])


def phase_cli():
    """The profiler CLI in four subprocesses at once (CLI_RUNS):
    --check-kernels, `16 1 check 1`, `22 1 stream 1` and `20 1 hybrid 1`
    (each of the last three holds its result against the native engine; the
    check mode at 2^16, since phase 3 holds msm_best at 2^20 against it in
    process), with the fixture cache in a temporary directory. Returns the
    launches --check-kernels logged."""
    from tpu_msm_torch.utils import preprocess

    root = Path(__file__).resolve().parent
    launches = None
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, TPU_MSM_CACHE_DIR=cache)
        # The 2^22 fixture the stream mode reads, written here uncompressed:
        # the CLI's own compressed write takes minutes at that size, and
        # np.load reads either form.
        path = Path(cache) / "msm_vecs" / "msm_22x1.npz"
        path.parent.mkdir(parents=True)
        [inst] = preprocess.generate_msm_instances(22, 1)
        np.savez(path, px0=inst.px, py0=inst.py, s0=inst.scalars,
                 num=np.array([1]))
        del inst
        # The four processes run at once, each writing to its own files:
        # each pays an import and a build check, which then overlap.
        procs = []
        try:
            for i, args in enumerate(CLI_RUNS):
                out = open(Path(cache) / f"cli{i}.out", "w+")
                err = open(Path(cache) / f"cli{i}.err", "w+")
                procs.append((args, subprocess.Popen(
                    [sys.executable, "-m", "tpu_msm_torch.cli.profiler",
                     *args], cwd=root, env=env, stdout=out, stderr=err),
                    out, err))
            t0 = time.perf_counter()
            for args, proc, out, err in procs:
                proc.wait(timeout=600)
                out.seek(0)
                err.seek(0)
                lines = err.read().splitlines()
                for line in lines:
                    if " kernel " in line or "Execution" in line \
                            or "==" in line:
                        log(5, f"{' '.join(args)}: " + line.split(
                            " INFO ")[-1].split(" ERROR ")[-1])
                    if "kernel launches " in line:
                        launches = json.loads(
                            line.split("kernel launches ", 1)[1])
                if proc.returncode != 0:
                    raise AssertionError(
                        f"profiler {' '.join(args)}: rc {proc.returncode}\n"
                        + out.read() + "\n".join(lines[-40:]))
                mode = {"check": "gpu"}.get(args[2], args[2]) \
                    if len(args) == 4 else None
                if mode and not any(f"{mode} == cpu" in line
                                    for line in lines):
                    raise AssertionError(f"profiler {' '.join(args)}: no "
                                         f"check against the native engine "
                                         f"logged")
                log(5, f"profiler {' '.join(args)}: rc 0, done "
                    f"{time.perf_counter() - t0:.1f} s after the four "
                    f"started")
        finally:
            for _, proc, out, err in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()
    if launches is None or any(v == 0 for v in launches.values()):
        raise AssertionError(f"--check-kernels launches: {launches}")
    return launches


MONTMUL_LANES = 65536


def phase_montmul(dev, entries):
    """montmul_chain against its plain version (bit-identical) at 65,536
    lanes with ilp 1-8 at a cut of the chain (chain 8, steps 2), with
    starting accumulators >= P, 0, P - 1 and 2^256 - 1 on 1024 lanes each
    (a = x on the rest); then timed at the microbench's shape (chain 64,
    steps 8) at ilp 1 beside its plain version, and at ilp 4 and 8."""
    import torch

    from tpu_msm_torch.benches import montmul_benchmark as mb
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.utils import interop

    check = checker(entries, 7)
    x = mb.inputs(MONTMUL_LANES, dev)
    a = x.clone()
    a[15, :1024] = 0xFFFF  # >= P, as the XOR fold can make them
    for k, v in enumerate((0, bn254.P - 1, bn254.R - 1), start=1):
        a[:, 1024 * k:1024 * (k + 1)] = torch.from_numpy(
            interop.ints_to_limbs([v]).view(np.int32)).to(dev)
    label = "a >= P, 0, P - 1, 2^256 - 1, = x"
    for ilp in range(1, cc.MONTMUL_MAX_ILP + 1):
        check("montmul_chain", [16, MONTMUL_LANES, "chain 8", "steps 2",
                                f"ilp {ilp}", label],
              cc.montmul_chain(a, x, 8, 2, ilp),
              cc.montmul_chain_plain(a, x, 8, 2, ilp))
    entries["montmul_chain"].update(timer(7)(
        "montmul_chain", [16, MONTMUL_LANES, "chain 64", "steps 8", "ilp 1"],
        lambda: cc.montmul_chain(x, x, 64, 8, 1),
        lambda: cc.montmul_chain_plain(x, x, 64, 8, 1),
        ec_work(MONTMUL_LANES * 64 * 8, MONTMUL_LANES, 48)))
    others = []
    for ilp in (4, 8):
        shape = [16, MONTMUL_LANES, "chain 64", "steps 8", f"ilp {ilp}"]
        ms = graph_ms(lambda: cc.montmul_chain(x, x, 64, 8, ilp))
        rec = {"shape": str(shape), "ms": ms, **bound(ec_work(
            MONTMUL_LANES * 64 * 8 * ilp, MONTMUL_LANES, 48))}
        log(7, f"time montmul_chain {shape}: kernel {ms:.4f} ms on the "
            f"device; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}")
        others.append(rec)
    entries["montmul_chain"]["other_shapes"] = others
    lat = product_latency_ms(dev)
    floor, muls = product_pipe_floor_ms()
    log(7, f"one Montgomery product's latency (montmul_chain, one lane, "
        f"chain 64, steps 8): {lat * 1e3:.4f} us; the pipe floor for its "
        f"{muls} multiply-pipe slots: {floor * 1e3:.4f} us")


def phase_bound_model(dev):
    """The question behind every "operations" bound: does a wide IMAD take
    one issue slot of the multiply pipe or two? montmul_chain on 65,536
    lanes at ilp 4 and 8 (throughput, not latency, binds there), each
    launched back to back for about a second with the SM clock sampled by
    nvidia-smi while they run; the rate against one product's SASS
    (montmul_benchmark.sass_counts, by kind) gives the multiply pipe's
    warp instructions an SM clock under each slot count
    (montmul_benchmark.pipe_rates)."""
    import torch

    from tpu_msm_torch.benches import montmul_benchmark as mb
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.utils import profiling

    sass = mb.sass_counts()
    log(7, "sass one product: kinds " + json.dumps(sass["per_product_kinds"])
        + "; IMAD family " + json.dumps(sass["per_product"]) + "; all "
        + json.dumps(sass["per_product_all"]))
    x = mb.inputs(MONTMUL_LANES, dev)
    sms = profiling.sm_count(dev)
    for ilp in (4, 8):
        fn = lambda: cc.montmul_chain(x, x, 64, 8, ilp)  # noqa: E731
        reps = max(1, math.ceil(1000.0 / _events_ms(fn, 1)))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        clock = float(profiling._smi("clocks.sm")) * 1e6  # while they run
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        rate = MONTMUL_LANES * 64 * 8 * ilp / (ms * 1e-3)
        out = {"ilp": ilp, "ms": ms, "mont_mul_per_s": rate,
               "sm_clock_hz_max": profiling.sm_clock_hz(),
               **mb.pipe_rates(rate, sass, sms, clock)}
        log(7, "bound model (at the SM clock under load) " + json.dumps(out))


def phase_roofline(dev):
    """The roofline path: the microbench (`--lanes 65536 --chain 64
    --steps 8 --iters 3`) at ilp 1 and 4, then `profiling.roofline(20)`
    with the better rate; the counters over exactly these runs. Also the
    IMAD-family instructions of the kernel's SASS. Returns the launches."""
    from tpu_msm_torch.benches import montmul_benchmark as mb
    from tpu_msm_torch.utils import profiling

    reset_counts()
    rates = []
    for ilp in (1, 4):
        out = mb.run(MONTMUL_LANES, 64, 8, 3, ilp)
        c = out["cios"]
        rates.append(c["mont_mul_per_s"])
        log(7, f"montmul_benchmark ilp {ilp}: {c['mont_mul_per_s']:.1f} "
            f"mont-mul/s in {c['seconds'] * 1e3:.4f} ms; model bound "
            f"{c['roofline_per_s']:.1f} /s; model / measured "
            f"{c['ratio_to_roofline']:.4f} ({out['card']})")
    roof = profiling.roofline(20, kernel_rates={"cios": max(rates)})
    log(7, "roofline " + json.dumps(roof))
    launches = read_counts(7, ("montmul_chain",))
    log(7, "sass " + json.dumps(mb.sass_counts()))
    return launches


def phase_glv(dev, inputs, expected):
    """tpu_msm_torch.msm with glv=True at 2^18 and 2^20 against the native
    engine, on the tuned row with signed digits; msm_device timed by CUDA
    events with and without GLV, in turns, in this run; and the split's
    own time."""
    import dataclasses

    import tpu_msm_torch
    from tpu_msm_torch.ops import pippenger
    from tpu_msm_torch.ops.curve import AffinePoint
    from tpu_msm_torch.utils import interop

    for log_n in (18, 20):
        px, py, sl = inputs[log_n]
        base = dataclasses.replace(tpu_msm_torch.select_config(1 << log_n,
                                                               dev),
                                   signed_digits=True)
        reset_counts()
        got = tpu_msm_torch.msm((px, py), sl,
                                cfg=dataclasses.replace(base, glv=True),
                                device=dev)
        if got != expected[log_n]:
            raise AssertionError(f"GLV msm n=2^{log_n}: {got} != native "
                                 f"{expected[log_n]}")
        read_counts(8, ("scan_madd_sorted", "padd", "digit_hist",
                        "window_tail", "horner"), UNFUSED)
        log(8, f"GLV msm n=2^{log_n} == native engine (affine, exact)")
        dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, dev)
        times = {False: [], True: []}
        for g in (False, True, True, False):
            cfg = dataclasses.replace(base, glv=g)
            times[g].append(cuda_ms(
                lambda: tpu_msm_torch.msm_device(dpx, dpy, dsl, cfg)))
        log(8, f"msm_device n=2^{log_n} {dataclasses.asdict(base)}: glv "
            f"off {times[False]} ms, on {times[True]} ms (on / off "
            f"{sum(times[True]) / sum(times[False]):.4f})")
        glv_cfg = dataclasses.replace(base, glv=True)
        split_ms = cuda_ms(lambda: pippenger._glv_split(
            AffinePoint(dpx, dpy), dsl, glv_cfg))
        log(8, f"GLV split (decompose_limbs and BETA·x) n=2^{log_n}: "
            f"{split_ms:.3f} ms")


def phase_tuning(dev, inputs, expected):
    """select_config at 2^16, 2^18 and 2^20 on the card is the "cuda" row;
    benchmark_gpu_msm_best(16) is positive; msm_best at 2^16 equals the
    native engine."""
    import tpu_msm_torch
    from tpu_msm_torch.bindings import benchmarks
    from tpu_msm_torch.utils import autotune

    for log_n in (16, 18, 20):
        row = autotune.lookup(1 << log_n, "cuda")
        cfg = tpu_msm_torch.select_config(1 << log_n, dev)
        if row is None or any(getattr(cfg, k) != v for k, v in row.items()):
            raise AssertionError(f"select_config(2^{log_n}) = {cfg} is not "
                                 f"the cuda row {row}")
        log(9, f"select_config(2^{log_n}) on the card == cuda row {row}")
    ms = benchmarks.benchmark_gpu_msm_best(16)
    if not ms > 0:
        raise AssertionError(f"benchmark_gpu_msm_best(16) = {ms}")
    log(9, f"benchmark_gpu_msm_best(16): {ms:.3f} ms")
    px, py, sl = inputs[16]
    got = tpu_msm_torch.msm_best(sl, (px, py), device=dev)
    if got != expected[16]:
        raise AssertionError(f"msm_best n=2^16: {got} != native "
                             f"{expected[16]}")
    log(9, "msm_best n=2^16 == native engine (affine, exact)")


def phase_options(dev, inputs, expected):
    """The configurations the tuned row does not take, each against the
    tuned row's result on the same inputs (the native engine's, phases 3
    and 9): msm_device at 2^20 with c = 13 signed windows (bits extracted
    across limbs; 20 windows, one histogram launch a group), and at 2^16
    with segment_starts "bincount" and "ss_scan" (no histogram launch);
    each beside the tuned row's msm_device time."""
    import dataclasses

    import tpu_msm_torch
    from tpu_msm_torch.ops import pippenger
    from tpu_msm_torch.utils import interop

    for log_n, change in ((20, dict(window_bits=13, signed_digits=True)),
                          (16, dict(segment_starts="bincount")),
                          (16, dict(segment_starts="ss_scan"))):
        tuned = tpu_msm_torch.select_config(1 << log_n, dev)
        cfg = dataclasses.replace(tuned, **change)
        dpx, dpy, dsl = interop.limbs_to_device(*inputs[log_n], dev)
        reset_counts()
        got = affine(tpu_msm_torch.msm_device(dpx, dpy, dsl, cfg))
        if got != expected[log_n]:
            raise AssertionError(f"msm_device n=2^{log_n} {change}: {got} != "
                                 f"the tuned row's {expected[log_n]}")
        hist_path = cfg.segment_starts in ("hist", "hist_cols")
        one = read_counts(10, ("scan_madd_sorted", "padd", "window_tail",
                               "horner")
                          + (("digit_hist",) if hist_path else ()), UNFUSED)
        groups = -(-cfg.num_windows() // pippenger.window_group_size(
            cfg.num_windows(), 1 << log_n, dev))
        if one["digit_hist"] != (groups if hist_path else 0):
            raise AssertionError(f"digit_hist launches {one['digit_hist']} "
                                 f"with {change}, {groups} groups")
        times = {k: cuda_ms(lambda: tpu_msm_torch.msm_device(
            dpx, dpy, dsl, c)) for k, c in (("change", cfg),
                                            ("tuned", tuned))}
        log(10, f"msm_device n=2^{log_n} {change} == the tuned row's result "
            f"(affine, exact); {cfg.num_windows()} windows in {groups} "
            f"group(s), digit_hist launches {one['digit_hist']}; "
            f"{times['change']:.3f} ms, the tuned row {times['tuned']:.3f} ms")


# --------------------------------------------------------------------------
# The single-card surface beyond msm_device: streaming, hybrid, the golden
# vectors, limb tensors on the card.
# --------------------------------------------------------------------------

STREAM_LOG = 24


class RouteSpy:
    """While active, wraps the kernel wrappers the routes call
    (pippenger's imports of cuda_curve's scan_madd_sorted, padd, pmadd,
    fold_add, window_tail and horner; hist.digit_hist, which the segment
    starts call)
    and records, for each kernel and input shape, the launches its calls
    made and a copy of the first call's inputs. padd, pmadd and fold_add
    are recorded under the kernel their rule took (padd or padd_group, ...).
    The wrappers count their launches as before."""

    def __init__(self):
        from tpu_msm_torch.ops import hist, pippenger

        self.targets = [(pippenger, name) for name in (
            "scan_madd_sorted", "padd", "pmadd", "fold_add", "window_tail",
            "horner")]
        self.targets.append((hist, "digit_hist"))
        self.calls = {}  # (kernel, shape) -> {"launches": k, "args": ...}

    class _Spy:
        """Calls fn and records the call; reads and writes of its counters
        (`digit_hist.launches += 1` inside hist.py names the module's
        attribute, which is the spy while it is active) go to fn."""

        def __init__(self, route, name, fn):
            object.__setattr__(self, "_parts", (route, name, fn))

        def __getattr__(self, attr):
            return getattr(self._parts[2], attr)

        def __setattr__(self, attr, value):
            setattr(self._parts[2], attr, value)

        def __call__(self, *args, **kw):
            route, name, fn = self._parts
            before = (fn.launches, getattr(fn, "group_launches", 0))
            out = fn(*args, **kw)
            launched = fn.launches - before[0]
            group = getattr(fn, "group_launches", 0) - before[1]
            kernel = f"{name}_group" if group else name
            record(route.calls, kernel, args, launched)
            return out

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._Spy(self, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def record(calls, kernel, args, launched):
    """Adds a call of `kernel` on `args` that made `launched` launches to
    `calls`, {(kernel, shape): {"launches", "args"}}: the shape is the first
    operand's and the call's other arguments but tensors and None; the
    first call at a shape keeps a copy of its arguments."""
    import torch

    shape = [*args[0].shape] + [a for a in args[1:] if a is not None
                                and not isinstance(a, torch.Tensor)]
    key = (kernel, str(shape))
    if key not in calls:  # copy the first call's inputs only
        calls[key] = {"launches": 0, "args": tuple(
            a.clone() if isinstance(a, torch.Tensor) else a for a in args)}
    calls[key]["launches"] += launched


def op_calls(fn, name):
    """(fn(), the calls of operator tpu_msm_torch::<name> it made, recorded
    as RouteSpy records a wrapper's, with the launches the wrapper's
    counter gained): a loaded export program calls the operators, not the
    wrappers RouteSpy replaces, so a dispatch mode sees them here."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu_msm_torch.ops import cuda_curve as cc

    op = getattr(torch.ops.tpu_msm_torch, name).default
    counter = getattr(cc, name)
    calls = {}

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = counter.launches
            out = func(*args, **(kwargs or {}))
            if func is op:
                record(calls, name, args, counter.launches - before)
            return out

    with Spy():
        out = fn()
    return out, calls


# The shapes ("[W, 16, 1, c]") at which horner has been held against its
# plain version in this run, each with the phase that did it. The plain
# horner takes 7-11 s at (16, 16, 1) and c = 16 (255 serial plain adds), so
# a shape is checked once in the run and its verdict reused after.
HORNER_VERDICTS = {}


def check_route(phase, entries, calls):
    """Each kernel the route launched, at each shape it launched it at,
    against its plain version on the inputs of its first call there,
    bit for bit; the scan on its first 8 steps (a prefix scan's first
    steps depend on nothing after them), the sorted scan on its first 8
    steps and in full against the unfused pair scan_madd(scan_layout(...));
    horner at a shape already checked in the run takes that verdict
    (HORNER_VERDICTS). Returns
    {kernel: [{"shape", "launches"}]}, with "verdict_from": the phase
    whose check a shape reused, where it was not checked on these inputs.
    Logs the seconds the checks took, by kernel."""
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist

    check = checker(entries, phase)
    by_kernel, seconds = {}, {}
    for (kernel, shape), rec in sorted(calls.items()):
        t0 = time.perf_counter()
        args = rec["args"]
        base = kernel.removesuffix("_group")
        path = ({"path": "group" if kernel.endswith("_group") else "thread"}
                if base in ("padd", "pmadd", "fold_add") else {})
        label = f"{shape}, {rec['launches']} launches"
        entry = {"shape": shape, "launches": rec["launches"]}
        if base == "horner" and shape in HORNER_VERDICTS:
            entry["verdict_from"] = HORNER_VERDICTS[shape]
            log(phase, f"horner {label}: checked at this shape in phase "
                f"{HORNER_VERDICTS[shape]}, its verdict reused")
        elif base == "scan_madd_sorted":
            got = cc.scan_madd_sorted(*args)
            check(kernel, label, got, cc.scan_madd(*cc.scan_layout(*args)),
                  against="scan_madd(scan_layout)")
            check(kernel, f"{label}, first 8 steps",
                  got[:, :, :8].contiguous(), sorted_head_plain(*args))
            del got
        elif base == "scan_madd":
            head = [a[:, :, :8].contiguous() for a in args]
            check(kernel, f"{label}, first 8 steps",
                  cc.scan_madd(*args)[:, :, :8].contiguous(),
                  cc.scan_madd_plain(*head))
        elif base == "digit_hist":
            check(kernel, label, hist.digit_hist(*args),
                  hist.digit_hist_plain(*args))
        else:
            check(kernel, label, getattr(cc, base)(*args, **path),
                  getattr(cc, f"{base}_plain")(*args))
            if base == "horner":
                HORNER_VERDICTS[shape] = phase
        by_kernel.setdefault(kernel, []).append(entry)
        seconds[kernel] = seconds.get(kernel, 0) + time.perf_counter() - t0
    log(phase, f"the route's checks took, by kernel (s): "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    return by_kernel


def shape_list(shapes) -> str:
    """check_route's shapes for a log line: [shape, launches] each, with
    the phase whose verdict it took where the check was reused."""
    return json.dumps({k: [[r["shape"], r["launches"]] + (
        [f"verdict of phase {r['verdict_from']}"] if "verdict_from" in r
        else []) for r in v] for k, v in shapes.items()})


def phase_stream(dev, entries):
    """msm_best at 2^24 from numpy limb arrays (bench.py's 512 points tiled,
    scalars drawn in numpy below 2^253) through the streamed route, against
    the MSM folded onto the 512 base points by the native engine
    (`benches/dispatch_benchmark.tiled_expected`); the chunks and the
    launches of the route asserted. Then the same inputs as tensors on the
    card through msm_streamed (resident), where every kernel the route
    launches is held against its plain version at each shape it launches it
    at (RouteSpy, check_route); from numpy through msm_streamed
    host-streamed (the pinned staging buffers), bit-identical to the
    resident call; and through msm_device unstreamed; each equal to the
    reference, with their times, peak memory and G. Returns the streamed
    call's launches."""
    import torch

    import tpu_msm_torch
    from tpu_msm_torch.benches import dispatch_benchmark as db
    from tpu_msm_torch.ops import streaming
    from tpu_msm_torch.utils import interop

    n = 1 << STREAM_LOG
    t0 = time.perf_counter()
    px, py, sl, base = db.tiled_inputs(n, SEED)
    expected = db.tiled_expected(base, sl)
    log(11, f"2^{STREAM_LOG} inputs and the 512-point reference in "
        f"{time.perf_counter() - t0:.1f} s")
    chunk_log = tpu_msm_torch.STREAM_THRESHOLD.bit_length() - 1
    chunks = -(-n // (1 << chunk_log))
    sh = main_shapes(dev, chunk_log)
    groups = -(-sh["w"] // sh["g"])
    if n <= tpu_msm_torch.STREAM_THRESHOLD:
        raise AssertionError("2^24 does not exceed STREAM_THRESHOLD")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    dt = db.host_seconds(lambda: expected_is(
        tpu_msm_torch.msm_best(sl, (px, py), device=dev), expected,
        "msm_best 2^24 (streamed)"))
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(11, MAIN_KERNELS, UNFUSED)
    want = {"scan_madd_sorted": chunks * groups, "window_tail": chunks,
            "horner": 1}
    if tpu_msm_torch.select_config(1 << chunk_log, dev).segment_starts in (
            "hist", "hist_cols"):
        want["digit_hist"] = chunks * groups
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"streamed msm_best at 2^{STREAM_LOG}: "
                             f"launches {launches}, expected {want}")
    log(11, f"msm_best n=2^{STREAM_LOG} == the 512-point reference (affine, "
        f"exact) through the streamed route: {chunks} chunks of "
        f"2^{chunk_log}, G = {sh['g']} of {sh['w']} windows, sorted scan "
        f"and digit_hist launches {launches['scan_madd_sorted']} and "
        f"{launches['digit_hist']} ({chunks} x {groups}); {dt:.4f} s from "
        f"numpy -> {n / dt:.1f} points/s; peak max_memory_allocated "
        f"{peak / 2**20:.1f} MiB")

    d = interop.limbs_to_device(px, py, sl, dev)
    with RouteSpy() as spy:
        resident = streaming.msm_streamed(*d, chunk_log=chunk_log, device=dev)
    expected_is(affine(resident), expected,
                f"msm_streamed 2^{STREAM_LOG} resident, kernels recorded")
    shapes = check_route(11, entries, spy.calls)
    del spy
    own = {k: v - launches.get(SHARED_COUNTS.get(k), 0)
           for k, v in launches.items()}
    for kernel, v in own.items():
        total = sum(r["launches"] for r in shapes.get(kernel, []))
        if total != v:
            raise AssertionError(f"{kernel}: {total} launches recorded by "
                                 f"shape, {v} in the msm_best call")
    for kernel, recs in shapes.items():
        entries[kernel]["stream_shapes"] = recs
    log(11, f"every kernel of the streamed route == its plain version at "
        f"each shape it launched it at (or an earlier phase's, where "
        f"marked): "
        f"{shape_list(shapes)}")

    cfg = tpu_msm_torch.select_config(n, dev)
    full = main_shapes(dev, STREAM_LOG)
    runs = {"streamed, resident tensors": lambda: streaming.msm_streamed(
                *d, chunk_log=chunk_log, device=dev),
            "streamed, host-streamed from numpy": lambda:
                streaming.msm_streamed(px, py, sl, chunk_log=chunk_log,
                                       resident=False, device=dev),
            "unstreamed msm_device": lambda: tpu_msm_torch.msm_device(
                *d, cfg)}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        expected_is(affine(res), expected, f"{name} 2^{STREAM_LOG}")
        if name.startswith("streamed") and not all(
                torch.equal(a, b) for a, b in zip(res, resident)):
            raise AssertionError(f"{name}: projective limbs differ from the "
                                 f"resident call's")
        peak = torch.cuda.max_memory_allocated()
        times = [db.host_seconds(fn) for _ in range(2)]
        log(11, f"{name} n=2^{STREAM_LOG} == the 512-point reference"
            + ("; projective limbs == the resident call's"
               if name.startswith("streamed") else "")
            + f"; {[round(t * 1e3, 3) for t in times]} ms; peak "
            f"max_memory_allocated {peak / 2**20:.1f} MiB; G = "
            + (f"{sh['g']} of {sh['w']} windows (a chunk)"
               if name.startswith("streamed") else
               f"{full['g']} of {full['w']} windows"))
    return launches


def expected_is(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: {got} != {want}")
    return got


def phase_hybrid(dev, inputs, expected):
    """hybrid.msm_hybrid at 2^20 at the ladder's shares 1/3, 1/2, 2/3 and at
    1.0, each equal to the native engine and timed on the host clock beside
    msm alone on the same inputs."""
    import tpu_msm_torch
    from tpu_msm_torch.benches import dispatch_benchmark as db
    from tpu_msm_torch.hybrid import msm_hybrid

    px, py, sl = inputs[20]
    reset_counts()
    for share in (1 / 3, 1 / 2, 2 / 3, 1.0):
        dt = db.host_seconds(lambda: expected_is(
            msm_hybrid(px, py, sl, share=share, device=dev), expected[20],
            f"hybrid share {share:.4f}"))
        log(12, f"msm_hybrid n=2^20 share {share:.4f} == native engine "
            f"(affine, exact) in {dt:.4f} s")
    read_counts(12, ("scan_madd_sorted", "padd", "window_tail", "horner"),
                UNFUSED)
    alone = [db.host_seconds(lambda: expected_is(
        tpu_msm_torch.msm((px, py), sl, device=dev), expected[20], "msm"))
        for _ in range(3)]
    log(12, f"msm n=2^20 alone: {[round(t, 4) for t in alone]} s")


# tests/test_golden_vectors.py's configurations, in the JAX MsmConfig's
# defaults (unsigned digits, fanout 4096, "bincount") where not stated.
GOLDEN_JAX_DEFAULTS = dict(reduce_fanout=4096, signed_digits=False,
                           segment_starts="bincount")
GOLDEN_CONFIGS = {"random_n64_c16": dict(window_bits=16, scan_lanes=8),
                  "random_n1024": dict(window_bits=8, scan_lanes=64,
                                       signed_digits=True)}
GOLDEN_DEFAULT = dict(window_bits=8, scan_lanes=8)
# The scan lanes of those configurations: the per-window route's pmadd
# widths in phase 13, where the rule takes the group kernel.
GOLDEN_LANES = tuple(sorted({kw["scan_lanes"] for kw in (
    GOLDEN_DEFAULT, *GOLDEN_CONFIGS.values())}))


def phase_golden(dev, entries):
    """Every MSM case of tests/vectors/bn254_golden.json (a second,
    independent implementation's) through msm on the card, with the JAX
    package's golden-vector test's configuration, equal to its result;
    every kernel the cases launch held against its plain version at each
    shape it launches it at (RouteSpy, check_route), each pmadd shape one
    that phase 2 timed. Returns the launches."""
    from tpu_msm_torch import msm
    from tpu_msm_torch.utils.config import MsmConfig

    path = Path(__file__).resolve().parent / "tests" / "vectors" \
        / "bn254_golden.json"
    golden = json.loads(path.read_text())
    reset_counts()
    with RouteSpy() as spy:
        for case in golden["msm_cases"]:
            kw = dict(GOLDEN_JAX_DEFAULTS, **GOLDEN_CONFIGS.get(
                case["name"], GOLDEN_DEFAULT))
            cfg = MsmConfig(**kw)
            scalars = [int(s, 16) for s in case["scalars"]]
            points = [None if p is None else (int(p[0], 16), int(p[1], 16))
                      for p in case["points"]]
            want = (None if case["result"] is None else
                    tuple(int(v, 16) for v in case["result"]))
            expected_is(msm(points, scalars, cfg, device=dev), want,
                        f"golden {case['name']}")
            log(13, f"golden {case['name']} (n = {len(scalars)}, {kw}) == "
                f"the fixture's result")
    launches = read_counts(13, ("pmadd", "pmadd_group", "padd", "window_tail",
                                "horner"))
    shapes = check_route(13, entries, spy.calls)
    del spy
    timed = {rec["shape"] for name in PMADD.values()
             for rec in (entries[name], *entries[name]["other_shapes"])}
    for kernel in PMADD.values():
        own = launches[kernel] - launches.get(SHARED_COUNTS.get(kernel), 0)
        recs = shapes.get(kernel, [])
        if sum(r["launches"] for r in recs) != own:
            raise AssertionError(f"{kernel}: {recs} recorded by shape, {own} "
                                 f"launches counted")
        if any(r["shape"] not in timed for r in recs):
            raise AssertionError(f"{kernel}: golden shapes {recs}, phase 2 "
                                 f"timed {sorted(timed)}")
        entries[kernel]["golden_shapes"] = recs
    log(13, f"every kernel of the golden cases == its plain version at each "
        f"shape it launched it at (or an earlier phase's, where marked): "
        f"{shape_list(shapes)}")
    return launches


def phase_tensors(dev, inputs, expected):
    """(16, N) int32 limb tensors already on the card through msm and
    msm_best at 2^20, and with half the scalars zero (msm_best's filter
    runs on the card), each equal to the native engine."""
    import tpu_msm_torch
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.utils import interop

    px, py, sl = inputs[20]
    dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, dev)
    reset_counts()
    expected_is(tpu_msm_torch.msm((dpx, dpy), dsl, device=dev), expected[20],
                "msm on card tensors")
    expected_is(tpu_msm_torch.msm_best(dsl, (dpx, dpy), device=dev),
                expected[20], "msm_best on card tensors")
    half = sl.copy()
    half[:, ::2] = 0
    dhalf = interop.limbs_to_device(half, half, half, dev)[0]
    expected_is(tpu_msm_torch.msm_best(dhalf, (dpx, dpy), device=dev),
                native.msm(px, py, half), "msm_best on card tensors, half 0")
    read_counts(14, MAIN_KERNELS, UNFUSED)
    log(14, "msm and msm_best on (16, 2^20) int32 tensors on the card == "
        "native engine, with and without the zero filter")


# --------------------------------------------------------------------------
# The sharded and multi-process MSM, and the C ABI.
# --------------------------------------------------------------------------

SHARDS = (1, 2, 4)
# The multi-process runs' size: 2^20 points a rank over two ranks.
DIST_LOG = 21
# The sharded path's kernels whose every launch phase 15 records by shape.
TREE_KERNELS = ("padd", "padd_group", "horner")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world, backend, collective, log_size, repeats=1):
    """`world` processes of `python -m tpu_msm_torch.parallel.distributed`
    on cuda:0 over `backend`, started together; finish_ranks collects."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", "tpu_msm_torch.parallel.distributed",
         "--init-method", init, "--world-size", str(world), "--rank", str(r),
         "--backend", backend, "--device", "cuda:0", "--log-size",
         str(log_size), "--collective", collective, "--repeats",
         str(repeats)], cwd=Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish_ranks(procs, what, timeout=300):
    """Each rank's (digest, [ms a call]); raises unless every rank exited 0
    and the digests are equal."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    got = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        m = re.search(r"ms=\[([^\]]*)\] result_sha256=([0-9a-f]{64})", out)
        if p.returncode != 0 or not m:
            raise AssertionError(f"{what} rank {r}: rc {p.returncode}\n"
                                 f"{out[-3000:]}")
        got.append((m[2], [float(t) for t in m[1].split(",")]))
    if len({d for d, _ in got}) != 1:
        raise AssertionError(f"{what}: the ranks' digests differ: {got}")
    return got


def phase_sharded(dev, inputs, expected, entries):
    """The sharded MSM: (a) `msm_sharded` at 2^20 over D = 1, 2, 4 shards
    on cuda:0 in both collectives, each equal to the native engine, D = 1
    byte-identical to msm_device, each timed in turns with msm_device by
    CUDA events, the counters set to 0 before each run and read after it; (e)
    every scan_madd_sorted, padd, padd_group and horner launch of those
    runs recorded by shape and held against its plain version on that
    call's inputs (scan_madd_sorted on its first 8 steps, and in full
    against the unfused pair); (b)
    two processes of `tpu_msm_torch.parallel.distributed` over gloo, both
    on cuda:0, at 2^21 (2^20 points a rank), in both collectives, their
    digests equal to each other and to in-process msm_sharded over two
    shards, whose result equals the native engine's; (c) one process over
    NCCL at world size 1, its digest that of msm_device's bytes; (d) the
    CLI's `20 1 sharded 1`, which holds its result against the native
    engine."""
    import torch

    import tpu_msm_torch
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.parallel import distributed, sharded
    from tpu_msm_torch.utils import interop, preprocess

    px, py, sl = inputs[20]
    d = interop.limbs_to_device(px, py, sl, dev)
    cfg = tpu_msm_torch.select_config(1 << 20, dev)
    ref = tpu_msm_torch.msm_device(*d, cfg)
    spy = RouteSpy()
    spy.targets = [(m, k) for m, k in spy.targets
                   if k in ("scan_madd_sorted", "padd", "horner")]
    runs, per_run = {}, {}
    for shards in SHARDS:
        for coll in sharded.COLLECTIVES:
            runs[f"{coll} D={shards}"] = functools.partial(
                sharded.msm_sharded, d[:2], d[2], devices=[dev] * shards,
                collective=coll)
    with spy:  # the spy copies each call's inputs: no timing inside it
        for name, run in runs.items():
            reset_counts()
            res = run()
            expected_is(affine(res), expected[20], f"msm_sharded {name}")
            launches = read_counts(15, MAIN_KERNELS, UNFUSED)
            if name.endswith(" D=1") and not all(
                    torch.equal(a, b) for a, b in zip(res, ref)):
                raise AssertionError(f"msm_sharded {name}: bytes differ "
                                     f"from msm_device's")
            per_run[name] = {k: launches[k] - launches.get(
                SHARED_COUNTS.get(k), 0) for k in TREE_KERNELS}
            log(15, f"msm_sharded n=2^20 {name} == native engine"
                + (", bytes == msm_device's" if name.endswith(" D=1")
                   else "") + f"; launches {per_run[name]}")
    for name, run in runs.items():  # each in turns with msm_device
        device_ms = cuda_ms(lambda: tpu_msm_torch.msm_device(*d, cfg))
        ms = cuda_ms(run)
        log(15, f"time msm_sharded n=2^20 {name}: {ms:.4f} ms against "
            f"msm_device {device_ms:.4f} just before it "
            f"({ms / device_ms:.3f}x)")
    shapes = check_route(15, entries, spy.calls)
    for kernel in TREE_KERNELS:
        entries[kernel]["sharded_shapes"] = shapes.get(kernel, [])
        entries[kernel]["sharded_launches"] = {
            name: counts[kernel] for name, counts in per_run.items()}
    entries["scan_madd_sorted"]["sharded_shapes"] = shapes["scan_madd_sorted"]
    log(15, f"every scan_madd_sorted, padd and horner launch of the sharded "
        f"runs "
        f"== its plain version at each shape (or an earlier phase's, where "
        f"marked): {shape_list(shapes)}")

    # (b) two gloo ranks on one card, timed alone first.
    t0 = time.perf_counter()
    gloo = {"gather_tree": finish_ranks(start_ranks(
        2, "gloo", "gather_tree", DIST_LOG, repeats=3), "gloo gather_tree")}
    log(15, f"2 gloo ranks on cuda:0, 2^{DIST_LOG} (2^20 a rank), "
        f"gather_tree: digests equal; ms a call by rank "
        f"{[t for _, t in gloo['gather_tree']]} (the first call warms up); "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")
    # Then together: the other collective, NCCL at world size 1, the CLI.
    t0 = time.perf_counter()
    pending = start_ranks(2, "gloo", "ppermute_tree", DIST_LOG)
    nccl = start_ranks(1, "nccl", "gather_tree", 20, repeats=3)
    with tempfile.TemporaryDirectory() as cache:
        path = Path(cache) / "msm_vecs" / "msm_20x1.npz"
        path.parent.mkdir(parents=True)
        [inst] = preprocess.generate_msm_instances(20, 1)
        np.savez(path, px0=inst.px, py0=inst.py, s0=inst.scalars,
                 num=np.array([1]))
        cli = subprocess.Popen(
            [sys.executable, "-m", "tpu_msm_torch.cli.profiler", "20", "1",
             "sharded", "1"], cwd=Path(__file__).resolve().parent,
            env=dict(os.environ, TPU_MSM_CACHE_DIR=cache),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        wx, wy, ws = distributed.workload(DIST_LOG)
        want21 = native.msm(wx, wy, ws)
        dw = interop.limbs_to_device(wx, wy, ws, dev)
        for coll in sharded.COLLECTIVES:
            res = sharded.msm_sharded(dw[:2], dw[2], devices=[dev] * 2,
                                      collective=coll)
            expected_is(affine(res), want21, f"msm_sharded 2^{DIST_LOG} D=2")
            if coll not in gloo:
                gloo[coll] = finish_ranks(pending, f"gloo {coll}")
            if gloo[coll][0][0] != distributed.digest(*res):
                raise AssertionError(f"gloo {coll}: the ranks' digest "
                                     f"differs from msm_sharded D=2's")
            log(15, f"2 gloo ranks, {coll}: digest {gloo[coll][0][0][:16]}... "
                f"== in-process msm_sharded D=2's; its result == native "
                f"engine at 2^{DIST_LOG}")
        [(nccl_digest, nccl_ms)] = finish_ranks(nccl, "nccl")
        nx, ny, ns = distributed.workload(20)
        single = tpu_msm_torch.msm_device(
            *interop.limbs_to_device(nx, ny, ns, dev), cfg)
        if nccl_digest != distributed.digest(*single):
            raise AssertionError("nccl world size 1: digest differs from "
                                 "msm_device's bytes")
        log(15, f"1 NCCL rank at 2^20: digest == msm_device's bytes; "
            f"{nccl_ms} ms a call (the first warms up)")
        out = cli.communicate(timeout=600)[0]
    lines = [ln.split(" INFO ")[-1] for ln in out.splitlines()
             if "==" in ln or "Execution" in ln]
    if cli.returncode != 0 or "instance 0: sharded == cpu" not in out:
        raise AssertionError(f"profiler 20 1 sharded 1: rc {cli.returncode}"
                             f"\n{out[-3000:]}")
    for line in lines:
        log(15, f"20 1 sharded 1: {line}")
    log(15, f"the other collective, NCCL and the CLI together in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"gloo_ms": gloo["gather_tree"]}


def phase_embed(dev, inputs, expected):
    """The C ABI: builds libtpu_msm_torch_embed.so and its smoke host
    program, feeds the program the 2^20 inputs as wire bytes (a file),
    requires the 64 bytes it returns to be the native engine's result, and
    times
    tpu_msm_best through the C ABI (three calls after the first, in the
    program) beside msm_best_wire on the same bytes (and its wire
    conversion, from_h2c_bytes, alone) and msm_best on the limb arrays,
    in Python."""
    from tpu_msm_torch import _build, msm_best
    from tpu_msm_torch.benches import dispatch_benchmark as db
    from tpu_msm_torch.bindings import embed
    from tpu_msm_torch.utils import interop

    res = _build.build_embed()
    log(16, f"C ABI build: {'compiled' if res['built'] else 'up to date'} "
        f"in {res['seconds']:.1f} s -> {res['lib']}, {res['host']}")
    px, py, sl = inputs[20]
    n = px.shape[1]
    wire = (interop.to_h2c_bytes(sl).tobytes(), np.stack(
        [interop.to_h2c_bytes(px), interop.to_h2c_bytes(py)], axis=1)
        .tobytes())  # scalars, then each point's x then y
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "wire.bin"
        path.write_bytes(wire[0] + wire[1])
        t0 = time.perf_counter()
        proc = subprocess.run([res["host"], str(n), str(path), "3"],
                              capture_output=True, text=True, timeout=600,
                              env=_build.embed_env())
        dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"test_embed: rc {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    out = bytes.fromhex(proc.stdout.strip())
    got = (int.from_bytes(out[:32], "little"),
           int.from_bytes(out[32:], "little"))
    expected_is(got, expected[20], "tpu_msm_best through the C ABI")
    c_ms = [float(t) for t in re.search(r"tpu_msm_best ms:([ 0-9.]*)",
                                        proc.stderr)[1].split()]
    def convert():
        pxy = np.frombuffer(wire[1], np.uint8).reshape(n, 2, 32)
        return [interop.from_h2c_bytes(a) for a in (
            np.frombuffer(wire[0], np.uint8).reshape(n, 32), pxy[:, 0],
            pxy[:, 1])]

    convert_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        convert()
        convert_ms.append((time.perf_counter() - t0) * 1e3)
    wire_ms = [db.host_seconds(lambda: expected_is(
        embed.msm_best_wire(*wire, device=dev), out, "msm_best_wire")) * 1e3
        for _ in range(3)]
    py_ms = [db.host_seconds(lambda: expected_is(
        msm_best(sl, (px, py), device=dev), expected[20], "msm_best")) * 1e3
        for _ in range(3)]
    log(16, f"tpu_msm_best n=2^20 through the C ABI == native engine; "
        f"{c_ms} ms a call (the host program's clock); in Python "
        f"msm_best_wire on the same bytes {[round(t, 3) for t in wire_ms]} "
        f"ms, from_h2c_bytes of its three arrays alone "
        f"{[round(t, 3) for t in convert_ms]} ms, msm_best on the limb "
        f"arrays {[round(t, 3) for t in py_ms]} ms; the host program's "
        f"process {dt:.1f} s")
    return {"c_ms": c_ms, "wire_ms": wire_ms, "convert_ms": convert_ms,
            "py_ms": py_ms}


# --------------------------------------------------------------------------
# The exported MSM (bindings/export.py).
# --------------------------------------------------------------------------

# The per-window route's configuration for phase 17: 512 scan lanes (not a
# fused width), c = 16 signed, fanout 64 (a short rolled tree, a small
# graph), so that pmadd, padd_group and fold_add_group run from an
# artifact.
EXPORT_WINDOW_LANES = 512
EXPORT_WINDOW_FANOUT = 64
# Turns of the loaded program and eager msm_device at 2^20, each timed.
EXPORT_TURNS = 5


def _loaded_and_eager(phase, what, fn, args, cfg, kernels, absent=()):
    """One call of the loaded program `fn` and one of eager msm_device on
    `args`, each with the counters set to 0 just before it and read just
    after; raises unless their (x, y, z) are bit-identical, every kernel's
    launches equal and none of `absent` launched. Returns (affine point,
    the loaded call's launches)."""
    import torch

    import tpu_msm_torch

    reset_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    loaded = read_counts(phase, kernels, absent)
    reset_counts()
    want = tuple(tpu_msm_torch.msm_device(*args, cfg))
    torch.cuda.synchronize()
    eager = read_counts(phase, kernels, absent)
    if not (isinstance(got, tuple) and len(got) == 3
            and all(torch.equal(g, w) for g, w in zip(got, want))):
        raise AssertionError(f"{what}: the loaded program's (x, y, z) is not "
                             f"eager msm_device's")
    if loaded != eager:
        raise AssertionError(f"{what}: launches of the loaded program "
                             f"{loaded} != eager {eager}")
    log(phase, f"{what}: loaded program == eager msm_device (x, y, z bit for "
        f"bit), launches equal: {json.dumps(loaded)}")
    return affine(got), loaded


# What the fresh process of phase 17 runs, from the repository root: argv =
# a JSON object of artifact paths, and the inputs' file. It imports only
# bindings.export before it loads (chip_smoke, for its counters, after),
# runs each artifact once with the counters set to 0, and prints one JSON
# line: the load's seconds (torch's import included) and, per artifact, its
# run's seconds, (x, y, z) limbs, launches and plain calls.
FRESH_LOAD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
from tpu_msm_torch.bindings.export import load_msm
fns = {k: load_msm(v) for k, v in json.loads(sys.argv[1]).items()}
res = {"load_s": time.perf_counter() - t0}
assert "jax" not in sys.modules and "tpu_msm" not in sys.modules
import chip_smoke
args = [a.cuda() for a in torch.load(sys.argv[2])]
for k, fn in fns.items():
    chip_smoke.reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    kernels, plains = chip_smoke.counters()
    res[k] = {"run_s": time.perf_counter() - t0,
              "xyz": [a.cpu().numpy().view("uint32").tolist() for a in out],
              "launches": {n: getattr(f, a) for n, (f, a) in kernels.items()},
              "plain_calls": sum(f.calls for f in plains)}
print(json.dumps(res))
"""


def phase_export(dev, inputs, expected, entries):
    """bindings.export on the card. At 2^12 two artifacts, the default
    row's (fused) and the per-window route's (EXPORT_WINDOW_LANES lanes),
    loaded and run in a fresh process (FRESH_LOAD) on inputs saved beside
    them: each affine result the native engine's, and the per-window one
    bit for bit eager msm_device's with the same launches. While that
    process runs, at 2^20 with the tuned row on bench inputs: export_msm on
    cuda:0, saved to a temporary directory, loaded in this process and held
    against eager msm_device (bit for bit, and the launches of one call of
    each) and the native engine (affine), and each scan_madd_sorted launch
    of the loaded program held on its own inputs as check_route holds it
    (`op_calls`); after the fresh process ends, the two timed in turns by
    CUDA events, EXPORT_TURNS calls each. Returns the launches of one call
    of the loaded 2^20 program."""
    import torch

    import tpu_msm_torch
    from tpu_msm_torch.bindings import export
    from tpu_msm_torch.utils import interop
    from tpu_msm_torch.utils.config import MsmConfig

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- 2^12: the default row's artifact and the per-window route's,
        # run in a fresh process ----
        px, py, sl = inputs[12]
        wcfg = MsmConfig(scan_lanes=EXPORT_WINDOW_LANES,
                         reduce_fanout=EXPORT_WINDOW_FANOUT)
        paths = {"default": tmp / "msm_12.pt2",
                 "per_window": tmp / "msm_12_window.pt2"}
        t0 = time.perf_counter()
        export.export_msm(1 << 12, path=paths["default"], device=dev)
        export.export_msm(1 << 12, wcfg, path=paths["per_window"],
                          device=dev)
        log(17, f"export_msm n=2^12, the default row and the per-window "
            f"route ({wcfg}): {time.perf_counter() - t0:.2f} s")
        torch.save(tuple(torch.from_numpy(a.view(np.int32)).clone()
                         for a in (px, py, sl)), tmp / "inputs_12.pt")
        t_fresh = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", FRESH_LOAD,
             json.dumps({k: str(v) for k, v in paths.items()}),
             str(tmp / "inputs_12.pt")],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            # ---- 2^20, the tuned row ----
            cfg = tpu_msm_torch.select_config(1 << 20, dev)
            args = interop.limbs_to_device(*inputs[20], dev)
            t0 = time.perf_counter()
            data = export.export_msm(1 << 20, cfg, path=tmp / "msm_20.pt2",
                                     device=dev)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn = export.load_msm(tmp / "msm_20.pt2")
            load_s = time.perf_counter() - t0
            ops = [str(node.target) for node in fn.graph.nodes
                   if node.op == "call_function"]
            log(17, f"export_msm n=2^20 ({cfg}) on {dev}: {export_s:.2f} s, "
                f"{len(data)} bytes; load_msm {load_s:.2f} s; the graph "
                f"calls {len(ops)} functions, "
                f"{sum(op.startswith('tpu_msm_torch.') for op in ops)} of "
                f"them the port's operators")
            fn(*args)  # warm
            pt, launches = _loaded_and_eager(17, "n=2^20", fn, args, cfg,
                                             MAIN_KERNELS, UNFUSED)
            expected_is(pt, expected[20], "the loaded program at 2^20")
            _, calls = op_calls(lambda: fn(*args), "scan_madd_sorted")
            shapes = check_route(17, entries, calls)
            entries["scan_madd_sorted"]["export_shapes"] = shapes[
                "scan_madd_sorted"]
            log(17, f"every scan_madd_sorted launch of the loaded program == "
                f"the unfused pair and, on its first 8 steps, its plain "
                f"version, on its own inputs: {shape_list(shapes)}")
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"loading in a fresh process: rc "
                                 f"{proc.returncode}\n{err[-4000:]}")
        res = json.loads(out.splitlines()[-1])
        log(17, f"n=2^12 artifacts in a fresh process (imports "
            f"bindings.export only before it loads, no jax): both loaded in "
            f"{res['load_s']:.2f} s (torch's import included), first runs "
            f"{res['default']['run_s']:.3f} s (default row) and "
            f"{res['per_window']['run_s']:.3f} s (per-window); the process "
            f"{time.perf_counter() - t_fresh:.1f} s, beside the 2^20 export")

        # The loaded 2^20 program and eager msm_device in turns, with the
        # host's share of one call of each (until it returns).
        times = {"loaded": [], "eager": []}
        runs = {"loaded": lambda: fn(*args),
                "eager": lambda: tpu_msm_torch.msm_device(*args, cfg)}
        for i in range(EXPORT_TURNS):
            for which in (("loaded", "eager") if i % 2 == 0
                          else ("eager", "loaded")):
                times[which].append(_events_ms(runs[which], 1))
        med = {k: statistics.median(v) for k, v in times.items()}
        host = {}
        for which, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            host[which] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        log(17, f"n=2^20 in turns by CUDA events: loaded program median "
            f"{med['loaded']:.3f} ms of {[round(t, 3) for t in times['loaded']]}"
            f", eager msm_device median {med['eager']:.3f} ms of "
            f"{[round(t, 3) for t in times['eager']]}; loaded / eager "
            f"{med['loaded'] / med['eager']:.4f}; the host's share of a call "
            f"(until it returns, before the card ends): loaded "
            f"{host['loaded']:.3f} ms, eager {host['eager']:.3f} ms")
        del fn, args

        fresh = {k: tuple(np.asarray(a, dtype=np.uint32)
                          for a in res[k]["xyz"]) for k in paths}
        for k in paths:
            if res[k]["plain_calls"]:
                raise AssertionError(f"the {k} artifact ran a plain version "
                                     f"on the card")
            [pt] = interop.proj_limbs_to_affine_points(*fresh[k])
            expected_is(pt, expected[12], f"the {k} artifact at 2^12 in a "
                        f"fresh process")
        # The per-window program against eager msm_device in this process:
        # bit for bit, and the same launches of every kernel.
        args = interop.limbs_to_device(px, py, sl, dev)
        reset_counts()
        want = tuple(tpu_msm_torch.msm_device(*args, wcfg))
        torch.cuda.synchronize()
        eager = read_counts(17, ("pmadd", "pmadd_group", "padd", "padd_group",
                                 "fold_add", "fold_add_group", "digit_hist",
                                 "window_tail", "horner"))
        if not all(np.array_equal(g, interop.tensor_to_limbs(w))
                   for g, w in zip(fresh["per_window"], want)):
            raise AssertionError("the per-window artifact's (x, y, z) is not "
                                 "eager msm_device's")
        if res["per_window"]["launches"] != eager or eager["scan_madd"]:
            raise AssertionError(f"per-window launches: artifact "
                                 f"{res['per_window']['launches']}, eager "
                                 f"{eager}")
        log(17, f"per-window artifact at 2^12 == eager msm_device (x, y, z "
            f"bit for bit), launches equal: {json.dumps(eager)}")
    return launches



def _bench_lines(phase, fn, *args, **kw):
    """fn(*args, **kw) with the JSON lines it prints logged as lines of
    `phase`, so that the script's own JSON lines stay the only ones on
    stdout. Returns fn's result."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw)
    finally:
        for line in buf.getvalue().splitlines():
            log(phase, line)


def expect_equal(what, got, want):
    """numpy arrays equal in dtype, shape and every element, else raise."""
    if got.dtype != want.dtype or got.shape != want.shape \
            or not np.array_equal(got, want):
        raise AssertionError(f"{what}: {got.dtype} {got.shape} differs from "
                             f"{want.dtype} {want.shape}")


BENCH_LOG = 20
MSM_BENCH_INSTANCES = 2


def phase_benches(dev):
    """The port's micro-benches in this process
    (tpu_msm_torch/benches/{conversion,sort,msm}_benchmark.py), each output
    checked here:

    * conversion at 2^20: every converter's output against a formulation
      written here on the same bytes (np.frombuffer views), the two round
      trips, and the C ABI path's three from_h2c_bytes (the scalars and the
      points' strided x and y halves);
    * sort (a) at 2^16-2^22: the sorted keys equal np.sort of the keys,
      the payload the one gathered by np.argsort(keys, kind="stable");
    * msm at 2^20 over 2 instances (the fixture written uncompressed into
      a temporary TPU_MSM_CACHE_DIR, as phase 5 writes its 2^22 one): the
      bench holds instance 0's result against the native engine's CPU row
      and raises on a mismatch; the launches of its calls read, every
      kernel of the main path among them;
    * sort (b) at the tuned 2^20 row, last, since it ends with a profile of
      msm_device: its `_sorted_scan_inputs` output bit for bit the sorted
      digits and the scan_layout of the permutation that msm_device's own
      first scan_madd_sorted launch takes on the same inputs; its split
      into the sort, the scan_layout launch and the rest; no scan_layout
      launch in msm_device's profile.

    Returns the launches of sort (b), the path that launches scan_layout."""
    from tpu_msm_torch.benches import conversion_benchmark as conv
    from tpu_msm_torch.benches import msm_benchmark as msmb
    from tpu_msm_torch.benches import sort_benchmark as sortb
    from tpu_msm_torch.utils import interop, preprocess

    n = 1 << BENCH_LOG
    _, out = _bench_lines(18, conv.run, BENCH_LOG, iters=2, device=dev)
    raw, limbs, points = out["raw"], out["limbs"], out["points"]
    u16 = np.frombuffer(raw, np.uint8).view("<u2").reshape(n, 16)
    want_limbs = np.ascontiguousarray(u16.T).astype(np.uint32)
    expect_equal("the bench's limbs", limbs, want_limbs)
    expect_equal("from_h2c_bytes", out["from_h2c_bytes"], want_limbs)
    expect_equal("to_h2c_bytes", out["to_h2c_bytes"],
                 np.frombuffer(raw, np.uint8).reshape(n, 32))
    # arkworks: eight u32 words a scalar, the most significant first.
    ark = np.frombuffer(raw, np.uint8).view("<u4").reshape(n, 8)[:, ::-1]
    expect_equal("to_ark_u32_limbs", out["to_ark_u32_limbs"],
                 np.ascontiguousarray(ark))
    expect_equal("from_ark_u32_limbs", out["from_ark_u32_limbs"], limbs)
    expect_equal("from_h2c_bytes(to_h2c_bytes(x))",
                 interop.from_h2c_bytes(interop.to_h2c_bytes(limbs)), limbs)
    expect_equal("from_ark_u32_limbs(to_ark_u32_limbs(x))",
                 interop.from_ark_u32_limbs(interop.to_ark_u32_limbs(limbs)),
                 limbs)
    pxy = np.frombuffer(points, np.uint8).view("<u2").reshape(n, 2, 16)
    wire = {"scalars": want_limbs,
            "points x": np.ascontiguousarray(pxy[:, 0].T).astype(np.uint32),
            "points y": np.ascontiguousarray(pxy[:, 1].T).astype(np.uint32)}
    for name, want in wire.items():
        expect_equal(f"from_h2c_bytes {name}", out[f"from_h2c_bytes {name}"],
                     want)
    for got, want in zip(out["msm_best_wire's three from_h2c_bytes"],
                         wire.values()):
        expect_equal("msm_best_wire's three from_h2c_bytes", got, want)
    del out, raw, limbs, points, u16, pxy, wire
    log(18, f"conversion at 2^{BENCH_LOG}: every converter == its "
        "formulation here, both round trips exact, the C ABI path's three "
        "arrays too")

    sorted_out = {}
    _bench_lines(18, sortb.payload_sort, sortb.LOG_SIZES, repeats=3,
                 device=dev, outputs=sorted_out)
    for log_n, ((keys, payload), (got_keys, got_payload)) in \
            sorted_out.items():
        expect_equal(f"sort 2^{log_n} keys", got_keys, np.sort(keys))
        expect_equal(f"sort 2^{log_n} payload", got_payload,
                     payload[:, np.argsort(keys, kind="stable")])
    log(18, f"sort (a) at 2^{min(sorted_out)}-2^{max(sorted_out)}: keys == "
        "np.sort, payload == the stable np.argsort's gather")
    del sorted_out

    with tempfile.TemporaryDirectory() as cache:
        path = Path(cache) / "msm_vecs" / (
            f"msm_{BENCH_LOG}x{MSM_BENCH_INSTANCES}.npz")
        path.parent.mkdir(parents=True)
        insts = preprocess.generate_msm_instances(BENCH_LOG,
                                                  MSM_BENCH_INSTANCES)
        np.savez(path, num=np.array([len(insts)]), **{
            f"{k}{i}": a for i, inst in enumerate(insts)
            for k, a in (("px", inst.px), ("py", inst.py),
                         ("s", inst.scalars))})
        del insts
        saved = os.environ.get("TPU_MSM_CACHE_DIR")
        os.environ["TPU_MSM_CACHE_DIR"] = cache
        try:
            reset_counts()
            rows = _bench_lines(18, msmb.run, BENCH_LOG, MSM_BENCH_INSTANCES,
                                device=dev)
            read_counts(18, MAIN_KERNELS, UNFUSED)
        finally:
            if saved is None:
                del os.environ["TPU_MSM_CACHE_DIR"]
            else:
                os.environ["TPU_MSM_CACHE_DIR"] = saved
    device_row, cpu_row = rows
    if not device_row["equals_native"] or cpu_row["row"] != "cpu":
        raise AssertionError(f"msm bench rows: {rows}")
    log(18, f"msm bench at 2^{BENCH_LOG}, {MSM_BENCH_INSTANCES} instances: "
        f"instance 0 == native engine; median {device_row['median_ms']:.3f} "
        f"ms on the host clock, {device_row['median_event_ms']:.3f} ms by "
        f"CUDA events; native engine {cpu_row['ms']:.1f} ms")

    return sort_b_check(dev)


def sort_b_check(dev):
    """Phase 18's sort (b) (phase_benches); returns its launches."""
    import torch

    import tpu_msm_torch
    from tpu_msm_torch.benches import sort_benchmark as sortb
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import pippenger

    sort_b = {}
    reset_counts()
    rec = _bench_lines(18, sortb.main_path_sort, BENCH_LOG, repeats=3,
                       device=dev, outputs=sort_b)
    launches = read_counts(18, ("scan_layout",))
    # msm_device's own first group: the arguments its sorted scan took.
    made = []
    real = pippenger.scan_madd_sorted

    def spy(*args):
        made.append(tuple(a.clone() if hasattr(a, "clone") else a
                          for a in args))
        return real(*args)

    pippenger.scan_madd_sorted = spy
    try:
        tpu_msm_torch.msm_device(*sort_b["inputs"], sort_b["cfg"])
    finally:
        pippenger.scan_madd_sorted = real
    got = sort_b["result"]
    perm, rows, negm, lanes = made[0]
    want = (torch.sort(sort_b["args"][0], dim=1, stable=True)[0],
            *cc.scan_layout(perm, rows, negm, lanes))
    if any(a.shape != b.shape or not bool((a == b).all())
           for a, b in zip(got, want)):
        raise AssertionError("sort (b): the bench's _sorted_scan_inputs "
                             "differs from the layout of msm_device's first "
                             "group's permutation")
    if rec["msm_device_layout_launches"]:
        raise AssertionError(f"sort (b): msm_device launched scan_layout "
                             f"{rec['msm_device_layout_launches']} times")
    inside = rec["in_msm_device"]
    log(18, f"sort (b) at 2^{BENCH_LOG} ({rec['windows']} windows, "
        f"{rec['lanes']} lanes) == the layout of msm_device's own first "
        f"group's permutation, bit for bit; {rec['ms']:.4f} ms, profiled: "
        f"sort {rec['sort_ms']:.4f}, scan_layout {rec['layout_ms']:.4f}, "
        f"other {rec['other_ms']:.4f} ms in {rec['device_events']} device "
        f"events; msm_device launches no scan_layout (its scan reads the "
        f"sorted rows itself); in msm_device sort {inside['sort_ms']:.4f}, "
        f"other {inside['other_ms']:.4f} ms; the call's torch kernels "
        f"{rec['share_of_torch']:.3f} of torch's own kernels' "
        f"{rec['msm_device_torch_ms']:.3f} ms there; scan_layout launches "
        f"of the bench {launches['scan_layout']}")
    return launches


EC = "tpu_msm_torch/csrc/ec_kernels.cu"
PC = "tpu_msm/ops/pallas_curve.py"
# name: (source, the TPU kernels it replaces, the path its launches count)
SOURCES = {
    "scan_madd": (EC, f"{PC}:799", "cli"),
    "padd": (EC, f"{PC}:1009", "main"),
    "padd_group": (EC, f"{PC}:1009", "per_window"),
    "window_tail": (EC, f"{PC}:1009", "main"),
    "horner": (EC, f"{PC}:1009", "main"),
    "fold_add": (EC, f"{PC}:953", "main"),
    "fold_add_group": (EC, f"{PC}:953", "per_window"),
    "digit_hist": ("tpu_msm_torch/csrc/hist.cu",
                   "tpu_msm/ops/hist.py:171, tpu_msm/ops/hist.py:107", "main"),
    "pmadd": (EC, f"{PC}:988", "per_window"),
    "pmadd_group": (EC, f"{PC}:988", "golden"),
    "jac_madd": (EC, f"{PC}:367", "cli"),
    "jac_add": (EC, f"{PC}:385", "cli"),
    "scan_madd_rows": (EC, f"{PC}:565", "cli"),
    "montmul_chain": ("tpu_msm_torch/csrc/montmul.cu",
                      "benches/montmul_benchmark.py:100", "roofline"),
    # No pallas_call: the JAX package's sort stage, left to XLA ("rank").
    "scan_layout": ("tpu_msm_torch/csrc/layout.cu",
                    "tpu_msm/ops/pippenger.py:289", "sort_bench"),
    # The scan with that stage's layout read, not written, before it.
    "scan_madd_sorted": (EC, f"{PC}:799, tpu_msm/ops/pippenger.py:289",
                         "main"),
}
PATHS = {"main": "msm_best at 2^12 and 2^20",
         "per_window": "msm at 2^20, 16384 scan lanes, both segment starts",
         "cli": "tpu_msm_torch.cli.profiler --check-kernels",
         "golden": "msm on the card of every golden MSM case (n 16 to "
                   "1024, 8 or 64 scan lanes)",
         "roofline": "tpu_msm_torch.benches.montmul_benchmark at ilp 1 and "
                     "4, then utils.profiling.roofline(20)",
         "sort_bench": "tpu_msm_torch.benches.sort_benchmark part (b), "
                       "pippenger._sorted_scan_inputs at the tuned 2^20 "
                       "row"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(0, f"card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    import tpu_msm_torch  # noqa: F401  (fails outside the repository)

    from tpu_msm_torch.bindings import native

    t0 = time.perf_counter()

    phase_seconds = {}
    last = [t0]

    def lap(phase):
        now = time.perf_counter()
        phase_seconds[str(phase)] = round(now - last[0], 1)
        last[0] = now
        log(phase, f"phase done {now - t0:.1f} s into the run")

    phase_build()
    lap(1)
    inputs = {log_n: bench_inputs(1 << log_n) for log_n in (12, 20)}
    entries = phase_kernels(dev, inputs[20][2])
    entries.update(phase_new_kernels(dev))
    phase_window_kernels(dev, entries)
    phase_layout(dev, entries, inputs)
    lap(2)
    expected = {}
    for log_n, (px, py, sl) in inputs.items():
        t1 = time.perf_counter()
        expected[log_n] = native.msm(px, py, sl)
        log(3, f"native engine n=2^{log_n}: {time.perf_counter() - t1:.3f} s")
    launches = {}
    launches["main"], fused_ms = phase_e2e(dev, inputs, expected)
    lap(3)
    launches["per_window"] = phase_window(dev, inputs, expected, fused_ms)
    lap(4)
    launches["cli"] = phase_cli()
    lap(5)
    phase_montmul(dev, entries)
    phase_bound_model(dev)
    launches["roofline"] = phase_roofline(dev)
    lap(7)
    more = {log_n: bench_inputs(1 << log_n) for log_n in (16, 18)}
    for log_n, (px, py, sl) in more.items():
        expected[log_n] = native.msm(px, py, sl)
    more[20] = inputs[20]
    phase_glv(dev, more, expected)
    lap(8)
    phase_tuning(dev, more, expected)
    lap(9)
    phase_options(dev, more, expected)
    lap(10)
    stream_launches = phase_stream(dev, entries)
    lap(11)
    phase_hybrid(dev, inputs, expected)
    lap(12)
    launches["golden"] = phase_golden(dev, entries)
    lap(13)
    phase_tensors(dev, inputs, expected)
    lap(14)
    phase_sharded(dev, inputs, expected, entries)
    lap(15)
    phase_embed(dev, inputs, expected)
    lap(16)
    export_launches = phase_export(dev, inputs, expected, entries)
    lap(17)
    launches["sort_bench"] = phase_benches(dev)
    lap(18)
    phase_profile(dev, more)
    phase_scan_rows_phases(dev, entries)
    lap(6)

    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches[path][name] - (
                    launches[path][SHARED_COUNTS[name]]
                    if name in SHARED_COUNTS else 0),
                "path": PATHS[path],
                "stream_launches": stream_launches[name] - (
                    stream_launches[SHARED_COUNTS[name]]
                    if name in SHARED_COUNTS else 0),
                "export_launches": export_launches[name] - (
                    export_launches[SHARED_COUNTS[name]]
                    if name in SHARED_COUNTS else 0), **entries[name]}
               for name, (source, replaces, path) in SOURCES.items()]
    print(json.dumps({"kernels": kernels, "phase_seconds": phase_seconds}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
