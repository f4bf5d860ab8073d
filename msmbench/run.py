"""One run of one cell of the benchmark of `tpu_msm_torch`:

    python -m msmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs on the card from the seed (`traffic.py`),
places each where the mix says (card tensors, or numpy arrays in host
memory that every call copies over) and makes two warm calls of its own
shape. Untraced, the window is a closed loop of `msm_best` calls, one
caller, each call ending with its affine point on the host, for
`--seconds`; traced, a stretch of the configuration's `trace_calls` calls
runs under torch.profiler, then `entry_pairs` pairs of `msm_best` and of
the call it makes into the layer below on the same inputs, each timed with
`synchronize` (the layer below takes card tensors: a host input is copied
to the card before its timer starts). Then, with the program's state
freed, the plain reference (`reference.py`) judges every answer the run
produced, and each metric's reader (`msmbench/metrics/<name>.py`) makes
its number. The last line on standard output is one JSON object; the
numbers compared, each beside its limit, close it under "checks" and close
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, or with the JAX package or JAX loaded, the run exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_msm")
WARM_CALLS = 2
TABLE_SAMPLES = 16


def process_age_s() -> float:
    """Seconds since this process started, from /proc (clock ticks)."""
    with open("/proc/self/stat") as f:
        after_name = f.read().rsplit(")", 1)[1].split()
    started = int(after_name[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - started


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN, whole:
    `tpu_msm_torch` is not `tpu_msm`."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def set_cache_dirs(root) -> None:
    """Fixed cache directories inside the checkout, for anything of the
    program or of PyTorch that compiles (the port's own nvcc build lies in
    `build/tpu_msm_torch/`)."""
    base = os.path.join(root, "build", "msmbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


@dataclass
class Record:
    """What a run saw, for the metrics' readers."""

    cell: object
    n: int
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    call_s: List[float] = field(default_factory=list)
    completed: int = 0
    peak_bytes: Optional[int] = None
    trace: object = None
    trace_sets: List[int] = field(default_factory=list)
    entry_s: List[float] = field(default_factory=list)
    below_s: List[float] = field(default_factory=list)
    entry_sets: List[int] = field(default_factory=list)
    digits: Dict[int, int] = field(default_factory=dict)

    @property
    def window_bits(self) -> int:
        return int(self.cell.config["window_bits"])

    @property
    def scalar_bits(self) -> int:
        return int(self.cell.config["scalar_bits"])

    def mean_over(self, sets, least: Callable[[int], float]) -> Optional[float]:
        """The mean of least(nonzero digits of set k) over the calls' sets."""
        if not sets or any(k not in self.digits for k in sets):
            return None
        return sum(least(self.digits[k]) for k in sets) / len(sets)


def layer_below(program, n: int, device):
    """The call `msm_best` makes into the layer below on card tensors of n
    points, as `tpu_msm_torch.msm` makes it: the streamed pipeline above
    STREAM_THRESHOLD, else `msm_device` with `select_config(n)`."""
    if n > program.STREAM_THRESHOLD:
        from tpu_msm_torch.ops import streaming

        chunk_log = program.STREAM_THRESHOLD.bit_length() - 1
        return lambda px, py, s: streaming.msm_streamed(
            px, py, s, None, chunk_log=chunk_log, device=device)
    cfg = program.select_config(n, device)
    return lambda px, py, s: program.msm_device(px, py, s, cfg)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _answer(entry, k):
    try:
        return entry(k)
    except Exception as e:  # a call that raises is a failed call
        return e


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, entry_fault=None, below_fault=None):
    """Runs one cell once; returns the result as a dict. `t_start`: the
    process's start on time.perf_counter's clock. For the control and the
    tests: `entry_fault(entry, sets, (px, py), work)` returns what the run
    times in place of `entry` (a function of the scalar set's number), and
    `below_fault(below)` in place of the layer below."""
    import torch

    import tpu_msm_torch as program
    from msmbench import reference, roofline
    from msmbench.trace import CALL_SPAN, Trace, export_events
    from msmbench.traffic import Workload, to_card

    stamps = [("imports", time.perf_counter())]
    device = torch.device(device)
    cuda = device.type == "cuda"
    work = Workload(cell.mix, cell.n, seed, device)
    px, py = work.placed_bases()
    sets = [work.placed_scalars(k) for k in range(cell.mix.scalar_sets)]
    n_sets = len(sets)
    _sync(device)
    stamps.append(("inputs", time.perf_counter()))

    def entry(k):
        return program.msm_best(sets[k], (px, py), device=device)

    if entry_fault is not None:
        entry = entry_fault(entry, sets, (px, py), work)
    answers = []  # (scalar set, the call's answer or its exception)
    for k in range(WARM_CALLS):
        answers.append((k % n_sets, _answer(entry, k % n_sets)))
    _sync(device)
    stamps.append(("warm calls", time.perf_counter()))
    rec = Record(cell=cell, n=cell.n)
    rec.setup_s = stamps[-1][1] - t_start
    setup_parts = ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev in zip(
        stamps, [t_start] + [t for _, t in stamps]))
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    if not trace:
        t0 = time.perf_counter()
        k, t1 = 0, t0
        while t1 - t0 < seconds:
            s = time.perf_counter()
            a = _answer(entry, k % n_sets)
            t1 = time.perf_counter()
            answers.append((k % n_sets, a))
            rec.call_s.append(t1 - s)
            rec.completed += not isinstance(a, Exception)
            k += 1
        rec.window_s = t1 - t0
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        calls = int(cell.config["trace_calls"])
        with profile(activities=acts) as prof:
            for j in range(calls):
                with record_function(CALL_SPAN):
                    a = _answer(entry, j % n_sets)
                answers.append((j % n_sets, a))
                rec.trace_sets.append(j % n_sets)
        rec.trace = Trace(export_events(prof))
        below = layer_below(program, cell.n, device)
        if below_fault is not None:
            below = below_fault(below)

        def on_card(k):
            return [to_card(a, device) for a in (px, py, sets[k])]

        below(*on_card(0))  # its own warm call
        _sync(device)
        for j in range(int(cell.config["entry_pairs"])):
            k = j % n_sets
            for side in ((0, 1) if j % 2 == 0 else (1, 0)):
                args = on_card(k) if side == 1 else None
                _sync(device)
                t = time.perf_counter()
                if side == 0:
                    answers.append((k, _answer(entry, k)))
                else:
                    below(*args)
                _sync(device)
                (rec.entry_s if side == 0 else rec.below_s).append(
                    time.perf_counter() - t)
                del args  # no card copy of a host input outlives its call
            rec.entry_sets.append(k)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec.peak_bytes = window_peak

    # The table as the program leaves it: sampled rows, read on the host
    # (card tensors' columns copied over, host arrays' read where they lie).
    m = min(cell.n, cell.mix.distinct_bases)
    g = torch.Generator().manual_seed(seed & ((1 << 63) - 1))
    rows = torch.cat([torch.tensor([0, cell.n - 1]),
                      torch.randint(0, cell.n, (TABLE_SAMPLES,), generator=g)])
    table = [(j, px[:, j].tolist(), py[:, j].tolist()) for j in rows.tolist()]
    del px, py, sets, entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The reference, with the program's state freed.
    index = work.index()
    table_wrong = 0
    for j, xs, ys in table:
        want = reference.ec_mul(reference.G, 1 + int(index[j]) * work.step_log)
        got = (reference.from_mont_limbs(xs), reference.from_mont_limbs(ys))
        table_wrong += got != want or int(index[j]) >= m
    expected = {}
    for k in sorted({k for k, _ in answers}):
        s = work.scalars(k)
        expected[k] = reference.expected(*reference.limb_sums(s, index),
                                         work.step_log)
        rec.digits[k] = roofline.nonzero_digits(s, rec.window_bits,
                                                rec.scalar_bits)
        del s
    del index
    wrong = sum(1 for k, a in answers
                if isinstance(a, Exception) or a != expected[k])

    metrics = {}
    for metric in cell.wanted(trace):
        value = bench.reader(metric.name)(rec)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": wrong == 0 and table_wrong == 0,
           "attempted": len(answers), "failed": wrong,
           "metrics": metrics, "device": dev}
    if trace and rec.trace.calls:
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["card"] = card_line() if cuda else "cpu"
    out["setup_s"] = rec.setup_s
    out["calls_summary"] = f"{setup_parts}; {calls_summary(rec)}"
    out["checks"] = {"wrong_answers": {"value": wrong, "limit": 0},
                     "table_rows_wrong": {"value": table_wrong, "limit": 0}}
    return out


def calls_summary(rec: Record) -> str:
    """The timed calls' count and quartiles, for standard error."""
    def quartiles(xs):
        if len(xs) < 2:
            return "-"
        q = statistics.quantiles(xs, n=4)
        return (f"{1e3 * min(xs):.3f}/{1e3 * q[0]:.3f}/{1e3 * q[1]:.3f}/"
                f"{1e3 * q[2]:.3f}/{1e3 * max(xs):.3f} ms")

    return (f"window {len(rec.call_s)} calls, min/q1/median/q3/max "
            f"{quartiles(rec.call_s)}; entry {quartiles(rec.entry_s)}, below "
            f"{quartiles(rec.below_s)}")


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else (
        f"not read (rc {proc.returncode})")


def main(argv=None) -> int:
    try:
        age = process_age_s()
    except (OSError, ValueError, IndexError):
        age = 0.0
    t_start = time.perf_counter() - age
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from msmbench.spec import ROOT, Bench

    set_cache_dirs(str(ROOT))
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("msmbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"msmbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"msmbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    print(f"msmbench: {args.workload} seed {args.seed}: setup "
          f"{out.pop('setup_s'):.3f} s = {out.pop('calls_summary')}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
