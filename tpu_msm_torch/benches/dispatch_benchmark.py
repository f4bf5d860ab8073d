"""The dispatcher's two thresholds, measured on the card.

    python -m tpu_msm_torch.benches.dispatch_benchmark \\
        --crossover 8 9 10 11 12 13 14 --unstreamed 24 25 26 27 --stream 24

* `--crossover`: at each log size, `msm_best` on the device route
  (CPU_THRESHOLD forced to 0) against the native engine (`native.msm`),
  each the median of `--repeats` host-clock runs after a warm-up, taken in
  turns (native, device, device, native, ...). The crossover is the
  smallest measured size from which the device is faster at every larger
  measured size: the value `CPU_THRESHOLD` should take.
* `--unstreamed`: `msm_device` on inputs resident on the card, with
  `select_config(n)`, at each log size in turn until one runs out of
  memory: its time (median of 2 after a warm-up), peak
  `torch.cuda.max_memory_allocated`, and G, the windows of one scan launch.
* `--stream`: at each log size, the streamed pipeline (`msm_streamed` in
  chunks of 2^(STREAM_THRESHOLD's log): on resident card tensors, resident
  from numpy, and host-streamed from numpy) against `msm_device`
  unstreamed (left out where it runs out of memory), each run once and
  then timed in turns (forward, then backward); the peak
  `max_memory_allocated` of each, the choice of
  `streaming.resident_by_default`, and one torch.profiler profile of the
  streamed call (`cli.trace.profile`: busy ms, idle share, launches per
  kernel).

Inputs (`tiled_inputs`): bench.py's 512 distinct points G·(1 + i·0xDEADBEEF),
tiled, and scalars drawn in numpy below 2^253 (< r, so canonical). Every
result is held against `tiled_expected`, the MSM folded onto the 512 base
points and run by the native engine. One JSON line per measurement, each
with the card's name and power limit. Needs a CUDA device and raises
without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from tpu_msm_torch.benches import emit

BASE_POINTS = 512
POINT_STEP = 0xDEADBEEF
# Scalars below 2^253: the top limb keeps 13 bits.
TOP_LIMB_MASK = (1 << 13) - 1


def tiled_inputs(n: int, seed: int = 1):
    """n points (BASE_POINTS distinct ones, tiled; n a multiple of
    BASE_POINTS, or below it) and n scalars below 2^253 drawn in numpy.
    Returns (px, py, sl, (bx, by)): (16, n) uint32 limb arrays and the base
    points' (16, BASE_POINTS) Montgomery limbs."""
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    ks = interop.ints_to_limbs([1 + i * POINT_STEP
                                for i in range(BASE_POINTS)])
    bx, by = native.ec_mul_batch((bn254.GX, bn254.GY), ks)
    reps = -(-n // BASE_POINTS)
    px = np.ascontiguousarray(np.tile(bx, reps)[:, :n])
    py = np.ascontiguousarray(np.tile(by, reps)[:, :n])
    rng = np.random.default_rng(seed)
    sl = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    sl[15] &= TOP_LIMB_MASK
    return px, py, sl, (bx, by)


def tiled_expected(base, sl):
    """The MSM of tiled_inputs, independently of the pipeline: point i is
    base point i mod 512, so the MSM is sum_j (sum_k s_{j + 512k} mod r)
    · B_j. The column sums of the limbs stay below 2^31 up to 2^15 tiles
    (int64 here for any n); the native engine runs the 512-point MSM."""
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    n = sl.shape[1]
    if n % BASE_POINTS:
        raise ValueError(f"n = {n} is not a multiple of {BASE_POINTS}")
    sums = sl.reshape(16, n // BASE_POINTS, BASE_POINTS).sum(
        axis=1, dtype=np.int64)
    folded = [sum(int(sums[limb, j]) << (16 * limb) for limb in range(16))
              % bn254.FR for j in range(BASE_POINTS)]
    return native.msm(*base, interop.ints_to_limbs(folded))


def host_seconds(fn) -> float:
    """One call of fn on the host clock, ended by a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _affine(res):
    from tpu_msm_torch.utils import interop

    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


def crossover(log_sizes, repeats: int = 5) -> dict:
    """msm_best's device route against the native engine at each log size
    (module docstring). Returns {"rows": [...], "crossover_log": k or
    None}."""
    import tpu_msm_torch
    from tpu_msm_torch.bindings import native

    dev = torch.device("cuda")
    rows = []
    saved = tpu_msm_torch.CPU_THRESHOLD
    try:
        tpu_msm_torch.CPU_THRESHOLD = 0
        for log_n in log_sizes:
            px, py, sl, _ = tiled_inputs(1 << log_n)
            want = native.msm(px, py, sl)
            runs = {"native": lambda: native.msm(px, py, sl),
                    "device": lambda: tpu_msm_torch.msm_best(
                        sl, (px, py), device=dev)}
            if runs["device"]() != want:
                raise AssertionError(f"device route at 2^{log_n} != native")
            times = {k: [] for k in runs}
            for _ in range(repeats):
                for k in ("native", "device", "device", "native"):
                    times[k].append(host_seconds(runs[k]))
            rec = {"what": "crossover", "log_n": log_n,
                   **{f"{k}_ms": statistics.median(v) * 1e3
                      for k, v in times.items()},
                   "runs_ms": {k: [t * 1e3 for t in v]
                               for k, v in times.items()}}
            rows.append(rec)
            emit(rec, "cuda")
    finally:
        tpu_msm_torch.CPU_THRESHOLD = saved
    cross = None
    for rec in reversed(rows):  # from the largest size down
        if rec["device_ms"] >= rec["native_ms"]:
            break
        cross = rec["log_n"]
    out = {"what": "crossover_summary", "crossover_log": cross}
    emit(out, "cuda")
    return out


def unstreamed(log_sizes) -> list:
    """msm_device unstreamed at each log size until one runs out of memory
    (module docstring)."""
    import tpu_msm_torch
    from tpu_msm_torch.ops import pippenger
    from tpu_msm_torch.utils import interop

    dev = torch.device("cuda")
    out = []
    for log_n in log_sizes:
        n = 1 << log_n
        px, py, sl, base = tiled_inputs(n)
        want = tiled_expected(base, sl)
        cfg = tpu_msm_torch.select_config(n, dev)
        bits_n = 2 * n if cfg.glv else n
        wins = (cfg.num_windows() if not cfg.glv else
                -(-128 // cfg.window_bits))
        rec = {"what": "unstreamed", "log_n": log_n, "cfg": str(cfg),
               "g": pippenger.window_group_size(wins, bits_n, dev),
               "windows": wins}
        try:
            d = interop.limbs_to_device(px, py, sl, dev)
            del px, py
            torch.cuda.synchronize()
            rec["inputs_mib"] = torch.cuda.memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()
            got = _affine(tpu_msm_torch.msm_device(*d, cfg))
            rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            if got != want:
                raise AssertionError(f"unstreamed 2^{log_n} != expected")
            times = [host_seconds(lambda: tpu_msm_torch.msm_device(*d, cfg))
                     for _ in range(2)]
            rec.update(ok=True, ms=statistics.median(times) * 1e3,
                       runs_ms=[t * 1e3 for t in times])
        except torch.cuda.OutOfMemoryError as e:
            rec.update(ok=False, error=str(e).splitlines()[0])
        d = None
        torch.cuda.empty_cache()
        out.append(rec)
        emit(rec, "cuda")
        if not rec["ok"]:
            break
    return out


def stream(log_n: int) -> dict:
    """Streamed against unstreamed at 2^log_n (module docstring)."""
    import tpu_msm_torch
    from tpu_msm_torch.cli import trace
    from tpu_msm_torch.ops import streaming
    from tpu_msm_torch.utils import interop

    dev = torch.device("cuda")
    n = 1 << log_n
    chunk_log = tpu_msm_torch.STREAM_THRESHOLD.bit_length() - 1
    chunk = 1 << chunk_log
    px, py, sl, base = tiled_inputs(n)
    want = tiled_expected(base, sl)
    d = interop.limbs_to_device(px, py, sl, dev)
    cfg = tpu_msm_torch.select_config(n, dev)
    runs = {
        "unstreamed": lambda: tpu_msm_torch.msm_device(*d, cfg),
        "streamed": lambda: streaming.msm_streamed(
            *d, chunk_log=chunk_log, device=dev),
        "resident_from_host": lambda: streaming.msm_streamed(
            px, py, sl, chunk_log=chunk_log, resident=True, device=dev),
        "host_streamed": lambda: streaming.msm_streamed(
            px, py, sl, chunk_log=chunk_log, resident=False, device=dev)}
    rec = {"what": "stream", "log_n": log_n, "chunk_log": chunk_log,
           "chunks": -(-n // chunk),
           "resident_by_default": streaming.resident_by_default(
               -(-n // chunk) * chunk, chunk, dev),
           "inputs_mib": torch.cuda.memory_allocated() / 2**20}
    for k in list(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            got = _affine(runs[k]())
        except torch.cuda.OutOfMemoryError as e:
            rec[f"{k}_error"] = str(e).splitlines()[0]
            del runs[k]
            torch.cuda.empty_cache()
            continue
        rec[f"{k}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        if got != want:
            raise AssertionError(f"{k} at 2^{log_n} != expected")
    times = {k: [] for k in runs}
    for k in [*runs, *reversed(runs)]:
        times[k].append(host_seconds(runs[k]))
    rec.update({f"{k}_ms": [t * 1e3 for t in v] for k, v in times.items()})
    rec["streamed_profile"] = trace.profile(runs["streamed"])
    emit(rec, "cuda")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crossover", type=int, nargs="*", default=[])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--unstreamed", type=int, nargs="*", default=[])
    ap.add_argument("--stream", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from tpu_msm_torch.utils import profiling

    profiling.require_card("the dispatch benchmark")
    if args.crossover:
        crossover(args.crossover, args.repeats)
    for log_n in args.stream:
        stream(log_n)
    if args.unstreamed:
        unstreamed(args.unstreamed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
