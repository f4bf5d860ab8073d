#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_msm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, times both at the shapes of
the main path, then runs `tpu_msm_torch.msm_best` at n = 2^12 and n = 2^20
on bench-style inputs and requires the native C++ engine's result exactly.
One line per phase on stdout; then the kernels' JSON line, the card's
`nvidia-smi` name and power limit, and last
`{"ok": true, "device": {...}}`. Any failure raises: the script exits
non-zero with the traceback and prints no `ok` line. Without a CUDA device,
or outside the repository, it fails the same way. Imports no jax.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
# Bench-style inputs (bench.py:51-71): 512 distinct points G·(1 + i·step),
# tiled, and seeded scalars below r.
BASE_POINTS = 512
POINT_STEP = 0xDEADBEEF


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, runs=3, inner=1):
    """Median over `runs` of the mean time of `inner` back-to-back calls,
    in ms, by CUDA events (after one warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_abs_err(got, want):
    """Largest |kernel - plain| over every output; 0 when bit-identical."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(diff.max().item()) if diff.numel() else 0)
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


def to_proj(dev, xy, seed):
    """Affine -> projective with a random scale λ per lane: (xλ : yλ : λ);
    the (0, 0) sentinel -> (0 : λ : 0)."""
    import torch

    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.ops import curve, field
    from tpu_msm_torch.utils import interop

    n = xy[0].shape[1]
    rng = np.random.RandomState(seed)
    lam = [int.from_bytes(rng.bytes(32), "little") % (bn254.P - 1) + 1
           for _ in range(n)]
    lam = interop.limbs_to_device(interop.ints_to_limbs(lam),
                                  np.zeros((16, n), np.uint32),
                                  np.zeros((16, n), np.uint32), dev)[0]
    inf = curve.affine_is_infinity(curve.AffinePoint(*xy))
    z = torch.where(inf, 0, lam)
    return (field.mont_mul(xy[0], lam), field.mont_mul(
        torch.where(inf, field.one_mont((n,), dev), xy[1]), lam), z)


# --------------------------------------------------------------------------
# Phases.
# --------------------------------------------------------------------------

def phase_build():
    from tpu_msm_torch import _build

    res = _build.build()
    log(1, f"build: {'compiled' if res['built'] else 'up to date'} in "
        f"{res['seconds']:.1f} s -> {res['lib']}")
    kernel = None
    for line in res["log"].splitlines():
        if "Compiling entry function" in line:
            kernel = next(k for k in ("scan_madd_kernel", "padd_kernel",
                                      "fold_add_kernel", "digit_hist_kernel")
                          if k in line)
        elif kernel and ("registers" in line or "spill" in line):
            detail = line.replace("ptxas info    :", "").strip()
            log(1, f"ptxas {kernel}: {detail}")
    _build.load()


def phase_kernels(dev):
    """Each kernel against its plain version (bit-identical): first on edge
    lanes, then at every shape the main path at 2^20 gives it, where both
    are also timed. Returns the kernels' JSON entries."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist
    from tpu_msm_torch.ops.pippenger import pack_u16_rows

    entries = {}

    def check(name, shape, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel differs from its "
                                 f"plain version (max abs err {err})")
        log(2, f"{name} {shape}: kernel == plain (bit-identical)")
        rec = entries.setdefault(name, {"max_abs_err": 0, "checked": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # Shapes go into the JSON line as strings: its numbers are all
        # measured in this run.
        rec["checked"].append(str(shape))

    # ---- edge lanes: infinities, P + P, P + (-P), mid-scan sentinels ----
    a_aff, b_aff = edge_affine(dev, 8192, SEED)
    pa, pb = to_proj(dev, a_aff, SEED + 2), to_proj(dev, b_aff, SEED + 3)
    check("padd", [16, 8192], cc.padd(*pa, *pb), cc.padd_plain(*pa, *pb))

    # fold_add at (16, 64, 8192): the two batches, rolled per step.
    fold_in = [torch.stack([(pa if k % 2 else pb)[i].roll(k, dims=1)
                            for k in range(64)], dim=1).contiguous()
               for i in range(3)]
    check("fold_add", [16, 64, 8192], cc.fold_add(*fold_in),
          cc.fold_add_plain(*fold_in))

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

    # ---- the main path's shapes (c = 16, 4096 lanes, 2^20): checked, then
    # kernel and plain version timed ----
    def timed(name, shape, fn, plain, plain_shape=None, inner=1):
        ms = cuda_ms(fn, inner=inner)
        pms = cuda_ms(plain, inner=inner)
        rec = {"shape": str(shape), "ms": ms, "plain_ms": pms,
               "plain_shape": str(plain_shape or shape)}
        log(2, f"time {name} {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms"
            + (f" (plain at {plain_shape})" if plain_shape else ""))
        return rec

    # digit_hist at n = 2^20, m = 2^15, with one heavy bin.
    m = 1 << 15
    gen = torch.Generator(device=dev).manual_seed(SEED)
    digits = torch.randint(0, m + 2, (1 << 20,), generator=gen, device=dev,
                           dtype=torch.int32)
    digits[: 1 << 17] = 12345
    check("digit_hist", [1 << 20], hist.digit_hist(digits, m),
          hist.digit_hist_plain(digits, m))
    entries["digit_hist"].update(timed(
        "digit_hist", [1 << 20], lambda: hist.digit_hist(digits, m),
        lambda: hist.digit_hist_plain(digits, m)))

    # scan at (8, 256, 4096); the plain version is timed at 8 of the 256
    # steps (one full plain scan takes seconds).
    scan_x = torch.stack([pack_u16_rows(a_aff[0].roll(k, dims=1)[:, :4096])
                          for k in range(256)], dim=1).contiguous()
    scan_y = torch.stack([pack_u16_rows(a_aff[1].roll(k, dims=1)[:, :4096])
                          for k in range(256)], dim=1).contiguous()
    check("scan_madd", [8, 256, 4096], cc.scan_madd(scan_x, scan_y),
          cc.scan_madd_plain(scan_x, scan_y))
    entries["scan_madd"].update(timed(
        "scan_madd", [8, 256, 4096], lambda: cc.scan_madd(scan_x, scan_y),
        lambda: cc.scan_madd_plain(scan_x[:, :8].contiguous(),
                                   scan_y[:, :8].contiguous()),
        plain_shape=[8, 8, 4096]))

    # Projective operands for fold_add and padd, tiled to each width. Lane 0
    # (an infinity) is dropped so that the narrow widths add real points.
    big = [c[:, 1:] for c in
           to_proj(dev, edge_affine(dev, 8192, SEED + 5)[0], SEED + 6)]

    def tile(t, width):
        return t.repeat(1, -(-width // t.shape[1]))[:, :width].contiguous()

    # fold_add at (16, 16, 32768): _sides_batched's W x fanout lanes.
    fold_main = [tile(c, 16 * 32768).reshape(16, 16, 32768) for c in big]
    check("fold_add", [16, 16, 32768], cc.fold_add(*fold_main),
          cc.fold_add_plain(*fold_main))
    entries["fold_add"].update(timed(
        "fold_add", [16, 16, 32768], lambda: cc.fold_add(*fold_main),
        lambda: cc.fold_add_plain(*fold_main)))

    # padd at every width of the main path: W·q query adds, the W·lanes
    # lane-carry scan, the W·fanout rolled tree, M·X(n) at W, Horner at 1
    # (each lane added to its neighbour; at width 1 that is a doubling).
    def padd_at(width, inner):
        ops = [tile(c, width) for c in big]
        ops += [o.roll(1, dims=1).contiguous() for o in ops]
        check("padd", [16, width], cc.padd(*ops), cc.padd_plain(*ops))
        if inner is None:
            return None
        return timed("padd", [16, width], lambda: cc.padd(*ops),
                     lambda: cc.padd_plain(*ops), inner=inner)

    # Widths 16 and 1 are timed per call over 100 calls: launch-bound.
    first, *others = (r for r in (padd_at(w, k) for w, k in (
        (16 * 32769, 1), (16 * 4096, 1), (16 * 2048, None), (16, 100),
        (1, None))) if r is not None)
    entries["padd"].update(first, other_shapes=others)
    return entries


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


def phase_e2e(dev):
    """msm_best at 2^12 and 2^20 against the native engine; the kernel
    counters over exactly these runs. Returns the counters."""
    import torch

    import tpu_msm_torch
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist

    counters = {"scan_madd": cc.scan_madd, "padd": cc.padd,
                "fold_add": cc.fold_add, "digit_hist": hist.digit_hist}
    plains = [cc.scan_madd_plain, cc.padd_plain, cc.fold_add_plain,
              hist.digit_hist_plain]
    inputs = {log_n: bench_inputs(1 << log_n) for log_n in (12, 20)}
    expected = {}
    for log_n, (px, py, sl) in inputs.items():
        t0 = time.perf_counter()
        expected[log_n] = native.msm(px, py, sl)
        log(3, f"native engine n=2^{log_n}: {time.perf_counter() - t0:.3f} s")

    for fn in counters.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0

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

    launches = {k: fn.launches for k, fn in counters.items()}
    calls = {fn.__name__: fn.calls for fn in plains}
    log(3, f"kernel launches {launches}; plain calls {calls}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if any(calls.values()):
        raise AssertionError(f"a plain version ran on the card: {calls}")

    # The device pipeline alone on device-resident inputs (no host-side
    # coercion, transfer or affine conversion), as bench.py times it.
    from tpu_msm_torch.utils import interop

    cfg = tpu_msm_torch.select_config(1 << 20)
    dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, dev)
    dev_ms = cuda_ms(lambda: tpu_msm_torch.msm_device(dpx, dpy, dsl, cfg))
    log(3, f"msm_device n=2^20 on device-resident inputs: {dev_ms:.3f} ms "
        f"-> {(1 << 20) / dev_ms * 1e3:.1f} points/s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tpu_msm_torch.msm_device(dpx, dpy, dsl, cfg)
    torch.cuda.synchronize()
    log(3, f"msm_device n=2^20 peak device memory above its inputs: "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB")
    return launches


SOURCES = {
    "scan_madd": ("tpu_msm_torch/csrc/ec_kernels.cu",
                  "tpu_msm/ops/pallas_curve.py:799"),
    "padd": ("tpu_msm_torch/csrc/ec_kernels.cu",
             "tpu_msm/ops/pallas_curve.py:1009"),
    "fold_add": ("tpu_msm_torch/csrc/ec_kernels.cu",
                 "tpu_msm/ops/pallas_curve.py:953"),
    "digit_hist": ("tpu_msm_torch/csrc/hist.cu", "tpu_msm/ops/hist.py:171"),
}


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

    phase_build()
    entries = phase_kernels(dev)
    launches = phase_e2e(dev)

    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **entries[name]}
               for name, (source, replaces) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
