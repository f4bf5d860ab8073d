#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_msm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, times both at the shapes of
the paths that run them, then drives three paths and requires the native
C++ engine's result exactly:

  * the main path: `tpu_msm_torch.msm_best` at n = 2^12 and n = 2^20 on
    bench-style inputs (the fused route: scan_madd, padd, fold_add,
    digit_hist);
  * the per-window path: `tpu_msm_torch.msm` at n = 2^20 with 16384 scan
    lanes, once with each segment-start option (pmadd, padd, fold_add,
    digit_hist);
  * the profiler CLI: `--check-kernels` (every kernel, among them
    jac_madd, jac_add and scan_madd_rows) and `20 1 check 1`, each in a
    subprocess.

Phase 4 also times the fused route at the per-window path's 16384 lanes,
which the route rule does not take there. Phase 6 profiles `msm_device` at
2^20 on each route (`tpu_msm_torch.cli.trace`): the device's busy time,
idle share and time per kernel.

The kernel counters are set to 0 just before each path and read just after.
One line per phase on stdout; then the kernels' JSON line, the card's
`nvidia-smi` name and power limit, and last
`{"ok": true, "device": {...}}`. Any failure raises: the script exits
non-zero with the traceback and prints no `ok` line. Without a CUDA device,
or outside the repository, it fails the same way. Imports no jax.
"""

from __future__ import annotations

import json
import os
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


def checker(entries, phase):
    """check(name, shape, got, want): kernel output against its plain
    version, bit for bit; records the shape in entries[name]."""
    import torch

    def check(name, shape, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name} {shape}: kernel differs from its "
                                 f"plain version (max abs err {err})")
        log(phase, f"{name} {shape}: kernel == plain (bit-identical)")
        rec = entries.setdefault(name, {"max_abs_err": 0, "checked": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # Shapes go into the JSON line as strings: its numbers are all
        # measured in this run.
        rec["checked"].append(str(shape))

    return check


def timer(phase):
    """timed(name, shape, kernel_fn, plain_fn, ...): both by CUDA events."""

    def timed(name, shape, fn, plain, plain_shape=None, inner=1):
        ms = cuda_ms(fn, inner=inner)
        pms = cuda_ms(plain, inner=inner)
        rec = {"shape": str(shape), "ms": ms, "plain_ms": pms,
               "plain_shape": str(plain_shape or shape)}
        log(phase, f"time {name} {shape}: kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms" + (f" (plain at {plain_shape})" if plain_shape
                               else ""))
        return rec

    return timed


# --------------------------------------------------------------------------
# Phases.
# --------------------------------------------------------------------------

KERNEL_FUNCTIONS = ("scan_madd_rows_kernel", "scan_madd_kernel",
                    "jac_madd_kernel", "jac_add_kernel", "pmadd_kernel",
                    "padd_kernel", "fold_add_kernel", "digit_hist_kernel")


def phase_build():
    from tpu_msm_torch import _build

    res = _build.build()
    log(1, f"build: {'compiled' if res['built'] else 'up to date'} in "
        f"{res['seconds']:.1f} s -> {res['lib']}")
    kernel = None
    for line in res["log"].splitlines():
        if "Compiling entry function" in line:
            kernel = next(k for k in KERNEL_FUNCTIONS if k in line)
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
    check = checker(entries, 2)

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
    timed = timer(2)

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


def counters():
    """({kernel name: wrapper}, [plain versions]) of every kernel."""
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist

    kernels = {"scan_madd": cc.scan_madd, "padd": cc.padd,
               "fold_add": cc.fold_add, "digit_hist": hist.digit_hist,
               "pmadd": cc.pmadd, "jac_madd": cc.jac_madd,
               "jac_add": cc.jac_add, "scan_madd_rows": cc.scan_madd_rows}
    plains = [cc.scan_madd_plain, cc.padd_plain, cc.fold_add_plain,
              hist.digit_hist_plain, cc.pmadd_plain, cc.jac_madd_plain,
              cc.jac_add_plain, cc.scan_madd_rows_plain]
    return kernels, plains


def reset_counts():
    kernels, plains = counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0


def read_counts(phase, path_kernels):
    """The counts since reset_counts(); raises unless every kernel of the
    path launched and no plain version ran."""
    kernels, plains = counters()
    launches = {k: fn.launches for k, fn in kernels.items()}
    calls = {fn.__name__: fn.calls for fn in plains}
    log(phase, f"kernel launches {launches}; plain calls {calls}")
    missing = [k for k in path_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")
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
    launches = read_counts(3, ("scan_madd", "padd", "fold_add", "digit_hist"))

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
    return launches, dev_ms


def phase_new_kernels(dev):
    """pmadd, jac_madd, jac_add and scan_madd_rows against their plain
    versions (bit-identical): edge lanes first, then the shapes their paths
    give them, where both are also timed. Returns their JSON entries."""
    import torch

    from tpu_msm_torch.ops import cuda_curve as cc

    entries = {}
    check = checker(entries, 2)
    timed = timer(2)
    a_aff, b_aff = edge_affine(dev, 8192, SEED + 7)
    pa = to_proj(dev, a_aff, SEED + 8)
    ja, jb = to_jac(dev, a_aff, SEED + 9), to_jac(dev, b_aff, SEED + 10)

    def cut(ts, width):
        return [t[:, :width].contiguous() for t in ts]

    # ---- edge lanes: infinities, P + P, P + (-P) ----
    check("pmadd", [16, 8192], cc.pmadd(*pa, *b_aff),
          cc.pmadd_plain(*pa, *b_aff))
    for width in (1024, 8192):
        ops = (*cut(ja, width), *cut(b_aff, width))
        check("jac_madd", [16, width], cc.jac_madd(*ops),
              cc.jac_madd_plain(*ops))
        ops = (*cut(ja, width), *cut(jb, width))
        check("jac_add", [16, width], cc.jac_add(*ops), cc.jac_add_plain(*ops))
    # scan_madd_rows at (16, 3, 1024): the --check-kernels shape, with a
    # repeat (the accumulator doubles) and mid-scan sentinels.
    xs = [a_aff[0][:, :1024], b_aff[0][:, :1024], a_aff[0][:, :1024]]
    ys = [a_aff[1][:, :1024], b_aff[1][:, :1024], a_aff[1][:, :1024]]
    gx = torch.stack(xs, dim=1).contiguous()
    gy = torch.stack(ys, dim=1).contiguous()
    gx[:, 1, 500:520] = 0
    gy[:, 1, 500:520] = 0
    check("scan_madd_rows", [16, 3, 1024], cc.scan_madd_rows(gx, gy),
          cc.scan_madd_rows_plain(gx, gy))

    # ---- the paths' shapes, checked, then kernel and plain timed ----
    # pmadd at 16384 lanes: one per-window scan step at 2^20, timed per
    # call over 20 back-to-back calls, as the scan makes them.
    ops = [tile(t[:, 1:], 16384) for t in (*pa, *b_aff)]
    check("pmadd", [16, 16384], cc.pmadd(*ops), cc.pmadd_plain(*ops))
    entries["pmadd"].update(timed("pmadd", [16, 16384],
                                  lambda: cc.pmadd(*ops),
                                  lambda: cc.pmadd_plain(*ops), inner=20))
    # jac_madd and jac_add at 2^20 elements.
    big = 1 << 20
    mops = [tile(t[:, 1:], big) for t in (*ja, *b_aff)]
    check("jac_madd", [16, big], cc.jac_madd(*mops), cc.jac_madd_plain(*mops))
    entries["jac_madd"].update(timed("jac_madd", [16, big],
                                     lambda: cc.jac_madd(*mops),
                                     lambda: cc.jac_madd_plain(*mops)))
    del mops
    aops = [tile(t[:, 1:], big) for t in (*ja, *jb)]
    check("jac_add", [16, big], cc.jac_add(*aops), cc.jac_add_plain(*aops))
    entries["jac_add"].update(timed("jac_add", [16, big],
                                    lambda: cc.jac_add(*aops),
                                    lambda: cc.jac_add_plain(*aops)))
    del aops
    # scan_madd_rows at (16, 256, 4096); the plain version is timed at 8 of
    # the 256 steps.
    sx = torch.stack([a_aff[0].roll(k, dims=1)[:, :4096] for k in range(256)],
                     dim=1).contiguous()
    sy = torch.stack([a_aff[1].roll(k, dims=1)[:, :4096] for k in range(256)],
                     dim=1).contiguous()
    check("scan_madd_rows", [16, 256, 4096], cc.scan_madd_rows(sx, sy),
          cc.scan_madd_rows_plain(sx, sy))
    entries["scan_madd_rows"].update(timed(
        "scan_madd_rows", [16, 256, 4096], lambda: cc.scan_madd_rows(sx, sy),
        lambda: cc.scan_madd_rows_plain(sx[:, :8].contiguous(),
                                        sy[:, :8].contiguous()),
        plain_shape=[16, 8, 4096]))
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
        check("padd", [16, width], cc.padd(*ops), cc.padd_plain(*ops))
    # fold_add: ec_reduce folds the 32768 X(s_b) down to 2048 lanes.
    fold = [tile(c, 16 * 2048).reshape(16, 16, 2048) for c in big]
    check("fold_add", [16, 16, 2048], cc.fold_add(*fold),
          cc.fold_add_plain(*fold))
    # digit_hist on sorted digits: every warp sees runs of equal values.
    m = 1 << 15
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    digits = torch.randint(0, m + 1, (1 << 20,), generator=gen, device=dev,
                           dtype=torch.int32)
    digits[: 1 << 17] = 12345
    digits = torch.sort(digits).values
    check("digit_hist", ["sorted", 1 << 20], hist.digit_hist(digits, m),
          hist.digit_hist_plain(digits, m))
    rec = timer(2)("digit_hist", ["sorted", 1 << 20],
                   lambda: hist.digit_hist(digits, m),
                   lambda: hist.digit_hist_plain(digits, m))
    entries["digit_hist"].setdefault("other_shapes", []).append(rec)


def phase_window(dev, inputs, expected, fused_ms):
    """tpu_msm_torch.msm through the per-window path at 2^20 (16384 scan
    lanes, c = 16 signed, fanout 2048), with each segment-start option,
    against the native engine; its counters; its msm_device time beside
    the fused path's. Returns the launches."""
    import tpu_msm_torch
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
    launches = read_counts(4, ("pmadd", "padd", "fold_add", "digit_hist"))
    if launches["scan_madd"]:
        raise AssertionError("the per-window path ran the fused scan")

    dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, dev)
    pw_ms = cuda_ms(lambda: tpu_msm_torch.msm_device(dpx, dpy, dsl, cfgs[0]))
    log(4, f"msm_device n=2^20 per-window path (16384 lanes): {pw_ms:.3f} ms, "
        f"fused path (4096 lanes): {fused_ms:.3f} ms ({pw_ms / fused_ms:.2f}x)")

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
    """One torch.profiler run of msm_device at 2^20 on each route
    (tpu_msm_torch.cli.trace): the device's busy ms, span, idle share and
    time per kernel, one JSON line each."""
    from tpu_msm_torch.cli.trace import msm_on_route, profile
    from tpu_msm_torch.utils import interop
    from tpu_msm_torch.utils.config import MsmConfig

    dpx, dpy, dsl = interop.limbs_to_device(*inputs[20], dev)
    for route, lanes in (("rule", 4096), ("rule", 16384), ("fused", 16384)):
        cfg = MsmConfig(scan_lanes=lanes)
        rec = profile(lambda: msm_on_route(dpx, dpy, dsl, cfg, route))
        log(6, "profile " + json.dumps({"log_n": 20, "route": route,
                                        "lanes": lanes, **rec}))


def phase_cli():
    """The profiler CLI in subprocesses: --check-kernels and `20 1 check 1`,
    with the fixture cache in a temporary directory. Returns the launches
    --check-kernels logged."""
    root = Path(__file__).resolve().parent
    launches = None
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, TPU_MSM_CACHE_DIR=cache)
        for args in (["--check-kernels"], ["20", "1", "check", "1"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_msm_torch.cli.profiler", *args],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=600)
            lines = proc.stderr.splitlines()
            for line in lines:
                if " kernel " in line or "Execution" in line or "==" in line:
                    log(5, line.split(" INFO ")[-1].split(" ERROR ")[-1])
                if "kernel launches " in line:
                    launches = json.loads(line.split("kernel launches ", 1)[1])
            if proc.returncode != 0:
                raise AssertionError(f"profiler {' '.join(args)}: rc "
                                     f"{proc.returncode}\n" + proc.stdout
                                     + "\n".join(lines[-40:]))
            log(5, f"profiler {' '.join(args)}: rc 0 in "
                f"{time.perf_counter() - t0:.1f} s")
    if launches is None or any(v == 0 for v in launches.values()):
        raise AssertionError(f"--check-kernels launches: {launches}")
    return launches


EC = "tpu_msm_torch/csrc/ec_kernels.cu"
PC = "tpu_msm/ops/pallas_curve.py"
# name: (source, the TPU kernels it replaces, the path its launches count)
SOURCES = {
    "scan_madd": (EC, f"{PC}:799", "main"),
    "padd": (EC, f"{PC}:1009", "main"),
    "fold_add": (EC, f"{PC}:953", "main"),
    "digit_hist": ("tpu_msm_torch/csrc/hist.cu",
                   "tpu_msm/ops/hist.py:171, tpu_msm/ops/hist.py:107", "main"),
    "pmadd": (EC, f"{PC}:988", "per_window"),
    "jac_madd": (EC, f"{PC}:367", "cli"),
    "jac_add": (EC, f"{PC}:385", "cli"),
    "scan_madd_rows": (EC, f"{PC}:565", "cli"),
}
PATHS = {"main": "msm_best at 2^12 and 2^20",
         "per_window": "msm at 2^20, 16384 scan lanes, both segment starts",
         "cli": "tpu_msm_torch.cli.profiler --check-kernels"}


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

    phase_build()
    entries = phase_kernels(dev)
    entries.update(phase_new_kernels(dev))
    phase_window_kernels(dev, entries)
    inputs = {log_n: bench_inputs(1 << log_n) for log_n in (12, 20)}
    expected = {}
    for log_n, (px, py, sl) in inputs.items():
        t0 = time.perf_counter()
        expected[log_n] = native.msm(px, py, sl)
        log(3, f"native engine n=2^{log_n}: {time.perf_counter() - t0:.3f} s")
    launches = {}
    launches["main"], fused_ms = phase_e2e(dev, inputs, expected)
    launches["per_window"] = phase_window(dev, inputs, expected, fused_ms)
    launches["cli"] = phase_cli()
    phase_profile(dev, inputs)

    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[path][name],
                "path": PATHS[path], **entries[name]}
               for name, (source, replaces, path) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
