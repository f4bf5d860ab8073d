"""MSM profiler CLI of the PyTorch port (counterpart of
`tpu_msm/cli/profiler.py`, itself the port of the Rust reference's
`gpu_profiler`).

Usage (positionals as the reference's
`log_instance_size num_instances run_mode retries parallel_runs`):

    python -m tpu_msm_torch.cli.profiler 20 5 gpu 10
    python -m tpu_msm_torch.cli.profiler 20 1 check 1
    python -m tpu_msm_torch.cli.profiler 16 2 best 2 4   # concurrency stress
    python -m tpu_msm_torch.cli.profiler 22 1 stream 1
    python -m tpu_msm_torch.cli.profiler 20 1 hybrid 1
    python -m tpu_msm_torch.cli.profiler 20 1 sharded 1
    python -m tpu_msm_torch.cli.profiler --check-kernels

Run modes:

    gpu    msm_device on the card, inputs placed there once before timing
           (the JAX package's "tpu", the reference's "gpu")
    best   the adaptive dispatcher msm_best (the reference's "best_gpu")
    cpu    the native C++ engine
    check  gpu and cpu on every instance; exit 1 unless they agree
    stream the chunked pipeline (`ops.streaming.msm_streamed`, chunks of
           2^20, each with the instance size's configuration, as in the
           JAX package) on inputs placed on the card once
    hybrid the card + native CPU split (`hybrid.msm_hybrid`, the
           reference's "gpu_cpu"), on host inputs
    sharded `parallel.sharded.msm_sharded`, one shard on each visible CUDA
           device, on inputs placed on the first card once
    stream, hybrid and sharded hold their warm-up result on the first
    instance against the native engine (outside the timing); exit 1 unless
    they agree

`parallel_runs > 1` (gpu | best | cpu) splits each instance into that many
chunks, runs each on its own thread after a random 0-50 ms delay, and
requires the EC sum of the chunk results to equal the single-threaded
result.

`--check-kernels` holds every CUDA kernel of the port against its plain
PyTorch version bit for bit, and against the curve-level ops by projective
equality, on the card at 1024 lanes with edge lanes (equal points,
inverses, infinities), and logs one `kernel <name> OK|MISMATCH` line each.

The gpu, best, check, stream, hybrid and sharded modes and
`--check-kernels` need a CUDA device and raise without one: they never run
on the CPU instead. Inputs come from
`tpu_msm_torch.utils.preprocess` (cached under TPU_MSM_CACHE_DIR, same
files as the JAX package's). Timings are logged; -v adds per-run lines.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import sys
import threading
import time

import numpy as np
import torch

log = logging.getLogger("tpu_msm_torch.profiler")

MODES = ("gpu", "best", "cpu", "check", "stream", "hybrid", "sharded")
# The chunk of the stream mode, as in the JAX package's `_run_stream`.
STREAM_CHUNK_LOG = 20


def _card() -> torch.device:
    """The CUDA device the card modes run on; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("this mode needs a CUDA device and none is "
                           "available")
    return torch.device("cuda")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(inst, device):
    """The instance's limb arrays as (16, n) int32 tensors on `device`."""
    from tpu_msm_torch.utils import interop, preprocess

    return preprocess.MsmInstance(
        *interop.limbs_to_device(inst.px, inst.py, inst.scalars, device))


def _affine(res):
    from tpu_msm_torch.utils import interop

    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


def run_gpu(inst, cfg, device):
    """msm_device on `inst` (numpy arrays, or tensors already on `device`);
    returns the (16, 1) projective result after the device has finished."""
    import tpu_msm_torch

    if isinstance(inst.px, np.ndarray):
        inst = _on_device(inst, device)
    res = tpu_msm_torch.msm_device(inst.px, inst.py, inst.scalars, cfg)
    _sync(device)
    return res


def run_cpu(inst):
    from tpu_msm_torch.bindings import native

    return native.msm(inst.px, inst.py, inst.scalars)


def run_best(inst, device):
    import tpu_msm_torch

    return tpu_msm_torch.msm_best(inst.scalars, (inst.px, inst.py),
                                  device=device)


def run_stream(inst, cfg, device, chunk_log: int = STREAM_CHUNK_LOG):
    """msm_streamed on `inst` (numpy arrays, or tensors already on
    `device`) in chunks of 2^chunk_log, every chunk with `cfg`; returns the
    (16, 1) projective result after the device has finished."""
    from tpu_msm_torch.ops import streaming

    res = streaming.msm_streamed(inst.px, inst.py, inst.scalars, cfg,
                                 chunk_log=chunk_log, device=device)
    _sync(device)
    return res


def run_hybrid(inst, cfg, device):
    """msm_hybrid on `inst` (numpy arrays) at the ladder's share, the device
    part with `cfg`; returns the affine result."""
    from tpu_msm_torch.hybrid import msm_hybrid

    return msm_hybrid(inst.px, inst.py, inst.scalars, cfg, device=device)


def sharded_devices():
    """The sharded mode's devices: every visible CUDA device."""
    from tpu_msm_torch.parallel import sharded

    return sharded.default_devices()


def run_sharded(inst, cfg, devices):
    """msm_sharded on `inst` (numpy arrays, or tensors) over `devices`, each
    shard with `cfg`; returns the (16, 1) projective result after the
    devices have finished."""
    from tpu_msm_torch.parallel import sharded

    res = sharded.msm_sharded((inst.px, inst.py), inst.scalars,
                              devices=devices, cfg=cfg)
    for dev in set(devices):
        _sync(dev)
    return res


def run_check(inst, cfg, device, dev_inst=None):
    """(device result, native result), both affine. `dev_inst` is `inst`
    already placed on `device`, if the caller has it."""
    return _affine(run_gpu(dev_inst or inst, cfg, device)), run_cpu(inst)


def run_parallel(inst, cfg, mode: str, k: int, device):
    """Concurrency stress (reference gpu_profiler.rs:102-132): `inst` in `k`
    chunks, each on its own thread after a random 0-50 ms delay; returns
    the EC sum of the chunk results (affine). Raises if a thread failed."""
    from tpu_msm_torch.utils import oracle, preprocess

    n = inst.px.shape[1]
    bounds = [round(i * n / k) for i in range(k + 1)]
    results = [None] * k
    errors = []

    def worker(i):
        try:
            time.sleep(random.uniform(0, 0.05))
            lo, hi = bounds[i], bounds[i + 1]
            sub = preprocess.MsmInstance(
                inst.px[:, lo:hi], inst.py[:, lo:hi], inst.scalars[:, lo:hi])
            if mode == "gpu":
                results[i] = _affine(run_gpu(sub, cfg, device))
            elif mode == "best":
                results[i] = run_best(sub, device)
            else:
                results[i] = run_cpu(sub)
        except Exception as e:  # noqa: BLE001 - re-raised below, per chunk
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"parallel chunk(s) failed: {errors}")
    acc = None
    for r in results:
        acc = oracle.ec_add(acc, r)
    return acc


# --------------------------------------------------------------------------
# --check-kernels
# --------------------------------------------------------------------------

CHECK_LANES = 1024


def _check_inputs(device, lanes: int, seed: int = 5150):
    """Two affine batches with Q == P on lanes [256, 384) (doubling), Q == -P
    on [384, 512) (cancellation) and infinities every 97 lanes, as the JAX
    check builds them, plus three more batches for the scans."""
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.ops import field
    from tpu_msm_torch.ops.curve import AffinePoint
    from tpu_msm_torch.utils import interop

    rng = np.random.RandomState(seed)

    def points():
        ks = interop.ints_to_limbs(
            [int(k) for k in rng.randint(1, 1 << 16, size=lanes)])
        xy = native.ec_mul_batch((bn254.GX, bn254.GY), ks)
        for a in xy:
            a[:, ::97] = 0  # the (0, 0) infinity sentinel
        return AffinePoint(*(torch.from_numpy(a.view(np.int32)).to(device)
                             for a in xy))

    p, q = points(), points()
    q.x[:, 256:384] = p.x[:, 256:384]
    q.y[:, 256:384] = p.y[:, 256:384]
    q.x[:, 384:512] = p.x[:, 384:512]
    q.y[:, 384:512] = field.neg_mod(p.y[:, 384:512])
    return p, q, [points() for _ in range(3)]


# The route name's suffix for each kernel path of padd and fold_add.
_GROUP = {"thread": "", "group": "_group"}


def _check_routes(device, lanes: int = CHECK_LANES):
    """Every kernel route on `device` against its plain version (bit for
    bit) and against the curve-level ops (projective equality). Returns
    {route: list of the checks that failed}."""
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import curve, hist
    from tpu_msm_torch.ops.curve import ProjPoint
    from tpu_msm_torch.ops.pippenger import pack_u16_rows

    p_aff, q_aff, steps = _check_inputs(device, lanes)
    p, q = curve.affine_to_proj(p_aff), curve.affine_to_proj(q_aff)
    pj, qj = curve.affine_to_jac(p_aff), curve.affine_to_jac(q_aff)
    failed = {}

    def same(a, b):
        if isinstance(a, torch.Tensor):
            a, b = (a,), (b,)
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def check(route, kernel, plain, eq=None, want=None):
        bad = failed.setdefault(route, [])
        if not same(kernel, plain):
            bad.append("plain")
        if eq is not None and not bool(eq(type(want)(*kernel), want).all()):
            bad.append("curve")

    args = (*p, *q_aff)
    for path in cc.PATHS:
        check("pmadd" + _GROUP[path], cc.pmadd(*args, path=path),
              cc.pmadd_plain(*args), curve.proj_eq,
              curve.proj_madd(p, q_aff))
    args = (*p, *q)
    for path in cc.PATHS:
        check("padd" + _GROUP[path], cc.padd(*args, path=path),
              cc.padd_plain(*args), curve.proj_eq, curve.proj_add(p, q))
    args = (*pj, *q_aff)
    check("jac_madd", cc.jac_madd(*args), cc.jac_madd_plain(*args),
          curve.jac_eq, curve.jac_add_affine(pj, q_aff))
    args = (*pj, *qj)
    check("jac_add", cc.jac_add(*args), cc.jac_add_plain(*args), curve.jac_eq,
          curve.jac_add(pj, qj))

    # The scans over three steps, against stepwise curve.proj_madd.
    acc = curve.proj_infinity((lanes,), device)
    prefix = []
    for pt in steps:
        acc = curve.proj_madd(acc, pt)
        prefix.append(acc)
    want = ProjPoint(*(torch.stack(c, dim=1) for c in zip(*prefix)))
    gx, gy = (torch.stack([getattr(pt, f) for pt in steps], dim=1)
              for f in ("x", "y"))
    # scan_madd_rows at the chunks its wrapper takes (on the card the rule's,
    # cuda_curve.scan_rows_chunks; 1 on the CPU), against the plain version
    # at the same chunks; in one chunk it is the serial scan, whose bits the
    # packed scan has too.
    chunks = 1
    if torch.device(device).type == "cuda":
        chunks = cc.scan_rows_chunks(len(steps), lanes, torch.cuda
                                     .get_device_properties(device)
                                     .multi_processor_count)
    rows = cc.scan_madd_rows(gx, gy)
    check("scan_madd_rows", rows, cc.scan_madd_rows_plain(gx, gy, chunks),
          curve.proj_eq, want)
    pgx, pgy = (torch.stack([pack_u16_rows(getattr(pt, f)) for pt in steps],
                            dim=1) for f in ("x", "y"))
    ys48 = cc.scan_madd(pgx, pgy)
    check("scan_madd", ys48, cc.scan_madd_plain(pgx, pgy))
    if not bool(curve.proj_eq(ProjPoint(*ys48.split(16)), want).all()):
        failed["scan_madd"].append("curve")
    serial = cc.scan_madd_rows(gx, gy, chunks=1)
    if not same(ys48, torch.cat(serial)):  # the packed and row scans agree
        failed["scan_madd"].append("rows")

    # fold_add over the doubled scan inputs, against sequential proj_add.
    doubled = [curve.proj_double(curve.affine_to_proj(pt)) for pt in steps]
    bx, by, bz = (torch.stack([getattr(pt, f) for pt in doubled], dim=1)
                  for f in ("x", "y", "z"))
    acc = curve.proj_infinity((lanes,), device)
    for pt in doubled:
        acc = curve.proj_add(acc, pt)
    for path in cc.PATHS:
        check("fold_add" + _GROUP[path], cc.fold_add(bx, by, bz, path=path),
              cc.fold_add_plain(bx, by, bz), curve.proj_eq, acc)

    # digit_hist through both segment-start options, one window (1-D) and
    # a group of three windows in one launch (2-D), against searchsorted;
    # at m = 2^15 (c = 16 signed: the bins fit one block as int32) and
    # 65535 (c = 16 unsigned, the tuned row: they do not; ops/hist.py,
    # `plan`).
    rng = np.random.RandomState(7)
    for m in (1 << 15, (1 << 16) - 1):
        dig = rng.randint(0, m + 2, size=(3, 2048 * 8)).astype(np.int32)
        dig[1, :4096] = 5  # a heavy bin
        srt = np.sort(dig, axis=1)
        starts = np.stack([np.searchsorted(row, np.arange(1, m + 1),
                                           side="left") for row in srt])
        want = torch.from_numpy(starts.astype(np.int32)).to(device)
        for route, digits, fn in (
                ("digit_hist[hist]", dig[0], hist.segment_starts_hist),
                ("digit_hist[hist_cols]", srt[0],
                 hist.segment_starts_hist_cols),
                ("digit_hist[group]", dig, hist.segment_starts_hist)):
            d = torch.from_numpy(np.ascontiguousarray(digits)).to(device)
            bad = failed.setdefault(route, [])
            if not same(hist.digit_hist(d, m), hist.digit_hist_plain(d, m)):
                bad.append(f"plain at m = {m}")
            if not torch.equal(fn(d, m), want[0] if d.dim() == 1 else want):
                bad.append(f"searchsorted at m = {m}")
    return failed


def check_kernels(device="cuda") -> int:
    """--check-kernels on the card: 0 when every route agrees, else 1.
    Logs one line per route and, last, the kernel launches it made."""
    from tpu_msm_torch.ops import cuda_curve as cc
    from tpu_msm_torch.ops import hist

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("--check-kernels runs the CUDA kernels: it needs "
                           "a CUDA device")
    _card()
    counters = {f.__name__: f for f in (
        cc.scan_madd, cc.scan_madd_rows, cc.padd, cc.pmadd, cc.jac_madd,
        cc.jac_add, cc.fold_add, hist.digit_hist)}
    for f in counters.values():
        f.launches = 0
    cc.padd.group_launches = cc.fold_add.group_launches = 0
    cc.pmadd.group_launches = 0
    failed = _check_routes(device)
    torch.cuda.synchronize(device)
    for route, bad in failed.items():
        log.info("kernel %-22s %s", route,
                 "OK" if not bad else "MISMATCH (" + ", ".join(bad) + ")")
    launches = {k: f.launches for k, f in counters.items()}
    launches["padd_group"] = cc.padd.group_launches
    launches["fold_add_group"] = cc.fold_add.group_launches
    launches["pmadd_group"] = cc.pmadd.group_launches
    log.info("kernel launches %s", json.dumps(launches))
    bad = [r for r, b in failed.items() if b]
    if bad:
        log.error("kernel check FAILED: %s", ", ".join(bad))
        return 1
    log.info("all %d kernel routes match their plain versions and the "
             "curve ops", len(failed))
    return 0


# --------------------------------------------------------------------------
# Entry point.
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_instance_size", type=int, nargs="?")
    ap.add_argument("num_instances", type=int, nargs="?", default=1)
    ap.add_argument("run_mode", nargs="?", default="gpu", choices=MODES)
    ap.add_argument("retries", type=int, nargs="?", default=1)
    ap.add_argument("parallel_runs", type=int, nargs="?", default=1,
                    help="concurrency stress: split each instance into this "
                         "many chunks run on concurrent threads with random "
                         "0-50 ms start delays; requires the EC sum to equal "
                         "the single-threaded result")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--check-kernels", action="store_true",
                    help="hold every CUDA kernel against its plain version "
                         "on the card and exit")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.check_kernels:
        return check_kernels("cuda")
    if args.log_instance_size is None:
        ap.error("log_instance_size is required unless --check-kernels")
    if args.parallel_runs > 1 and args.run_mode not in ("gpu", "best", "cpu"):
        ap.error("parallel_runs > 1 supports run modes gpu | best | cpu")

    from tpu_msm_torch.utils import preprocess
    from tpu_msm_torch.utils.config import select_config

    mode = args.run_mode
    # Every mode but cpu (the native engine alone) runs on the card.
    device = _card() if mode != "cpu" else torch.device("cuda")
    n = 1 << args.log_instance_size
    cfg = select_config(n, device)
    log.info("generating/loading %d instance(s) of size 2^%d",
             args.num_instances, args.log_instance_size)
    instances = preprocess.get_or_create_msm_instances(
        args.log_instance_size, args.num_instances)
    devices = sharded_devices() if mode == "sharded" else None
    # gpu, check, stream and sharded place the arrays on the (first) card
    # once, before timing, so that the runs time the card and not the
    # host-to-device copy.
    if devices is not None:
        device = devices[0]
    on_card = ([_on_device(i, device) for i in instances]
               if mode in ("gpu", "check", "stream", "sharded")
               else instances)

    expected = None
    if args.parallel_runs > 1:
        log.info("parallel_runs=%d: computing single-threaded references",
                 args.parallel_runs)
        expected = [run_best(i, device) if mode == "best" else run_cpu(i)
                    for i in instances]
    elif mode in ("gpu", "check"):
        run_gpu(on_card[0], cfg, device)  # warm-up, excluded from timing
    elif mode == "best":
        run_best(instances[0], device)
    elif mode in ("stream", "hybrid", "sharded"):
        # The warm-up result against the native engine, outside the timing.
        if mode == "stream":
            got = _affine(run_stream(on_card[0], cfg, device))
        elif mode == "hybrid":
            got = run_hybrid(instances[0], cfg, device)
        else:
            got = _affine(run_sharded(on_card[0], cfg, devices))
        want = run_cpu(instances[0])
        if got != want:
            log.error("MISMATCH at instance 0: %s=%s cpu=%s", mode, got, want)
            return 1
        log.info("instance 0: %s == cpu", mode)

    total = 0.0
    runs = 0
    for retry in range(args.retries):
        for i, inst in enumerate(instances):
            t0 = time.perf_counter()
            if args.parallel_runs > 1:
                got = run_parallel(inst, cfg, mode, args.parallel_runs, device)
                if got != expected[i]:
                    log.error("CONCURRENCY MISMATCH at instance %d: "
                              "parallel=%s single=%s", i, got, expected[i])
                    return 1
            elif mode == "gpu":
                run_gpu(on_card[i], cfg, device)
            elif mode == "best":
                run_best(inst, device)
            elif mode == "cpu":
                run_cpu(inst)
            elif mode == "stream":
                run_stream(on_card[i], cfg, device)
            elif mode == "hybrid":
                run_hybrid(inst, cfg, device)
            elif mode == "sharded":
                run_sharded(on_card[i], cfg, devices)
            else:
                got, want = run_check(inst, cfg, device, on_card[i])
                if got != want:
                    log.error("MISMATCH at instance %d: gpu=%s cpu=%s", i,
                              got, want)
                    return 1
                log.info("instance %d: gpu == cpu", i)
            dt = time.perf_counter() - t0
            total += dt
            runs += 1
            log.debug("retry %d instance %d: %.1f ms", retry, i, dt * 1e3)

    if args.parallel_runs > 1:
        log.info("parallel stress: %d runs x %d concurrent chunks, all "
                 "results == single-threaded", runs, args.parallel_runs)
    log.info("Total Execution Time: %.1f ms", total * 1e3)
    log.info("Average Execution Time: %.1f ms (%d runs, %.2f Mpoints/s)",
             total / runs * 1e3, runs, n * runs / total / 1e6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
