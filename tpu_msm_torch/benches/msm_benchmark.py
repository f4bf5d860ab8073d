"""The canonical MSM benchmark (counterpart of the root
`benches/msm_benchmark.py`).

    python -m tpu_msm_torch.benches.msm_benchmark [--log-size 20]
        [--instances 5] [--skip-cpu] [--device cuda|cpu]

The reference's criterion bench runs the BN254 G1 MSM at log size 20 over 5
instances. Its inputs here are the JAX script's:
`utils.preprocess.get_or_create_msm_instances(log_size, instances)` (the
cache honours TPU_MSM_CACHE_DIR), with `select_config(n, device)`.

* The device row: every instance's limbs are placed on the device first
  (`interop.limbs_to_device`); on the card one `msm_device` call warms up
  (the kernels' first launches, the allocator; the CPU runs plain torch
  ops with nothing to warm, and a call there takes seconds at 2^8). Then
  each instance's call is timed on the host clock, ended by reading `x` back
  (as the JAX script ends its calls with `np.asarray(res.x)`), and, on the
  card, by CUDA events around the call. The line gives the median of each
  and Mpts/s.
* The CPU row: the native engine's `msm_jacobian_limbs` on instance 0,
  timed once, as the JAX script does; `--skip-cpu` leaves it out. Its
  line says device "cpu" and, on a card's machine, still names the card.
* The check: the device result of instance 0 equals the native engine's,
  in affine form (the CPU row's result where it ran, else one untimed
  `native.msm` call). A mismatch raises.

The JAX script's docstring names a mesh-sharded row, but its code runs
none; this one runs what that code runs. One JSON line a row, with the
card's name and power limit. Runs on the card unless given `--device cpu`,
and raises without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from tpu_msm_torch.benches import emit
from tpu_msm_torch.utils import interop


def affine(res):
    """A (16, 1) projective result on any device -> the oracle's affine
    point."""
    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


def run(log_size: int = 20, instances: int = 5, skip_cpu: bool = False,
        device=None) -> list:
    """The device row, the CPU row unless skip_cpu, and the check (module
    docstring). Returns the rows' JSON objects; the device row also holds
    "result", instance 0's affine result as [x, y] hex strings."""
    import tpu_msm_torch
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.utils import preprocess
    from tpu_msm_torch.utils.config import select_config

    device = interop.resolve_device(device)
    insts = preprocess.get_or_create_msm_instances(log_size, instances)
    n = 1 << log_size
    cfg = select_config(n, device)
    on_card = device.type == "cuda"

    dev = [interop.limbs_to_device(i.px, i.py, i.scalars, device)
           for i in insts]
    if on_card:
        tpu_msm_torch.msm_device(*dev[0], cfg).x.cpu()  # warm-up
    host_ms, event_ms, first = [], [], None
    for args in dev:
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        res = tpu_msm_torch.msm_device(*args, cfg)
        if on_card:
            end.record()
        res.x.cpu()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if on_card:
            event_ms.append(start.elapsed_time(end))
        if first is None:
            first = res
    got = affine(first)
    med = statistics.median(host_ms)
    rows = []
    row = {"bench": "msm", "row": "device", "log_size": log_size, "n": n,
           "instances": instances, "cfg": str(cfg), "host_ms": host_ms,
           "median_ms": med, "mpts_per_s": n / med / 1e3,
           "event_ms": event_ms or None,
           "median_event_ms": statistics.median(event_ms) if on_card
           else None}

    if not skip_cpu:
        t0 = time.perf_counter()
        xyz = native.msm_jacobian_limbs(insts[0].px, insts[0].py,
                                        insts[0].scalars)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        [want] = interop.jac_limbs_to_affine_points(
            *(xyz[16 * i:16 * i + 16].reshape(16, 1) for i in range(3)))
        cpu_row = {"bench": "msm", "row": "cpu", "log_size": log_size,
                   "n": n, "instances": 1, "ms": cpu_ms,
                   "mpts_per_s": n / cpu_ms / 1e3}
    else:
        want = native.msm(insts[0].px, insts[0].py, insts[0].scalars)
    if got != want:
        raise AssertionError(f"msm_device of instance 0 at 2^{log_size}: "
                             f"{got} != the native engine's {want}")
    row["result"] = None if got is None else [hex(got[0]), hex(got[1])]
    row["equals_native"] = True
    rows.append(emit(row, device))
    if not skip_cpu:
        rows.append(emit(cpu_row, "cpu", machine=device))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-size", type=int, default=20)
    ap.add_argument("--instances", type=int, default=5)
    ap.add_argument("--skip-cpu", action="store_true",
                    help="leave out the native CPU engine's timed row (the "
                         "check still runs it once)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.log_size, args.instances, args.skip_cpu, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
