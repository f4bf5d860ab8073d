"""The digit sort, timed (counterpart of the root `benches/sort_benchmark.py`).

    python -m tpu_msm_torch.benches.sort_benchmark [--log-sizes 16 18 20 22]
        [--repeats 3] [--main-log-size 20] [--device cuda|cpu]

(a) The JAX script's measurement: at each log size one uint32 key below
2^16 and 32 uint32 payload rows, drawn from `RandomState(0)` in the JAX
script's order (the key, then the payload, size after size), sorted by the
key carrying the payload. torch has no multi-operand sort, so this is
`torch.sort(keys, stable=True)` and one gather of the (32, n) payload by
its permutation (`sort_by_key`). The sort, the gather and the two together
are timed apart, each the median of `--repeats` calls after a warm-up, by
CUDA events on the card (the host clock on the CPU); Melem/s of the two
together, as the JAX script reports.

(b) The main path's own sort: `pippenger._sorted_scan_inputs` at
2^main-log-size points with `select_config`'s row (the tuned row at 2^20
on the card: 16 windows of c = 16, one group, 8192 lanes) on bench-style
inputs (`dispatch_benchmark.tiled_inputs`), as `_fused_sums` hands it the
first group of windows (`pippenger.scan_operands`, `window_group_size`),
the digits' bits those of the row (`sort.key_bits`). The whole call is
timed as in (a). On the card one call is then profiled (`cli.trace`, with
the host's ops) and its device time split by the op that launched each
kernel (`trace.launching_ops`): the `tpu_msm_torch::digit_sort` operator
(the radix sort's kernels), the `tpu_msm_torch::scan_layout` operator (the
scan_layout kernel, which gathers the sorted points' rows into the scan's
layout), and the rest. Then one `msm_device` call at the same inputs is profiled:
the call's kernels but the layout's, found there as the same run of
kernels, give the same split inside msm_device, and the call's own torch
kernels give their share of torch's own kernels' device ms in that
profile (0 since the sort is the port's kernel). The main path does not
launch scan_layout: its scan (scan_madd_sorted) reads the sorted points
itself, so the layout's part inside msm_device is 0 and its launches
there (`msm_device_layout_launches`) are 0.

One JSON line a measurement, with the card's name and power limit. Runs
on the card unless given `--device cpu`, and raises without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from tpu_msm_torch.benches import call_ms, emit
from tpu_msm_torch.utils import interop

LOG_SIZES = (16, 18, 20, 22)
PAYLOAD_ROWS = 32
SEED = 0  # the JAX script's RandomState(0)
# The ops whose kernels part (b) times apart; the rest is "other_ms".
PARTS = {"tpu_msm_torch::digit_sort": "sort_ms",
         "tpu_msm_torch::scan_layout": "layout_ms"}


def sort_inputs(log_sizes):
    """(log_n, keys (n,), payload (32, n)) for each log size in turn, uint32
    numpy below 2^16, drawn as the JAX script draws them."""
    rng = np.random.RandomState(SEED)
    for log_n in log_sizes:
        n = 1 << log_n
        keys = rng.randint(0, 1 << 16, size=(n,), dtype=np.int64).astype(
            np.uint32)
        payload = rng.randint(0, 1 << 16, size=(PAYLOAD_ROWS, n),
                              dtype=np.int64).astype(np.uint32)
        yield log_n, keys, payload


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy below 2^31 -> int32 tensor on `device` (torch's uint32
    has no sort or gather on the card)."""
    return torch.from_numpy(a.view(np.int32)).to(device)


def sort_by_key(keys: torch.Tensor, payload: torch.Tensor):
    """Stable sort of the keys carrying the (rows, n) payload: (sorted keys,
    sorted payload)."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    return sorted_keys, payload.index_select(1, perm)


def median_ms(fn, device, repeats: int) -> float:
    """Median of `repeats` calls in ms (`call_ms`), after one warm-up."""
    fn()
    return statistics.median(call_ms(fn, device) for _ in range(repeats))


def payload_sort(log_sizes=LOG_SIZES, repeats: int = 3, device=None,
                 outputs: dict | None = None) -> list:
    """Part (a) at each log size, one JSON line each. Where `outputs` is a
    dict, outputs[log_n] = ((keys, payload), (sorted keys, sorted payload))
    as numpy, for a caller's check."""
    device = interop.resolve_device(device)
    records = []
    for log_n, keys, payload in sort_inputs(log_sizes):
        n = 1 << log_n
        dk, dp = to_device(keys, device), to_device(payload, device)
        perm = torch.sort(dk, stable=True)[1]
        sort_ms = median_ms(lambda: torch.sort(dk, stable=True), device,
                            repeats)
        gather_ms = median_ms(lambda: dp.index_select(1, perm), device,
                              repeats)
        both_ms = median_ms(lambda: sort_by_key(dk, dp), device, repeats)
        if outputs is not None:
            got = sort_by_key(dk, dp)
            outputs[log_n] = ((keys, payload),
                              tuple(t.cpu().numpy().view(np.uint32)
                                    for t in got))
        del dk, dp, perm
        records.append(emit({
            "bench": "sort", "part": "a", "log_n": log_n, "n": n,
            "payload_rows": PAYLOAD_ROWS, "repeats": repeats,
            "sort_ms": sort_ms, "gather_ms": gather_ms, "ms": both_ms,
            "melem_per_s": n / both_ms / 1e3}, device))
    return records


def main_path_operands(log_n: int = 20, device=None, cfg=None):
    """The first window group's `_sorted_scan_inputs` arguments at
    2^log_n bench-style points: (args, cfg, (px, py, sl)) with args =
    (digits, negm, rows, lanes), cfg `select_config`'s row (or the one
    given) with the scan lanes set, and the input limb tensors."""
    from tpu_msm_torch.benches.dispatch_benchmark import tiled_inputs
    from tpu_msm_torch.ops import pippenger
    from tpu_msm_torch.ops.curve import AffinePoint
    from tpu_msm_torch.utils.config import select_config

    device = interop.resolve_device(device)
    n = 1 << log_n
    px, py, sl, _ = tiled_inputs(n)
    px, py, sl = interop.limbs_to_device(px, py, sl, device)
    cfg = cfg or select_config(n, device)
    cfg, _, digits, negm, rows = pippenger.scan_operands(
        AffinePoint(px, py), sl, cfg)
    w, n_pad = digits.shape
    g = pippenger.window_group_size(w, n_pad, device)
    args = (digits[:g], None if negm is None else negm[:g], rows,
            cfg.scan_lanes)
    return args, cfg, (px, py, sl)


def find_run(names: list, run: list) -> int:
    """Where `run` first occurs in `names` as a contiguous run, each name
    taken as the port's kernel it names (`trace.kernel_name`: the radix
    sort's last pass is another instance where msm_device asks for no
    sorted keys), else as itself; raises if it does not."""
    from tpu_msm_torch.cli import trace

    def key(name):
        kernel = trace.kernel_name(name)
        return name if kernel == "torch" else kernel

    names, run = [key(n) for n in names], [key(n) for n in run]
    for i in range(len(names) - len(run) + 1):
        if names[i:i + len(run)] == run:
            return i
    raise RuntimeError(f"sort (b): the call's {len(run)} device events do "
                       "not occur as a run in msm_device's trace")


def split(rows) -> dict:
    """{part: device ms} of `trace.launching_ops` rows, each row's part its
    op's PARTS value ("other_ms" for any other op), every part present."""
    out = dict.fromkeys([*PARTS.values(), "other_ms"], 0.0)
    for _, _, ms, op in rows:
        out[PARTS.get(op, "other_ms")] += ms
    return out


def main_path_sort(log_n: int = 20, repeats: int = 3, device=None, cfg=None,
                   outputs: dict | None = None) -> dict:
    """Part (b) (module docstring), one JSON line. Where `outputs` is a
    dict it receives "args", "cfg", "inputs" (main_path_operands) and
    "result" (one `_sorted_scan_inputs` call's (sorted digits, sgx, sgy))."""
    import tpu_msm_torch
    from tpu_msm_torch.cli import trace
    from tpu_msm_torch.ops import pippenger, sort

    device = interop.resolve_device(device)
    args, cfg, inputs = main_path_operands(log_n, device, cfg)
    digits, _, _, lanes = args
    g, n_pad = digits.shape
    steps = n_pad // lanes
    bits = sort.key_bits(cfg.buckets_per_window())

    def call():
        return pippenger._sorted_scan_inputs(*args, key_bits=bits)

    rec = {"bench": "sort", "part": "b", "log_n": log_n, "n": 1 << log_n,
           "windows": g, "n_pad": n_pad, "lanes": lanes, "steps": steps,
           "window_bits": cfg.window_bits, "key_bits": bits,
           "signed_digits": cfg.signed_digits, "repeats": repeats,
           "ms": median_ms(call, device, repeats)}
    if outputs is not None:
        outputs.update(args=args, cfg=cfg, inputs=inputs, result=call())
    if device.type == "cuda":
        parts = trace.launching_ops(trace.trace_events(call, host=True))
        rec.update(split(parts), device_events=len(parts))
        events = trace.trace_events(
            lambda: tpu_msm_torch.msm_device(*inputs, cfg))
        dev = trace.device_events(events)
        # msm_device launches no layout: the rest of the call's events.
        run = [p for p in parts if PARTS.get(p[3]) != "layout_ms"]
        i = find_run([e["name"] for e in dev], [p[0] for p in run])
        # The same events inside msm_device, with that profile's times.
        inside = [(p[0], p[1], float(e.get("dur", 0)) / 1e3, p[3])
                  for p, e in zip(run, dev[i:])]
        prof = trace.summarize(events)
        torch_ms, torch_launches = prof["kernels"]["torch"]
        # torch's own kernels of the call (none of the sort's own).
        kernels_ms = sum(ms for name, cat, ms, _ in inside if cat == "kernel"
                         and trace.kernel_name(name) == "torch")
        rec.update(in_msm_device=split(inside),
                   msm_device_layout_launches=sum(
                       trace.kernel_name(e["name"]) == "scan_layout_kernel"
                       for e in dev),
                   msm_device_torch_ms=torch_ms,
                   msm_device_torch_launches=torch_launches,
                   msm_device_busy_ms=prof["busy_ms"],
                   share_of_torch=kernels_ms / torch_ms)
    return emit(rec, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-sizes", type=int, nargs="*",
                    default=list(LOG_SIZES))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--main-log-size", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    payload_sort(args.log_sizes, args.repeats, args.device)
    main_path_sort(args.main_log_size, args.repeats, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
