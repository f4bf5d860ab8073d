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
first group of windows (`pippenger.scan_operands`, `window_group_size`).
The whole call is timed as in (a). On the card one call is then profiled
(`cli.trace`, with the host's ops) and its device time split by the op
that launched each kernel: `aten::sort`, the `tpu_msm_torch::scan_layout`
operator (the scan_layout kernel, which gathers the sorted points' rows
into the scan's layout), and the rest. Then one `msm_device` call at the
same inputs is profiled: the call's kernels, found there as the same run
of names, give the same split inside msm_device, and the call's own torch
kernels (the sort's) give their share of torch's own kernels' device ms
in that profile.

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
PARTS = {"aten::sort": "sort_ms", "tpu_msm_torch::scan_layout": "layout_ms"}


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


def call_parts(events) -> list:
    """The device events of a trace taken with the host's ops, in order:
    [(name, cat, ms, part)], part the PARTS value of the outermost op
    whose host span holds the op that launched the event ("other_ms" for
    any other op). The launching op is the one with the event's External
    id, else the runtime call with its correlation."""
    from tpu_msm_torch.cli import trace

    ops = sorted(((float(e["ts"]), -float(e.get("dur", 0)), e) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"),
                 key=lambda o: o[:2])
    by_ext = {e["args"]["External id"]: float(e["ts"]) for *_, e in ops
              if "External id" in e.get("args", {})}
    by_corr = {e["args"]["correlation"]: float(e["ts"]) for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    out = []
    for e in trace.device_events(events):
        a = e.get("args", {})
        ts = by_ext.get(a.get("External id"), by_corr.get(a.get("correlation")))
        if ts is None:
            raise RuntimeError(f"sort (b): no host op launched {e['name']!r} "
                               "in the trace")
        outer = next((o for t, d, o in ops if t <= ts <= t - d), None)
        part = PARTS.get(outer and outer["name"], "other_ms")
        out.append((e["name"], e["cat"], float(e.get("dur", 0)) / 1e3, part))
    return out


def find_run(names: list, run: list) -> int:
    """Where `run` first occurs in `names` as a contiguous run; raises if it
    does not."""
    for i in range(len(names) - len(run) + 1):
        if names[i:i + len(run)] == run:
            return i
    raise RuntimeError(f"sort (b): the call's {len(run)} device events do "
                       "not occur as a run in msm_device's trace")


def split(parts) -> dict:
    """{part: device ms} of call_parts' rows, every PARTS key present."""
    out = dict.fromkeys([*PARTS.values(), "other_ms"], 0.0)
    for _, _, ms, part in parts:
        out[part] += ms
    return out


def main_path_sort(log_n: int = 20, repeats: int = 3, device=None, cfg=None,
                   outputs: dict | None = None) -> dict:
    """Part (b) (module docstring), one JSON line. Where `outputs` is a
    dict it receives "args", "cfg", "inputs" (main_path_operands) and
    "result" (one `_sorted_scan_inputs` call's (sorted digits, sgx, sgy))."""
    import tpu_msm_torch
    from tpu_msm_torch.cli import trace
    from tpu_msm_torch.ops import pippenger

    device = interop.resolve_device(device)
    args, cfg, inputs = main_path_operands(log_n, device, cfg)
    digits, _, _, lanes = args
    g, n_pad = digits.shape
    steps = n_pad // lanes

    def call():
        return pippenger._sorted_scan_inputs(*args)

    rec = {"bench": "sort", "part": "b", "log_n": log_n, "n": 1 << log_n,
           "windows": g, "n_pad": n_pad, "lanes": lanes, "steps": steps,
           "window_bits": cfg.window_bits,
           "signed_digits": cfg.signed_digits, "repeats": repeats,
           "ms": median_ms(call, device, repeats)}
    if outputs is not None:
        outputs.update(args=args, cfg=cfg, inputs=inputs, result=call())
    if device.type == "cuda":
        parts = call_parts(trace.trace_events(call, host=True))
        rec.update(split(parts), device_events=len(parts))
        events = trace.trace_events(
            lambda: tpu_msm_torch.msm_device(*inputs, cfg))
        dev = trace.device_events(events)
        i = find_run([e["name"] for e in dev], [p[0] for p in parts])
        # The same events inside msm_device, with that profile's times.
        inside = [(p[0], p[1], float(e.get("dur", 0)) / 1e3, p[3])
                  for p, e in zip(parts, dev[i:])]
        prof = trace.summarize(events)
        torch_ms, torch_launches = prof["kernels"]["torch"]
        # torch's own kernels of the call (the sort's; not scan_layout's).
        kernels_ms = sum(ms for name, cat, ms, _ in inside if cat == "kernel"
                         and trace.kernel_name(name) == "torch")
        rec.update(in_msm_device=split(inside),
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
