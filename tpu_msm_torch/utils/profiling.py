"""Per-stage profiling and roofline accounting on the card (counterpart of
`tpu_msm/utils/profiling.py`).

* `time_fn(fn, *args)`: median device time of a call by CUDA events.
* `trace(path)`: a torch.profiler context (CPU and CUDA activity) that
  writes a Chrome trace.
* `profile_stages(log_n, cfg)`: the JAX package's three stages on the
  port's own functions: one window's digit sort with its coordinate
  gathers, all window sums, and `msm_device` end to end.
* `pipeline_mont_muls(n, cfg)`: the Montgomery products one MSM of the
  port's pipeline does, stage by stage.
* `roofline(log_n, cfg, kernel_rates)`: the end-to-end mont-mul rate
  against two yardsticks: `e2e_vs_kernel`, the chained microbench's
  measured rate (`benches/montmul_benchmark.py`) over it, and
  `kernel_vs_model`, the H100 model below over the microbench's rate.

The model replaces the JAX package's v5e VPU constants. One CIOS product
(`csrc/bn254.cuh` fp_mont_mul) is 8 rows of 8 wide products a_i·b_j, one
low product m and 8 wide products m·p_j: 128 wide (32 x 32 -> 64) products
and 8 low ones. The card's integer multiply pipe takes
IMAD_PER_CLOCK_PER_SM lanes an SM clock (the CUDA C++ Programming Guide's
throughput table, compute capability 9.0), and a wide product holds it for
WIDE_IMAD_SLOTS issue slots: two, as the card shows (chip_smoke.py phase 7,
`phase_bound_model`: at ilp 4 and 8 montmul_chain's rate asks 1.79-1.80
warp instructions an SM clock of a ceiling of 2 when a wide IMAD counts
two, 0.93 when it counts one, and it stops growing from ilp 4 to ilp 8;
PERF.md §7). So 264 slots a product, on every SM (read from the device),
at the SM clock's maximum (nvidia-smi's clocks.max.sm). At 132 SMs and
1980 MHz that is 16.7 T slots/s, about 63 G mont-mul/s. It is a model:
the microbench holds it to account, and a measured rate above it would
disprove it.

Every measurement here needs a CUDA device and raises without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import subprocess

import torch

log = logging.getLogger("tpu_msm_torch.profiling")

IMAD_PER_CLOCK_PER_SM = 64
WIDE_IMAD_SLOTS = 2
# The multiply pipe's slots a product: 128 wide products, 8 low ones.
CIOS_MULS_PER_MONT_MUL = WIDE_IMAD_SLOTS * 8 * 16 + 8
# RCB mixed addition (Algorithm 8): 11 Montgomery products.
MADD_MONT_MULS = 11
# RCB complete projective addition (Algorithm 7, a = 0): 12.
ADD_MONT_MULS = 12


def require_card(what: str = "profiling") -> torch.device:
    """The card, for a measurement that runs only there: raises when there
    is none, rather than measuring the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device and none is "
                           "available")
    return torch.device("cuda")


def _smi(query: str, fmt: str = "csv,noheader,nounits") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return _smi("name,power.limit", "csv,noheader")


def sm_count(device=None) -> int:
    props = torch.cuda.get_device_properties(device or require_card())
    return props.multi_processor_count


def sm_clock_hz() -> float:
    """The SM clock's maximum, from nvidia-smi (clocks.max.sm, MHz)."""
    require_card()
    return float(_smi("clocks.max.sm")) * 1e6


def mont_mul_bound_per_s(device=None) -> float:
    """The model's peak mont-mul rate: IMAD_PER_CLOCK_PER_SM x SMs x the SM
    clock over CIOS_MULS_PER_MONT_MUL."""
    return (IMAD_PER_CLOCK_PER_SM * sm_count(device) * sm_clock_hz()
            / CIOS_MULS_PER_MONT_MUL)


def time_fn(fn, *args, iters: int = 2) -> float:
    """Median seconds of fn(*args) by CUDA events, after one warm-up."""
    require_card()
    fn(*args)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return sorted(times)[len(times) // 2]


@contextlib.contextmanager
def trace(path: str):
    """torch.profiler over the block (CPU and CUDA activity); the Chrome
    trace is written to `path` at its end."""
    from torch.profiler import ProfilerActivity, profile

    require_card()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def profile_stages(log_n: int, cfg=None, seed: int = 1) -> dict:
    """Seconds of each stage of the MSM at 2^log_n points on the card:
    `sort_1window` (window 0's digits sorted, the coordinates gathered by
    the permutation), `window_sums_all` and `end_to_end` (`msm_device`).
    The inputs are `preprocess.generate_msm_instances(log_n, 1, seed)`."""
    from tpu_msm_torch import msm_device
    from tpu_msm_torch.ops import pippenger
    from tpu_msm_torch.ops.curve import AffinePoint
    from tpu_msm_torch.utils import interop, preprocess
    from tpu_msm_torch.utils.config import select_config

    dev = require_card()
    n = 1 << log_n
    if cfg is None:
        cfg = select_config(n, dev)
    [inst] = preprocess.generate_msm_instances(log_n, 1, seed=seed)
    px, py, sl = interop.limbs_to_device(inst.px, inst.py, inst.scalars, dev)

    def stage_sort(sl, px, py):
        digits = pippenger.window_digits(
            sl, dataclasses.replace(cfg, signed_digits=False))[0]
        _, perm = torch.sort(digits, stable=True)
        return px.index_select(1, perm), py.index_select(1, perm)

    results = {
        "sort_1window": time_fn(stage_sort, sl, px, py),
        "window_sums_all": time_fn(
            lambda a, b, s: pippenger.window_sums(AffinePoint(a, b), s, cfg),
            px, py, sl),
        "end_to_end": time_fn(lambda a, b, s: msm_device(a, b, s, cfg),
                              px, py, sl),
    }
    for k, v in results.items():
        log.info("%s: %.3f ms", k, v * 1e3)
    log.info("throughput: %.2f Mpoints/s", n / results["end_to_end"] / 1e6)
    return results


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def pipeline_mont_muls(n: int, cfg) -> int:
    """Montgomery products of one MSM of n points under cfg in the port's
    pipeline (ops/pippenger.py), which both routes share: per window the
    scan's n_pad mixed adds, the lane-carry scan, the m + 1 query adds, the
    fold of the X(s_b) batch to the fanout and its rolled tree, M·X(n) and
    the window's final add; then Horner's c doublings and one add per
    window joined; with GLV, one product a point for phi(x) = BETA·x, on
    2n points of 127-bit scalars."""
    extra = 0
    if cfg.glv:
        from tpu_msm_torch.ops import glv

        extra = n
        n = 2 * n
        cfg = dataclasses.replace(cfg, glv=False, scalar_bits=glv.GLV_BITS)
    w = cfg.num_windows()
    m = cfg.buckets_per_window()
    c = cfg.window_bits
    lanes = min(cfg.scan_lanes, 1 << _ceil_log2(max(n, 1)))
    n_pad = lanes * -(-n // lanes)
    fanout = 1 << (cfg.reduce_fanout.bit_length() - 1)
    m_pad = 1 << _ceil_log2(m)
    fold = m_pad if m_pad > fanout else 0
    width = min(m_pad, fanout)
    adds = (_ceil_log2(lanes) * lanes            # lane-carry scan
            + (m + 1)                            # carry + local query adds
            + fold + _ceil_log2(width) * width   # fold, then rolled tree
            + ((c - 1) if cfg.signed_digits else 2 * (c - 1))  # M·X(n)
            + 1)                                 # M·X(n) - sum X(s_b)
    horner = (w - 1) * (c + 1)
    return (extra + w * (n_pad * MADD_MONT_MULS + adds * ADD_MONT_MULS)
            + horner * ADD_MONT_MULS)


def roofline(log_n: int = 20, cfg=None, kernel_rates: dict | None = None):
    """The end-to-end mont-mul rate of `msm_device` at 2^log_n (the exact
    pipeline count over the measured time) against the H100 model
    (`ratio_to_model`), and, with `kernel_rates={"cios": rate}` from the
    microbench, `e2e_vs_kernel` (kernel rate over e2e rate) and
    `kernel_vs_model` (model over kernel rate). Returns a dict with the
    stage times and the card's name and power limit."""
    from tpu_msm_torch.utils.config import select_config

    dev = require_card()
    n = 1 << log_n
    if cfg is None:
        cfg = select_config(n, dev)
    stats = profile_stages(log_n, cfg)
    mont_muls = pipeline_mont_muls(n, cfg)
    rate = mont_muls / stats["end_to_end"]
    model = mont_mul_bound_per_s(dev)
    out = {"log_n": log_n, "config": dataclasses.asdict(cfg),
           "mont_muls": mont_muls, "mont_mul_per_s": rate,
           "model_roofline_per_s": model, "ratio_to_model": model / rate,
           **stats, "card": card()}
    log.info("e2e mont-mul rate: %.1f M/s; H100 model %.1f M/s",
             rate / 1e6, model / 1e6)
    if kernel_rates and "cios" in kernel_rates:
        kr = float(kernel_rates["cios"])
        out["kernel_mont_mul_per_s"] = kr
        out["e2e_vs_kernel"] = kr / rate
        out["kernel_vs_model"] = model / kr
        log.info("measured kernel rate %.1f M/s: e2e is %.2fx off the "
                 "kernel; the kernel is %.2fx off the model", kr / 1e6,
                 kr / rate, model / kr)
    return out
