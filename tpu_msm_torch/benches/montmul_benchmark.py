"""Montgomery-multiply throughput microbenchmark of the port's field core on
the card (counterpart of `benches/montmul_benchmark.py`).

Times the `montmul_chain` kernel (`csrc/montmul.cu`): per lane, `steps` x
`chain` dependent Montgomery products on each of `ilp` independent chains,
the accumulator in registers throughout. The port has one field core, the
CIOS core of `csrc/bn254.cuh`, so the output has one entry, "cios", with
the JAX script's keys, beside the card's name and power limit:

    python -m tpu_msm_torch.benches.montmul_benchmark --lanes 65536 \\
        --chain 64 --steps 8 --iters 3 [--ilp 4] [--sass]

`roofline_per_s` is the H100 model of `utils/profiling.py` (the multiply
pipe's issue slots a product at 64 lanes a clock per SM). `--sass` also
prints the instructions that `cuobjdump -sass` finds in the kernel at ilp
1 and ilp 2 (their difference is what one more product costs, by kind:
wide, hi, narrow, .X, .MOV) and what the measured rate asks of the
multiply pipe and of the schedulers (`pipe_rates`). Needs a CUDA device
and raises without one.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch


def inputs(lanes: int, device) -> torch.Tensor:
    """The JAX script's inputs: RandomState(11), min(lanes, 128) values
    below P, tiled to (16, lanes) int32 u16 rows on `device`."""
    from tpu_msm_torch.models import bn254
    from tpu_msm_torch.utils import interop

    rng = np.random.RandomState(11)
    vals = [int.from_bytes(rng.bytes(32), "little") % bn254.P
            for _ in range(min(lanes, 128))]
    x = np.tile(interop.ints_to_limbs(vals), -(-lanes // len(vals)))[:, :lanes]
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)


def run(lanes: int = 65536, chain: int = 64, steps: int = 8, iters: int = 3,
        ilp: int = 1) -> dict:
    """Median seconds of one kernel launch by CUDA events after a warm-up,
    and the rate: lanes x chain x steps x ilp products over it."""
    from tpu_msm_torch.ops import cuda_curve
    from tpu_msm_torch.utils import profiling

    dev = profiling.require_card("the montmul benchmark")
    x = inputs(lanes, dev)
    cuda_curve.montmul_chain(x, x, chain, steps, ilp)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cuda_curve.montmul_chain(x, x, chain, steps, ilp)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    sec = sorted(times)[len(times) // 2]
    rate = lanes * chain * steps * ilp / sec
    peak = profiling.mont_mul_bound_per_s(dev)
    return {"cios": {"mont_mul_per_s": rate, "seconds": sec,
                     "roofline_per_s": peak,
                     "ratio_to_roofline": peak / rate},
            "lanes": lanes, "chain": chain, "steps": steps, "ilp": ilp,
            "card": profiling.card()}


# An instruction line of `cuobjdump -sass`: its address, an optional
# predicate, then the mnemonic with its modifiers.
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)")
_KERNELS = (("ilp1", "montmul_chain_kernelILi1E"),
            ("ilp2", "montmul_chain_kernelILi2E"))
# The integer multiply pipe's instructions by kind: wide (.WIDE, a 32 x 32
# -> 64 product, with or without the carry in), hi (.HI, the high half), x
# (IMAD.X, a narrow multiply-add with the carry in), mov (IMAD.MOV, a move
# the compiler puts on the multiply pipe) and narrow (the rest: IMAD,
# IMAD.SHL, IMAD.IADD, IMUL).
IMAD_KINDS = ("wide", "hi", "narrow", "x", "mov")


def imad_kind(op: str):
    """The kind of an IMAD-family mnemonic (IMAD_KINDS), else None."""
    if not op.startswith(("IMAD", "IMUL")):
        return None
    mods = op.split(".")[1:]
    for mod, kind in (("WIDE", "wide"), ("HI", "hi"), ("MOV", "mov"),
                      ("X", "x")):
        if mod in mods:
            return kind
    return "narrow"


def sass_counts() -> dict:
    """The instructions of montmul_chain_kernel in the built library, by
    `cuobjdump -sass`: "ilp1" and "ilp2" ({mnemonic: count} of the
    IMAD family), "per_product" (ilp 2 minus ilp 1: one product's IMAD
    family by mnemonic), "per_product_kinds" (the same by IMAD_KINDS) and
    "per_product_all" (every mnemonic of one product, the carry chains'
    IADD3 among them)."""
    from tpu_msm_torch import _build

    _build.load()
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build.LIB_PATH)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = next((tag for tag, mangled in _KERNELS if mangled in line),
                      None)
            continue
        m = _INSN.search(line)
        if fn and m:
            counts.setdefault(fn, Counter())[m.group(1)] += 1
    if set(counts) != {"ilp1", "ilp2"}:
        raise RuntimeError("montmul_chain_kernel not found in the SASS")
    per = counts["ilp2"] - counts["ilp1"]
    kinds = Counter({k: 0 for k in IMAD_KINDS})
    for op, k in per.items():
        if imad_kind(op):
            kinds[imad_kind(op)] += k

    def imad(c):
        return {op: k for op, k in c.items() if imad_kind(op)}

    return {"ilp1": imad(counts["ilp1"]), "ilp2": imad(counts["ilp2"]),
            "per_product": imad(per), "per_product_kinds": dict(kinds),
            "per_product_all": dict(per)}


def pipe_rates(mont_mul_per_s: float, sass: dict, sms: int,
               clock_hz: float) -> dict:
    """What a measured product rate asks of the card, per SM clock: the
    multiply pipe's warp instructions (one product's IMAD family from
    `sass`) counting a wide or hi IMAD as one issue slot and as two,
    against the pipe's ceiling of IMAD_PER_CLOCK_PER_SM / 32 slots; and all
    of one product's instructions against the four schedulers' issue (one
    warp instruction a clock each). A slot count whose rate passes its
    ceiling is refuted by the measurement."""
    from tpu_msm_torch.utils import profiling

    kinds = sass["per_product_kinds"]
    one = sum(kinds.values())
    two = one + kinds["wide"] + kinds["hi"]
    per_clock = mont_mul_per_s / (sms * clock_hz) / 32
    return {"products_per_sm_clock": per_clock * 32,
            "imad_slots_if_wide_is_1": per_clock * one,
            "imad_slots_if_wide_is_2": per_clock * two,
            "imad_ceiling": profiling.IMAD_PER_CLOCK_PER_SM / 32,
            "issue": per_clock * sum(sass["per_product_all"].values()),
            "issue_ceiling": 4.0, "sms": sms, "clock_hz": clock_hz}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=65536)
    ap.add_argument("--chain", type=int, default=64,
                    help="dependent products per step")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--ilp", type=int, default=1,
                    help="independent chains per lane (1 = one dependent "
                         "chain)")
    ap.add_argument("--sass", action="store_true",
                    help="also count the kernel's instructions and what "
                         "the rate asks of the multiply pipe")
    args = ap.parse_args(argv)
    out = run(args.lanes, args.chain, args.steps, args.iters, args.ilp)
    c = out["cios"]
    print(f"cios: {c['mont_mul_per_s'] / 1e9:.3f} G mont-mul/s "
          f"({c['ratio_to_roofline']:.3f}x off the model's "
          f"{c['roofline_per_s'] / 1e9:.3f} G/s) on {out['card']}",
          flush=True)
    if args.sass:
        from tpu_msm_torch.utils import profiling

        out["sass"] = sass_counts()
        out["pipe"] = pipe_rates(c["mont_mul_per_s"], out["sass"],
                                 profiling.sm_count(),
                                 profiling.sm_clock_hz())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
