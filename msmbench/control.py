"""The readings that the limits of `correct` are set from, on the card at a
cell's own size:

    python -m msmbench.control --workload msm-2p20-uniform --seconds 1 \\
        --seeds 11 12 ... --control-seeds 21 22 23

For each of `--seeds`, one run of the cell with the program (`run.run_cell`,
a window of `--seconds`): its numbers compared are the lower readings. For
each of `--control-seeds`, one run with the control in the program's place:
the reference itself, in the nearest "precision" below the configuration's,
which states exact MSMs of scalars below r: every scalar cut to its low 240
bits (its top 16-bit window left out), the step that would tempt a later
change. Its numbers compared are the upper readings. One JSON line a run.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_entry(entry, sets, bases, work):
    """The control in the program's place: the reference's MSM over the
    scalars' low 15 limbs, worked out once a set (a set placed on the host
    is read on the index's device)."""
    from msmbench import reference
    from msmbench.traffic import to_card

    index = work.index()
    answers = {}

    def call(k):
        if k not in answers:
            plain, weighted = reference.limb_sums(
                to_card(sets[k], index.device), index)
            answers[k] = reference.expected(plain, weighted, work.step_log,
                                            limbs=reference.LIMBS - 1)
        return answers[k]

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from msmbench.run import run_cell, set_cache_dirs
    from msmbench.spec import ROOT, Bench

    set_cache_dirs(str(ROOT))
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    runs = ([(s, "program", None) for s in args.seeds]
            + [(s, "control", control_entry) for s in args.control_seeds])
    for seed, side, fault in runs:
        out = run_cell(bench, cell, seed, args.seconds, False, args.device,
                       time.perf_counter(), entry_fault=fault)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
