"""`msm_device` of two or more checkouts of this repository, timed in turns
on one card.

    python -m tpu_msm_torch.benches.ab_benchmark --trees OLD NEW \\
        [--log-n 20] [--turns 3] [--calls 5]

Each tree is a directory holding a checkout of the repository, for
instance `git archive` of a commit unpacked into a git-ignored directory
(`.` is this one). The trees take turns in the order A B B A A B ...,
`--turns` times each. A turn is a child process started in its tree, so
that it imports that tree's `tpu_msm_torch` and builds that tree's kernels
there at first use: it makes bench-style inputs on the card
(`dispatch_benchmark.tiled_inputs`: bench.py's 512 points tiled to
2^log_n, seeded scalars below 2^253), runs `msm_device` with the tuned row
(`select_config`) once, then times `--calls` calls by CUDA events and
prints their median. Every tree's affine result must be the same. After
the timed calls the turn traces one more call with the host's ops (the
tree's own `cli.trace.trace_events(host=True)`), and this tree splits
torch's own kernels in it by the op that launched them
(`trace.launching_ops`, `trace.torch_ops`): `torch_ms`, `torch_launches`
and `by_op` of the turn. One JSON line per turn, then one with each
tree's medians, all with the card's name and power limit. Needs a CUDA
device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# What a turn runs, in its tree: argv = log_n, seed, calls, the file that
# takes the traced call's events.
_CHILD = r"""
import dataclasses, json, statistics, sys
import torch
import tpu_msm_torch
from tpu_msm_torch.benches.dispatch_benchmark import tiled_inputs
from tpu_msm_torch.cli.trace import trace_events
from tpu_msm_torch.utils import interop

log_n, seed, calls = (int(a) for a in sys.argv[1:4])
if not torch.cuda.is_available():
    raise SystemExit("needs a CUDA device")
dev = torch.device("cuda")
n = 1 << log_n
px, py, sl, _ = tiled_inputs(n, seed)
cfg = tpu_msm_torch.select_config(n, dev)
d = interop.limbs_to_device(px, py, sl, dev)
res = tpu_msm_torch.msm_device(*d, cfg)
[pt] = interop.proj_limbs_to_affine_points(
    *(interop.tensor_to_limbs(a) for a in res))
times = []
for _ in range(calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    tpu_msm_torch.msm_device(*d, cfg)
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
events = trace_events(lambda: tpu_msm_torch.msm_device(*d, cfg), host=True)
with open(sys.argv[4], "w") as f:
    json.dump(events, f)
print(json.dumps({"ms": statistics.median(times), "runs_ms": times,
                  "config": dataclasses.asdict(cfg),
                  "result": None if pt is None else [hex(v) for v in pt]}))
"""


def turn_order(trees, turns: int):
    """A B B A A B ...: `turns` runs of each tree, each pair of rounds
    reversed so that neither tree always goes first."""
    order = []
    for k in range(turns):
        order += trees if k % 2 == 0 else trees[::-1]
    return order


def run(trees, log_n: int = 20, turns: int = 3, calls: int = 5,
        seed: int = 1) -> dict:
    import tempfile

    from tpu_msm_torch.cli import trace
    from tpu_msm_torch.utils import profiling

    profiling.require_card("the A/B benchmark")
    card = profiling.card()
    medians = {t: [] for t in trees}
    first = None
    for tree in turn_order(list(trees), turns):
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "events.json"
            root = Path(tree).resolve()
            env = dict(os.environ, PYTHONPATH=str(root))
            proc = subprocess.run(
                [sys.executable, "-c", _CHILD, str(log_n), str(seed),
                 str(calls), str(path)],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                                   + proc.stderr[-4000:])
            events = json.loads(path.read_text())
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        torch_ms, torch_launches = trace.summarize(events)["kernels"]["torch"]
        rec.update(torch_ms=torch_ms, torch_launches=torch_launches,
                   by_op=trace.torch_ops(trace.launching_ops(events)))
        first = first or rec
        if rec["result"] != first["result"]:
            raise AssertionError(f"{tree}: result {rec['result']} differs "
                                 f"from {first['result']}")
        medians[tree].append(rec["ms"])
        print(json.dumps({"tree": tree, "log_n": log_n, **rec,
                          "card": card}), flush=True)
    out = {"log_n": log_n, "turns": turns, "calls": calls,
           "medians_ms": medians, "card": card}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    run(args.trees, args.log_n, args.turns, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
