"""Measured autotuning of the pipeline knobs on the card (counterpart of
`tpu_msm/utils/autotune.py`).

The knobs are swept on the device, the measurements are merged into a JSON
table beside this module (`tuned_configs.json`, committed), and
`utils.config.select_config` consults that table by (device type, log size)
before it falls back to the size heuristic. Rows are keyed by "cuda"; every
measurement names the card and its power limit.

    python -m tpu_msm_torch.utils.autotune --log-sizes 16 18 20 --repeats 3
    python -m tpu_msm_torch.utils.autotune --show

The sweep needs a CUDA device and raises without one. Its inputs are
`utils.preprocess.generate_msm_instances(log_size, 1)`, made in memory.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

TABLE_PATH = Path(__file__).with_name("tuned_configs.json")
PLATFORM = "cuda"

# The JAX package's space (`autotune.py:33-39`) without field_impl (the
# port has one field core), plus GLV, which needs signed digits.
DEFAULT_SPACE = {
    "window_bits": [8, 16],
    "scan_lanes": [2048, 4096, 8192],
    "reduce_fanout": [1024, 2048, 4096],
    "signed_digits": [False, True],
    "glv": [False, True],
}

_KNOBS = ("window_bits", "scan_lanes", "reduce_fanout", "signed_digits",
          "segment_starts", "glv")

# (path, mtime, parsed): lookup() sits on the dispatch path of every MSM
# through select_config, so the JSON is parsed again only when it changes.
_table_cache: tuple = (None, None, None)


def load_table() -> dict:
    """The table, or {} when it is missing; a corrupt table gives a warning
    and {}, so that select_config falls back to the heuristic."""
    global _table_cache
    path = TABLE_PATH
    if not path.exists():
        return {}
    mtime = path.stat().st_mtime_ns
    if _table_cache[:2] != (path, mtime):
        try:
            with open(path) as f:
                parsed = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            print(f"autotune: ignoring unreadable {path}: {e}",
                  file=sys.stderr)
            parsed = {}
        _table_cache = (path, mtime, parsed)
    return _table_cache[2]


def _write_table(table: dict) -> None:
    """Atomic write (a temporary file, then os.replace): an interrupted
    sweep never leaves a truncated table."""
    tmp = TABLE_PATH.with_name(TABLE_PATH.name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, TABLE_PATH)


def lookup(n: int, platform: str = PLATFORM) -> Optional[dict]:
    """The best measured knobs for n points on `platform`, from the row of
    the nearest log size within +-1, or None."""
    rows = load_table().get(platform)
    if not rows:
        return None
    logn = max(1, (n - 1).bit_length())
    best_key = None
    for key in rows:
        dist = abs(int(key) - logn)
        if dist <= 1 and (best_key is None
                          or dist < abs(int(best_key) - logn)):
            best_key = key
    return rows[best_key]["best"] if best_key is not None else None


def measure(log_size: int, cfg_kwargs: dict, repeats: int = 3,
            inputs=None) -> float:
    """Median wall seconds of one `msm_device` at 2^log_size on the card,
    inputs resident there, each run ended by torch.cuda.synchronize(),
    after one warm-up run. `inputs`: (px, py, scalars) tensors on the card,
    made from the fixture generator when None."""
    import torch

    from tpu_msm_torch import msm_device
    from tpu_msm_torch.utils import interop, preprocess
    from tpu_msm_torch.utils.config import MsmConfig
    from tpu_msm_torch.utils.profiling import require_card

    dev = require_card("the autotune sweep")
    cfg = MsmConfig(**cfg_kwargs)
    if inputs is None:
        [inst] = preprocess.generate_msm_instances(log_size, 1)
        inputs = interop.limbs_to_device(inst.px, inst.py, inst.scalars, dev)
    msm_device(*inputs, cfg)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        msm_device(*inputs, cfg)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _merge_row(rows: dict, log_size: int, result: dict) -> None:
    """Merge one measurement into rows[log_size], keyed by its knob values,
    so that sweeps over different knobs compose: best = argmin over the
    union."""
    def key(r):
        return tuple(sorted((k, v) for k, v in r.items() if k in _KNOBS))

    prior = rows.get(str(log_size), {}).get("measurements", [])
    seen = {key(r): r for r in prior}
    seen[key(result)] = result
    merged = sorted(seen.values(), key=lambda r: r["seconds"])
    rows[str(log_size)] = {
        "best": {k: merged[0][k] for k in _KNOBS if k in merged[0]},
        "measurements": merged,
    }


def combos(space: Dict[str, list], n: int):
    """The knob combinations of `space` worth measuring at n points: GLV
    only with signed digits, and no more lanes than n / 2."""
    keys = list(space)
    for values in itertools.product(*(space[k] for k in keys)):
        kw = dict(zip(keys, values))
        if kw.get("glv") and not kw.get("signed_digits"):
            continue
        if kw.get("scan_lanes", 0) * 2 > n:
            continue
        yield kw


def sweep(log_sizes: List[int], space: Dict[str, list] = None,
          repeats: int = 3, verbose: bool = True) -> dict:
    """Measure every combination at every log size, merging each into the
    table and writing it to disk after each one, so an interrupted sweep
    keeps what it measured."""
    from tpu_msm_torch.utils import interop, preprocess
    from tpu_msm_torch.utils.profiling import card, require_card

    space = space or DEFAULT_SPACE
    dev = require_card("the autotune sweep")
    where = card()
    table = load_table()
    rows = table.setdefault(PLATFORM, {})
    for log_size in log_sizes:
        n = 1 << log_size
        [inst] = preprocess.generate_msm_instances(log_size, 1)
        inputs = interop.limbs_to_device(inst.px, inst.py, inst.scalars, dev)
        for kw in combos(space, n):
            try:
                t = measure(log_size, kw, repeats, inputs)
            except Exception as e:  # out of memory, an unsupported combo
                if verbose:
                    print(f"  2^{log_size} {kw}: FAILED ({type(e).__name__}: "
                          f"{e})", flush=True)
                continue
            _merge_row(rows, log_size, {**kw, "seconds": t,
                                        "points_per_s": n / t,
                                        "repeats": repeats, "card": where})
            _write_table(table)
            if verbose:
                print(f"  2^{log_size} {kw}: {t * 1e3:.3f} ms "
                      f"({n / t / 1e6:.3f} Mpts/s)", flush=True)
        del inputs
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-sizes", type=int, nargs="+", default=[16, 18, 20])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--show", action="store_true",
                    help="print the current table and exit")
    args = ap.parse_args(argv)
    if args.show:
        json.dump(load_table(), sys.stdout, indent=1, sort_keys=True)
        print()
        return 0
    sweep(args.log_sizes, repeats=args.repeats)
    print(f"table written to {TABLE_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
