"""The port's benchmarks (each a `python -m tpu_msm_torch.benches.<name>`
script) and what the micro-benches share: one JSON line a measurement with
the card's name and power limit, and one call's time on the device it ran
on."""

from __future__ import annotations

import json
import time

import torch


def emit(rec: dict, device, machine=None) -> dict:
    """Print `rec` as one JSON line with the device it ran on and, where
    the run is on a card (`machine`, by default `device`), the card's name
    and power limit (`profiling.card()`; null on the CPU). Returns the
    line's object."""
    from tpu_msm_torch.utils import profiling

    on_card = torch.device(machine or device).type == "cuda"
    out = {**rec, "device": str(torch.device(device)),
           "card": profiling.card() if on_card else None}
    print(json.dumps(out), flush=True)
    return out


def call_ms(fn, device) -> float:
    """One call of fn in ms: by CUDA events on a card (the device's time
    from the call's first launch to its last kernel's end), by the host
    clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
