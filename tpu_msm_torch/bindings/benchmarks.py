"""Embedder-facing benchmark entry points (counterpart of
`tpu_msm/bindings/benchmarks.py`): the device MSM and the native CPU engine
on freshly generated fixture instances, each returning milliseconds.
"""

from __future__ import annotations

import time

import torch


def _instance(log_size: int, seed: int):
    from tpu_msm_torch.utils import preprocess

    return preprocess.generate_msm_instances(log_size, 1, seed=seed)[0]


def benchmark_gpu_msm_best(log_size: int, seed: int = 42) -> float:
    """`msm_device` wall time in ms at 2^log_size points on the card, with
    the configuration `select_config` gives there: inputs placed on the
    card first, one warm-up run excluded, the timed run ended by
    torch.cuda.synchronize(). Raises without a card."""
    from tpu_msm_torch import msm_device
    from tpu_msm_torch.utils import interop
    from tpu_msm_torch.utils.config import select_config
    from tpu_msm_torch.utils.profiling import require_card

    dev = require_card("benchmark_gpu_msm_best")
    inst = _instance(log_size, seed)
    cfg = select_config(inst.size, dev)
    px, py, sl = interop.limbs_to_device(inst.px, inst.py, inst.scalars, dev)
    msm_device(px, py, sl, cfg)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    msm_device(px, py, sl, cfg)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def benchmark_cpu_msm_best(log_size: int, seed: int = 42) -> float:
    """The native C++ engine's MSM wall time in ms at 2^log_size points."""
    from tpu_msm_torch.bindings import native

    inst = _instance(log_size, seed)
    t0 = time.perf_counter()
    native.msm(inst.px, inst.py, inst.scalars)
    return (time.perf_counter() - t0) * 1e3
