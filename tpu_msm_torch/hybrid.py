"""MSM split between the card and the native C++ CPU engine (counterpart of
`tpu_msm/hybrid.py:33-88`, itself the Rust reference's `gpu_with_cpu`).

The input is split by a size-dependent share: the first part runs the
device pipeline (`msm_device`), the rest the native engine
(`bindings/native.msm`) on a host thread started first. The native call is
a ctypes call, which releases the GIL, so the thread computes while this
one launches the device pipeline; reading the device result back is the
join. The two partial points are added on the host (`utils/oracle.ec_add`).

`msm_best` does not route here: the profiler CLI's `hybrid` mode and the
smoke run's hybrid phase measure it on the card.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

Affine = Optional[Tuple[int, int]]


def device_share(n: int) -> float:
    """The reference's split ladder (`msm.rs:377-383`): the device takes
    2/3 of n points at >= 2^20, 1/2 at >= 2^18, else 1/3."""
    if n >= 1 << 20:
        return 2 / 3
    if n >= 1 << 18:
        return 1 / 2
    return 1 / 3


def msm_hybrid(px, py, scalars, cfg=None, share: float | None = None,
               device=None) -> Affine:
    """MSM over (16, N) uint32 limb arrays (Montgomery points, standard-form
    scalars), the first max(1, int(N · share)) points on `device` (None
    means "cuda") and the rest on the native engine. share defaults to
    device_share(N), and is 1.0 when the native engine is not available.
    cfg configures the device part (select_config of its size when None).
    Returns the affine result; a failure of the CPU part is re-raised here
    as RuntimeError."""
    from tpu_msm_torch import msm_device
    from tpu_msm_torch.bindings import native
    from tpu_msm_torch.utils import interop, oracle
    from tpu_msm_torch.utils.config import select_config

    dev = interop.resolve_device(device)
    px, py, scalars = (np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
                       for a in (px, py, scalars))
    n = px.shape[1]
    if n == 0:
        return None
    if not native.available():
        share = 1.0
    if share is None:
        share = device_share(n)
    split = max(1, min(n, int(n * share)))

    cpu_result: list = [None]
    cpu_error: list = [None]

    def cpu_part():  # runs while the card computes its part
        try:
            if split < n:
                cpu_result[0] = native.msm(px[:, split:], py[:, split:],
                                           scalars[:, split:])
        except Exception as e:  # re-raised on the caller's thread below:
            # a lost CPU partial would give a wrong result, not an error.
            cpu_error[0] = e

    thread = threading.Thread(target=cpu_part)
    thread.start()
    try:
        res = msm_device(*interop.limbs_to_device(
            px[:, :split], py[:, :split], scalars[:, :split], dev),
            cfg or select_config(split, dev))
        [dev_pt] = interop.proj_limbs_to_affine_points(
            *(interop.tensor_to_limbs(a) for a in res))
    finally:
        thread.join()
    if cpu_error[0] is not None:
        raise RuntimeError("hybrid MSM: the CPU part failed") from cpu_error[0]
    return oracle.ec_add(dev_pt, cpu_result[0])
