"""The Python half of the port's C ABI (counterpart of
`tpu_msm/bindings/embed.py`).

`csrc/tpu_msm_torch_embed.cpp` is a C library that embeds CPython and calls
this module, so a C, C++, Swift or Rust host reaches the MSM through the
same ABI as the JAX package's (`tpu_msm_init` / `tpu_msm_best` /
`tpu_msm_benchmark`); a host switches by linking the other library.

Wire formats (little-endian, halo2curves' byte layout):

* scalars: n * 32 bytes, standard form, value < r;
* points: n * 64 bytes, affine (x, y) in Montgomery form; (0, 0) is the
  point at infinity;
* result: 64 bytes, affine (x, y) in standard form; (0, 0) is infinity.

`device` is where the MSM runs, None meaning "cuda": without a card the
call raises, and the C ABI returns its error code. It never runs on the
CPU instead.
"""

from __future__ import annotations

import time

import numpy as np

from tpu_msm_torch.utils import interop


def msm_best_wire(scalars: bytes, points: bytes, device=None) -> bytes:
    """`tpu_msm_torch.msm_best` on wire-format bytes (the backend of the C
    ABI's `tpu_msm_best`): n*32 bytes of scalars, n*64 bytes of points;
    returns the 64 bytes of the affine result."""
    import tpu_msm_torch

    if len(scalars) % 32 or len(points) % 64:
        raise ValueError("scalars must be n*32 bytes, points n*64 bytes")
    n = len(scalars) // 32
    if len(points) != 64 * n:
        raise ValueError(f"{n} scalars but {len(points) // 64} points")
    dev = interop.resolve_device(device)
    if n == 0:
        return bytes(64)
    sl = interop.from_h2c_bytes(np.frombuffer(scalars, np.uint8).reshape(n, 32))
    pxy = np.frombuffer(points, np.uint8).reshape(n, 2, 32)
    px = interop.from_h2c_bytes(pxy[:, 0])
    py = interop.from_h2c_bytes(pxy[:, 1])
    res = tpu_msm_torch.msm_best(sl, (px, py), device=dev)
    if res is None:
        return bytes(64)
    x, y = res
    return x.to_bytes(32, "little") + y.to_bytes(32, "little")


def benchmark_msm_best(log_n: int = 16, iters: int = 1, device=None) -> float:
    """Mean milliseconds of `msm_best` over `iters` calls on the fixture
    instance of 2^log_n points (`preprocess.get_or_create_msm_instances`),
    after one call that is not timed; the C ABI's `tpu_msm_benchmark`."""
    import tpu_msm_torch
    from tpu_msm_torch.utils import preprocess

    dev = interop.resolve_device(device)
    [inst] = preprocess.get_or_create_msm_instances(log_n, 1)
    tpu_msm_torch.msm_best(inst.scalars, (inst.px, inst.py), device=dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        tpu_msm_torch.msm_best(inst.scalars, (inst.px, inst.py), device=dev)
    return (time.perf_counter() - t0) / max(iters, 1) * 1e3
