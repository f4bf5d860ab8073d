"""The wire conversions of `utils/interop.py`, timed at 2^20 (counterpart of
the root `benches/conversion_benchmark.py`).

    python -m tpu_msm_torch.benches.conversion_benchmark [--log-size 20]
        [--iters 5] [--device cuda|cpu]

The four conversions of the JAX script on its inputs (`RandomState(0)`,
`rng.bytes(32 * n)`, read as (n, 16) little-endian u16 limbs): halo2curves'
(n, 32) bytes -> (16, n) limbs (`from_h2c_bytes`) and back
(`to_h2c_bytes`), limbs -> arkworks' (n, 8) big-endian u32 limbs
(`to_ark_u32_limbs`) and back (`from_ark_u32_limbs`). Each is called once,
then timed as the mean of `--iters` calls on the host clock, as the JAX
script's `bench()` does.

Then the path a C ABI call takes (`bindings/embed.msm_best_wire`): three
`from_h2c_bytes` calls, on the scalars' (n, 32) bytes and on the two
strided (n, 32) halves of the points' (n, 2, 32) view (n·64 more bytes
from the same generator), each timed alone and the three together. For
each of the three, the function's steps are timed apart as well: the
contiguous copy of its input, the copy of the transpose to (16, n) u16
limbs and the widening `astype` to uint32.

One JSON line a measurement (ms, Melem/s), with the card's name and power
limit. The conversions are numpy on the host, so `--device` moves no work:
it says which machine the line describes, and the default, the card,
raises where there is none, like the port's other entry points.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from tpu_msm_torch.benches import emit
from tpu_msm_torch.models.bn254 import LIMBS
from tpu_msm_torch.utils import interop


SEED = 0  # the JAX script's RandomState(0)


def inputs(n: int):
    """The JAX script's inputs and the C ABI path's: (raw, limbs, points).
    raw: n·32 bytes; limbs: the (16, n) uint32 limbs they hold; points:
    n·64 more bytes, drawn after raw."""
    rng = np.random.RandomState(SEED)
    raw = rng.bytes(32 * n)
    limbs = np.frombuffer(raw, dtype="<u2").reshape(n, LIMBS).T.astype(
        np.uint32)
    return raw, np.ascontiguousarray(limbs), rng.bytes(64 * n)


def bench(fn, iters: int) -> float:
    """One call of fn, then the mean of `iters` calls, in ms (the JAX
    script's `bench`, which prints instead)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def wire_arrays(scalars: bytes, points: bytes):
    """The three (n, 32) byte arrays `msm_best_wire` converts: the
    scalars, then the points' x and y halves (strided views)."""
    n = len(scalars) // 32
    pxy = np.frombuffer(points, np.uint8).reshape(n, 2, 32)
    return {"scalars": np.frombuffer(scalars, np.uint8).reshape(n, 32),
            "points x": pxy[:, 0], "points y": pxy[:, 1]}


def from_h2c_steps(data, iters: int) -> dict:
    """`from_h2c_bytes`'s three steps on one (n, 32) array, each timed
    apart (ms): the contiguous copy (none for a contiguous input), the
    copy of the transpose and the widening to uint32."""
    contiguous = np.ascontiguousarray(data)
    limbs16 = contiguous.view("<u2").reshape(-1, LIMBS)
    transposed = np.ascontiguousarray(limbs16.T)
    return {"contiguous_ms": bench(lambda: np.ascontiguousarray(data),
                                   iters),
            "transpose_ms": bench(lambda: np.ascontiguousarray(limbs16.T),
                                  iters),
            "widen_ms": bench(lambda: transposed.astype(np.uint32), iters)}


def run(log_n: int = 20, iters: int = 5, device=None):
    """Every conversion at 2^log_n (module docstring), one JSON line each.
    Returns (records, outputs): outputs maps each conversion's name to
    what it returned, and "raw", "limbs" and "points" to its inputs."""
    device = interop.resolve_device(device)
    n = 1 << log_n
    raw, limbs, points = inputs(n)
    h2c = np.frombuffer(raw, np.uint8).reshape(n, 32)
    ark = interop.to_ark_u32_limbs(limbs)
    convs = {
        "from_h2c_bytes": lambda: interop.from_h2c_bytes(h2c),
        "to_h2c_bytes": lambda: interop.to_h2c_bytes(limbs),
        "to_ark_u32_limbs": lambda: interop.to_ark_u32_limbs(limbs),
        "from_ark_u32_limbs": lambda: interop.from_ark_u32_limbs(ark),
    }
    wire = wire_arrays(raw, points)
    for name, data in wire.items():
        convs[f"from_h2c_bytes {name}"] = (
            lambda data=data: interop.from_h2c_bytes(data))
    convs["msm_best_wire's three from_h2c_bytes"] = lambda: [
        interop.from_h2c_bytes(a) for a in wire.values()]
    records, outputs = [], {"raw": raw, "limbs": limbs, "points": points}
    for name, fn in convs.items():
        outputs[name] = fn()
        ms = bench(fn, iters)
        elems = 3 * n if name.startswith("msm_best_wire") else n
        rec = {"bench": "conversion", "conversion": name, "n": n,
               "iters": iters, "ms": ms, "melem_per_s": elems / ms / 1e3}
        if name.startswith("from_h2c_bytes "):
            rec.update(from_h2c_steps(wire[name.split(" ", 1)[1]], iters))
        records.append(emit(rec, device))
    return records, outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-size", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.log_size, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
