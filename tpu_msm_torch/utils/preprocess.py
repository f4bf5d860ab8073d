"""MSM instance fixtures: generate, save, load, and cache on disk.

A copy of `tpu_msm/utils/preprocess.py` that imports no jax: the same npz
format, cache directory and seed, so a fixture written by either package
loads in the other and one seed gives identical arrays. Instances are
(16, n) uint32 limb arrays in a single compressed `.npz` per workload,
cached under `~/.tpu_msm/msm_vecs` (override with TPU_MSM_CACHE_DIR).
Counterpart of the Rust reference's `src/utils/preprocess.rs:25-212`.

Point generation differs by design: the reference asks arkworks/halo2curves
for random group elements (preprocess.rs:113-138); we derive them as an
additive walk from the generator — `base + i*step` — which is uniform enough
for benchmarking, needs only n oracle EC adds (no per-point scalar mul), and
is reproducible from the seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from tpu_msm_torch.models import bn254
from tpu_msm_torch.utils import interop, oracle


class HarnessError(Exception):
    """Fixture-layer failure (reference: HarnessError, preprocess.rs:11-21)."""


@dataclass
class MsmInstance:
    """One MSM workload: (16, n) limb arrays. Points are Montgomery affine
    coordinates; scalars standard form. (Reference: MsmInstance {points,
    scalars}, preprocess.rs:25-28.)"""

    px: np.ndarray
    py: np.ndarray
    scalars: np.ndarray

    @property
    def size(self) -> int:
        return self.px.shape[1]


def cache_dir() -> Path:
    d = os.environ.get("TPU_MSM_CACHE_DIR")
    base = Path(d) if d else Path.home() / ".tpu_msm"
    p = base / "msm_vecs"
    p.mkdir(parents=True, exist_ok=True)
    return p


def _instance_path(log_size: int, num: int) -> Path:
    return cache_dir() / f"msm_{log_size}x{num}.npz"


def generate_msm_instances(
    log_size: int, num: int, seed: int = 42, base_points: int = 4096
) -> List[MsmInstance]:
    """Random instances (reference: generate_msm_instances,
    preprocess.rs:113-138). Points: additive generator walk, tiled and
    shuffled past `base_points` distinct points; scalars: uniform mod r."""
    n = 1 << log_size
    rng = np.random.RandomState(seed)
    distinct = min(n, base_points)
    walk = []
    acc = oracle.GEN
    step = oracle.ec_mul(oracle.GEN, int(rng.randint(1, 2**62)))
    for _ in range(distinct):
        walk.append(acc)
        acc = oracle.ec_add(acc, step)
    px1, py1 = interop.affine_points_to_limbs(walk)

    out = []
    for _ in range(num):
        idx = rng.randint(0, distinct, size=n)
        px = np.ascontiguousarray(px1[:, idx])
        py = np.ascontiguousarray(py1[:, idx])
        raw = np.frombuffer(rng.bytes(32 * n), dtype="<u2").reshape(n, 16).T
        scalars = raw.astype(np.uint32)
        # < 2^254, so some lie above r (about 2^253.6): the MSM of such a
        # scalar is that of its residue mod r, which every engine computes.
        scalars[15] &= np.uint32(0x3FFF)
        out.append(MsmInstance(px, py, np.ascontiguousarray(scalars)))
    return out


def save_msm_instances(instances: List[MsmInstance], path: Path) -> None:
    """(Reference: save_msm_instances, preprocess.rs:83-96.)"""
    arrays = {}
    for i, inst in enumerate(instances):
        arrays[f"px{i}"] = inst.px
        arrays[f"py{i}"] = inst.py
        arrays[f"s{i}"] = inst.scalars
    arrays["num"] = np.array([len(instances)])
    np.savez_compressed(path, **arrays)


def load_msm_instances(path: Path) -> List[MsmInstance]:
    """(Reference: load_msm_instances, preprocess.rs:98-111.)"""
    if not Path(path).exists():
        raise HarnessError(f"fixture file not found: {path}")
    with np.load(path) as z:
        num = int(z["num"][0])
        return [MsmInstance(z[f"px{i}"], z[f"py{i}"], z[f"s{i}"]) for i in range(num)]


def get_or_create_msm_instances(
    log_size: int, num: int, seed: int = 42
) -> List[MsmInstance]:
    """Load cached instances or generate+save them, with shape validation
    (reference: get_or_create_msm_instances, preprocess.rs:143-212)."""
    path = _instance_path(log_size, num)
    if path.exists():
        try:
            instances = load_msm_instances(path)
        except Exception as e:  # corrupt cache -> regenerate
            path.unlink(missing_ok=True)
            instances = None
        else:
            ok = len(instances) == num and all(
                inst.px.shape == (bn254.LIMBS, 1 << log_size) for inst in instances
            )
            if not ok:
                instances = None
        if instances is not None:
            return instances
    instances = generate_msm_instances(log_size, num, seed=seed)
    save_msm_instances(instances, path)
    return instances
