"""The one traffic generator. A traffic mix is a JSON file of parameters in
`msmbench/traffic/`; this module reads it and makes a run's inputs on the
device from `--seed`:

* bases: a walk of `distinct_bases` points G + k·(t·G), t a seeded integer
  below 2^62 (the reference's instance generator,
  `src/utils/preprocess.rs:113-138`, as the JAX package's fixtures make
  it), in Montgomery (16, m) int32 limbs, tiled to n rows by a seeded
  uniform index: n rows at n addresses, as an SRS is held, with no period;
* scalars: `scalar_sets` (16, n) int32 limb sets, each limb uniform below
  2^16 and the top limb uniform below `top_limb_below`, so every scalar is
  below r;
* where each input lives between calls (`scalars_on`, `bases_on`): "card",
  a card tensor as drawn, or "host", a contiguous (16, n) uint32 numpy
  array in pageable host memory, the form a caller holding host arrays
  hands `msm_best`, so that the program copies it over on every call.

The walk is worked out in Python integers (4096 affine additions, some tens
of milliseconds); everything of size n is drawn on the device by
`torch.Generator`s seeded from `--seed`, in a few large calls, so the same
seed on the same device gives the same inputs, and `scalars(k)` can draw
set k again for the reference after the program's state is freed. An
input placed on the host is drawn on the device all the same, copied to
the host once at set-up, and its device copy freed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, fields

import numpy as np
import torch

from msmbench import reference

LIMBS = reference.LIMBS
PLACES = ("card", "host")


# Keys a traffic file may carry that describe the cell in words and steer
# nothing: `from_dict` drops them.
DESCRIPTIVE = ("entry", "loop", "source")


@dataclass(frozen=True)
class Mix:
    """A traffic file's parameters, each of which steers the generator."""

    scalar_sets: int
    distinct_bases: int
    top_limb_below: int
    scalars_on: str = "card"
    bases_on: str = "card"

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        """The mix of a traffic file. The DESCRIPTIVE keys are dropped; any
        other key that is no parameter raises, so that no parameter a file
        gives is silently dropped."""
        names = [f.name for f in fields(cls)]
        unknown = sorted(set(d) - set(names) - set(DESCRIPTIVE))
        if unknown:
            raise ValueError(f"unknown traffic parameters {unknown}; a mix "
                             f"takes {names} and the words {list(DESCRIPTIVE)}")
        mix = cls(**{k: v for k, v in d.items() if k in names})
        for key in ("scalars_on", "bases_on"):
            if getattr(mix, key) not in PLACES:
                raise ValueError(f"{key} must be one of {PLACES}, got "
                                 f"{getattr(mix, key)!r}")
        top = reference.R >> (reference.LIMB_BITS * (LIMBS - 1))
        if not 1 <= mix.top_limb_below <= top:
            raise ValueError(f"top_limb_below must be 1 to {top}, so every "
                             f"scalar is below r")
        if mix.scalar_sets < 1 or mix.distinct_bases < 1:
            raise ValueError("scalar_sets and distinct_bases must be >= 1")
        return mix


def to_host(t: torch.Tensor) -> np.ndarray:
    """A (16, n) int32 limb tensor -> a contiguous (16, n) uint32 array in
    pageable host memory that numpy allocated and owns, as a caller's
    array is."""
    return np.array(t.cpu().numpy().view(np.uint32), order="C")


def to_card(a, device) -> torch.Tensor:
    """A limb array as a (16, n) int32 tensor on `device`: a tensor as it
    is, a host array copied over."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(a.view(np.int32)).to(device)


class Workload:
    """The inputs of one run: `n` points and the mix's scalar sets, made on
    `device` from `seed` (any integer)."""

    def __init__(self, mix: Mix, n: int, seed: int, device):
        self.mix, self.n, self.device = mix, n, torch.device(device)
        rng = random.Random(seed)
        self.step_log = rng.randrange(1, 1 << 62)
        self.index_seed = rng.getrandbits(63)
        self.set_seeds = [rng.getrandbits(63) for _ in range(mix.scalar_sets)]

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def walk(self):
        return reference.walk(self.step_log, min(self.n, self.mix.distinct_bases))

    def index(self) -> torch.Tensor:
        """(n,) int64: which walk point each table row holds."""
        m = min(self.n, self.mix.distinct_bases)
        return torch.randint(0, m, (self.n,), device=self.device,
                             generator=self._generator(self.index_seed))

    def bases(self):
        """(px, py): the table, (16, n) int32 Montgomery limbs each."""
        pts = self.walk()
        idx = self.index()
        out = []
        for coord in (0, 1):
            limbs = reference.to_mont_limbs([p[coord] for p in pts])
            col = torch.from_numpy(limbs.view("int32")).to(self.device)
            out.append(col.index_select(1, idx))
        return tuple(out)

    def scalars(self, k: int) -> torch.Tensor:
        """Scalar set k: (16, n) int32 standard-form limbs, each below r."""
        g = self._generator(self.set_seeds[k])
        s = torch.randint(0, 1 << reference.LIMB_BITS, (LIMBS, self.n),
                          dtype=torch.int32, device=self.device, generator=g)
        s[LIMBS - 1] = torch.randint(0, self.mix.top_limb_below, (self.n,),
                                     dtype=torch.int32, device=self.device,
                                     generator=g)
        return s

    def placed_bases(self):
        """The table where the mix places it: `bases()`, or its host copy."""
        px, py = self.bases()
        if self.mix.bases_on == "host":
            return to_host(px), to_host(py)
        return px, py

    def placed_scalars(self, k: int):
        """Scalar set k where the mix places it: `scalars(k)`, or its host
        copy."""
        s = self.scalars(k)
        return to_host(s) if self.mix.scalars_on == "host" else s
