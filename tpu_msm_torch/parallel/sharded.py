"""The MSM over D shards in one process (counterpart of
`tpu_msm/parallel/sharded.py`).

Window sums sum_b b·bucket_b are linear over the multiset of (point, digit)
pairs, so each shard computes the partial window sums (W, 16, 1) of its
slice of the points (`pippenger.window_sums`, on its own device), and the
window sums of the whole MSM are the EC sum of the D partials. The partials
are brought to the first device and summed in a fixed order, then one
`horner_fold` gives the (16, 1) result:

* "gather_tree" (`_reduce_gather`): the partials side by side as
  (16, W, D) and the fixed balanced tree of `_tree_reduce_last`, one `padd`
  launch of W·⌊d/2⌋ elements a level;
* "ppermute_tree" (`_reduce_ppermute`): the binomial reduce-to-0 order of
  `collectives.ec_all_reduce`, one `padd` launch a level.

Each order is the one its multi-process collective uses
(`parallel/collectives.py`), so the bytes of the result are the same for D
shards in one process and for D processes of one shard each, and the same
on every run.

A device list may name the same device more than once: D shards then run
one after another on it. That is how a host with one card runs D > 1. On
several cards the shards' launches go to their own cards, but this process
enqueues them one shard after another.
"""

from __future__ import annotations

import torch

from tpu_msm_torch.models.bn254 import LIMBS
from tpu_msm_torch.ops import pippenger
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint
from tpu_msm_torch.utils import interop
from tpu_msm_torch.utils.config import MsmConfig, select_config

COLLECTIVES = ("gather_tree", "ppermute_tree")


def _add_cols(p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """p + q for limbs-first (16, ...) points of one shape: one padd launch
    over all their elements."""
    shape = p.x.shape
    out = pippenger.ec_add(*(ProjPoint(*(a.reshape(LIMBS, -1) for a in pt))
                             for pt in (p, q)))
    return ProjPoint(*(a.reshape(shape) for a in out))


def _tree_reduce_last(pts: ProjPoint) -> ProjPoint:
    """EC sum over the trailing axis of a limbs-first (16, W, D) ProjPoint,
    by the JAX package's fixed balanced tree: each level adds the first
    ⌊d/2⌋ columns to the next ⌊d/2⌋ and carries an odd last column up.
    Returns (16, W, 1)."""
    d = pts.x.shape[-1]
    while d > 1:
        half = d // 2
        merged = _add_cols(
            ProjPoint(*(a[..., :half].contiguous() for a in pts)),
            ProjPoint(*(a[..., half:2 * half].contiguous() for a in pts)))
        if d % 2:
            merged = ProjPoint(*(torch.cat([m, a[..., -1:]], dim=-1)
                                 for m, a in zip(merged, pts)))
        pts = merged
        d = (d + 1) // 2
    return pts


def _transpose(pt: ProjPoint) -> ProjPoint:
    """(W, 16, 1) window sums <-> limbs-first (16, W, 1): the curve ops take
    the limb axis first."""
    return ProjPoint(*(a.transpose(0, 1).contiguous() for a in pt))


def _local_window_sums(px, py, slimbs, cfg: MsmConfig) -> ProjPoint:
    """One shard's partial window sums (W, 16, 1), on the shard's device."""
    return pippenger.window_sums(AffinePoint(px, py), slimbs, cfg)


def _side_by_side(pts) -> ProjPoint:
    """Limbs-first (16, W, 1) points -> one (16, W, len(pts))."""
    return ProjPoint(*(torch.cat(coord, dim=-1) for coord in zip(*pts)))


def _on(device, partials):
    """(W, 16, 1) partials -> limbs-first (16, W, 1) points on `device`."""
    return [ProjPoint(*(a.to(device) for a in _transpose(p)))
            for p in partials]


def _reduce_gather(partials, c: int, device) -> ProjPoint:
    """The D partials (W, 16, 1) side by side on `device` as (16, W, D), the
    fixed balanced tree, then the Horner fold: the (16, 1) result."""
    total = _tree_reduce_last(_side_by_side(_on(device, partials)))
    return pippenger.horner_fold(_transpose(total), c)


def binomial_levels(d: int):
    """The reduce-to-0 rounds of `collectives.ec_all_reduce` over d ranks:
    for each round, the (receiver, sender) pairs, the sender stride ranks
    above its receiver."""
    rounds = []
    stride = 1
    while stride < d:
        rounds.append([(r, r + stride) for r in range(0, d - stride,
                                                      2 * stride)])
        stride *= 2
    return rounds


def _reduce_ppermute(partials, c: int, device) -> ProjPoint:
    """The D partials summed on `device` in the binomial reduce-to-0 order of
    `collectives.ec_all_reduce` (each receiver adds its sender's point on
    top of its own; one padd launch a round), then the Horner fold."""
    pts = _on(device, partials)
    for pairs in binomial_levels(len(pts)):
        summed = _add_cols(_side_by_side([pts[r] for r, _ in pairs]),
                           _side_by_side([pts[s] for _, s in pairs]))
        for k, (r, _) in enumerate(pairs):
            pts[r] = ProjPoint(*(a[..., k:k + 1] for a in summed))
    return pippenger.horner_fold(_transpose(pts[0]), c)


def _resolve_devices(devices):
    devices = [interop.resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("the device list is empty")
    return devices


def _check_collective(collective: str) -> None:
    if collective not in COLLECTIVES:
        raise ValueError(f"collective must be one of {COLLECTIVES}, got "
                         f"{collective!r}")


def make_sharded_msm(devices, cfg: MsmConfig,
                     collective: str = "gather_tree"):
    """The sharded MSM over `devices` with `cfg` on every shard:
    run(px, py, scalar_limbs) -> ProjPoint of (16, 1) on devices[0].

    Each argument is the list of D (16, n_i) int32 shards that
    `shard_tensors` gives, shard i on devices[i]. `collective` picks the
    order of the EC sum of the partials ("gather_tree" or
    "ppermute_tree")."""
    devices = _resolve_devices(devices)
    _check_collective(collective)
    reduce = (_reduce_gather if collective == "gather_tree"
              else _reduce_ppermute)

    def run(px, py, slimbs):
        if not len(px) == len(py) == len(slimbs) == len(devices):
            raise ValueError(f"{len(devices)} devices need as many shards of "
                             f"each input, got {len(px)}, {len(py)}, "
                             f"{len(slimbs)}")
        partials = [_local_window_sums(*shard, cfg)
                    for shard in zip(px, py, slimbs)]
        return reduce(partials, cfg.window_bits, devices[0])

    return run


def shard_tensors(devices, *arrays):
    """(16, N) limb arrays (uint32 numpy, or int32 tensors) -> for each, the
    list of D contiguous (16, N / D) int32 shards, shard i on devices[i]
    (the counterpart of `shard_arrays`). N must be a multiple of D."""
    devices = _resolve_devices(devices)
    d = len(devices)
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else interop.limb_tensor(a, "cpu")
        n = t.shape[1]
        if n % d:
            raise ValueError(f"N = {n} is not a multiple of {d} devices")
        step = n // d
        out.append([interop.limb_tensor(t[:, i * step:(i + 1) * step], dev)
                    for i, dev in enumerate(devices)])
    return tuple(out)


def default_devices():
    """Every visible CUDA device (the counterpart of `default_mesh`); raises
    without one."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("the sharded MSM needs a CUDA device and none is "
                           "available")
    return [torch.device("cuda", i) for i in range(count)]


def msm_sharded(points, scalar_limbs, devices=None,
                cfg: MsmConfig | None = None,
                collective: str = "gather_tree") -> ProjPoint:
    """sum_i scalars[i]·points[i] over len(devices) shards, as a (16, 1)
    ProjPoint on devices[0].

    points: an AffinePoint, or an (x, y) pair, of (16, N) Montgomery limb
    arrays; scalar_limbs: (16, N) standard-form limbs; uint32 numpy or
    int32 tensors. devices: a list (a device may appear more than once);
    None means every visible CUDA device, and raises without one. N is
    padded to a multiple of D with zero scalars on the (0, 0) infinity, and
    every shard runs with cfg, or `select_config(ceil(N / D), devices[0])`.
    """
    devices = _resolve_devices(default_devices() if devices is None
                               else devices)
    d = len(devices)
    px, py = points
    arrays = [a if isinstance(a, torch.Tensor) else interop.limb_tensor(a,
                                                                       "cpu")
              for a in (px, py, scalar_limbs)]
    n = arrays[0].shape[1]
    if any(a.shape != arrays[0].shape for a in arrays):
        raise ValueError("points and scalars must be (16, N) limb arrays of "
                         "one N")
    if cfg is None:
        cfg = select_config(max(1, -(-n // d)), devices[0])
    pad = (-n) % d
    arrays = [pippenger._pad_cols(a, pad, 0) for a in arrays]
    return make_sharded_msm(devices, cfg, collective)(
        *shard_tensors(devices, *arrays))
