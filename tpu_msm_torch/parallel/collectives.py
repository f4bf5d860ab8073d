"""EC sums across the ranks of a `torch.distributed` group (counterpart of
`tpu_msm/parallel/collectives.py`).

A collective's own sum adds ring elements lane by lane; the EC group
operation is the complete RCB add, so the sum of the ranks' partial window
sums is built from point-to-point messages and `padd`:

* `ec_all_gather_tree`: `all_gather` of the (W, 16, 1) partials (W·48
  int32 words a rank), then on every rank the same fixed balanced tree
  (`sharded._tree_reduce_last`): the ranks' results are equal bit for bit
  by construction.
* `ec_all_reduce`: the binomial tree, reduce to rank 0 in ceil(log2 D)
  rounds, then a binomial broadcast back, by `send` / `recv`; every rank
  ends with rank 0's bytes, and only one point set crosses each hop.

Both add in the order the one-process reductions of `parallel/sharded.py`
use, so D processes give the bytes of D shards in one process.

Where the messages lie: on the host when the group's backend is gloo, on
the card when it is NCCL. The adds run on the device the point lies on, so
on gloo the (W, 16, 1) partials are copied to the host and back, a few KB.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_msm_torch.models.bn254 import LIMBS
from tpu_msm_torch.ops.curve import ProjPoint
from tpu_msm_torch.parallel import sharded


def _wire_device(device, group) -> torch.device:
    """Where the group's backend sends from: the host for gloo, else the
    point's own device (NCCL sends card tensors)."""
    return (torch.device("cpu") if dist.get_backend(group) == "gloo"
            else device)


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _pack(pt: ProjPoint, group) -> torch.Tensor:
    """The point's three coordinates as one (3, ...) message."""
    return torch.stack(tuple(pt)).to(_wire_device(pt.x.device, group))


def _buffer(pt: ProjPoint, group) -> torch.Tensor:
    """An empty message of pt's shape, where the group receives."""
    return torch.empty((3, *pt.x.shape), dtype=pt.x.dtype,
                       device=_wire_device(pt.x.device, group))


def _unpack(t: torch.Tensor, device) -> ProjPoint:
    return ProjPoint(*t.to(device).unbind(0))


def ec_all_reduce(pt: ProjPoint, group=None) -> ProjPoint:
    """EC all-reduce of each rank's point over `group` (None: the default
    group); every rank gets rank 0's bytes.

    pt's arrays must be limbs-first (leading axis 16): the curve ops take
    the limb axis first, so (W, 16, 1) window sums are transposed to
    (16, W, 1) before the call (checked on the leading axis, since W = 16
    would pass any other check).

    Reduce: in round k (stride 2^k) rank r with r mod 2^(k+1) = 2^k sends
    to r - 2^k, which adds the received point on top of its own. Broadcast:
    the same pairs in the reverse order, the lower rank sending."""
    if pt.x.shape[0] != LIMBS:
        raise ValueError(
            f"ec_all_reduce needs limbs-first arrays (leading axis {LIMBS}), "
            f"got {tuple(pt.x.shape)}; move the limb axis to 0")
    rank = dist.get_rank(group)
    rounds = sharded.binomial_levels(dist.get_world_size(group))
    device = pt.x.device
    for pairs in rounds:
        for r, s in pairs:
            if rank == s:
                dist.send(_pack(pt, group), _global(group, r), group=group)
            elif rank == r:
                buf = _buffer(pt, group)
                dist.recv(buf, _global(group, s), group=group)
                pt = sharded._add_cols(pt, _unpack(buf, device))
    for pairs in reversed(rounds):
        for r, s in pairs:
            if rank == r:
                dist.send(_pack(pt, group), _global(group, s), group=group)
            elif rank == s:
                buf = _buffer(pt, group)
                dist.recv(buf, _global(group, r), group=group)
                pt = _unpack(buf, device)
    return pt


def ec_all_gather_tree(wsums: ProjPoint, group=None) -> ProjPoint:
    """The EC sum over `group` of each rank's (W, 16, 1) window sums, on
    every rank: `all_gather` of the partials, then the fixed balanced tree
    over the ranks in rank order. Returns (W, 16, 1) on wsums' device."""
    if wsums.x.dim() != 3 or tuple(wsums.x.shape[1:]) != (LIMBS, 1):
        raise ValueError(f"ec_all_gather_tree needs (W, {LIMBS}, 1) window "
                         f"sums, got {tuple(wsums.x.shape)}")
    device = wsums.x.device
    mine = _pack(sharded._transpose(wsums), group)
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    gathered = torch.cat(parts, dim=-1).to(device)  # (3, 16, W, D)
    total = sharded._tree_reduce_last(ProjPoint(*gathered.unbind(0)))
    return sharded._transpose(total)
