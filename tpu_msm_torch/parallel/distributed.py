"""The MSM over several processes, one shard each, joined by
`torch.distributed` (counterpart of `tpu_msm/parallel/distributed.py`).

Every process calls `initialize` with the group's address, size and its
rank, then `msm_distributed` with its own shard of the points and scalars.
Each computes its partial window sums on its device, the partials are
summed across the ranks by `collectives.ec_all_gather_tree` or
`collectives.ec_all_reduce`, and every rank folds the same sums by one
`horner_fold`. The sums are taken in the order `parallel/sharded.py` takes
them in one process, so the result's bytes are the same on every rank and
the same as `sharded.msm_sharded` over as many shards.

Backends: NCCL sends card tensors and needs a card a rank; gloo sends host
tensors, so several ranks may share one card (or run on the CPU with
`--device cpu`). Either way every EC add runs on the rank's device.

    # two processes of one host, both on the first card, over gloo
    python -m tpu_msm_torch.parallel.distributed --init-method \
        tcp://localhost:29511 --world-size 2 --rank 0 --backend gloo &
    python -m tpu_msm_torch.parallel.distributed --init-method \
        tcp://localhost:29511 --world-size 2 --rank 1 --backend gloo
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_msm_torch.ops import pippenger
from tpu_msm_torch.parallel import collectives, sharded
from tpu_msm_torch.utils import interop
from tpu_msm_torch.utils.config import MsmConfig, select_config


def initialize(init_method: str, world_size: int, rank: int,
               backend: str = "gloo") -> None:
    """Join the process group: `init_method` is its address
    ("tcp://host:port", or "file://..."), `rank` this process's place in
    it. Call once per process, before msm_distributed."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def rank_device(rank: int, device=None) -> torch.device:
    """The device of rank `rank`: `device` if given, else
    cuda:(rank mod device_count). Raises without a card unless the CPU is
    asked for."""
    if device is not None:
        return interop.resolve_device(device)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("msm_distributed needs a CUDA device and none is "
                           "available (pass device='cpu' for the CPU)")
    return torch.device("cuda", rank % count)


def _check_equal_shards(n_local: int, device, group) -> None:
    """Raises unless every rank holds n_local points: the configuration
    each rank takes from its n_local must be the same on all of them."""
    mine = torch.tensor([n_local], dtype=torch.int64)
    if dist.get_backend(group) != "gloo":
        mine = mine.to(device)
    sizes = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(sizes, mine, group=group)
    sizes = [int(s) for s in sizes]
    if len(set(sizes)) != 1:
        raise ValueError(f"every rank must pass as many points; the ranks "
                         f"hold {sizes}")


def msm_distributed(local_px, local_py, local_scalars,
                    cfg: MsmConfig | None = None,
                    collective: str = "gather_tree", device=None, group=None):
    """The MSM over every rank of `group` (None: the default group). Each
    rank passes its shard: (16, n_local) limb arrays (uint32 numpy or int32
    tensors), n_local the same on every rank (pad with zero scalars on the
    (0, 0) infinity). cfg defaults to `select_config(n_local, device)`.
    Returns the (16, 1) projective result (x, y, z) as uint32 numpy, the
    same bytes on every rank."""
    sharded._check_collective(collective)
    dev = rank_device(dist.get_rank(group), device)
    px, py, sl = interop.limbs_to_device(local_px, local_py, local_scalars,
                                         dev)
    n_local = px.shape[1]
    _check_equal_shards(n_local, dev, group)
    if cfg is None:
        cfg = select_config(max(1, n_local), dev)
    wsums = sharded._local_window_sums(px, py, sl, cfg)
    if collective == "gather_tree":
        total = collectives.ec_all_gather_tree(wsums, group)
    else:
        total = sharded._transpose(collectives.ec_all_reduce(
            sharded._transpose(wsums), group))
    res = pippenger.horner_fold(total, cfg.window_bits)
    return tuple(interop.tensor_to_limbs(a) for a in res)


def digest(x, y, z) -> str:
    """sha256 of a (16, 1) projective result's bytes, x then y then z (uint32
    numpy, or int32 tensors: the same bytes)."""
    return hashlib.sha256(b"".join(
        (interop.tensor_to_limbs(a) if isinstance(a, torch.Tensor) else a)
        .tobytes() for a in (x, y, z))).hexdigest()


def workload(log_size: int, scalar_bits: int | None = None):
    """The instance every rank of `_main` makes: (px, py, scalars), (16, n)
    uint32 limbs of `generate_msm_instances(log_size, 1, seed=7)`, the
    scalars cut to their low `scalar_bits` bits when given."""
    from tpu_msm_torch.utils import preprocess

    [inst] = preprocess.generate_msm_instances(log_size, 1, seed=7)
    scalars = inst.scalars
    if scalar_bits is not None:
        full, part = divmod(scalar_bits, 16)
        scalars = scalars.copy()
        scalars[full:] = 0
        if part:
            scalars[full] = inst.scalars[full] & np.uint32((1 << part) - 1)
    return inst.px, inst.py, scalars


def _main(argv=None) -> int:
    """One process of a multi-process run: makes the same workload as every
    other rank (`workload`), takes this rank's contiguous shard of it
    padded to a multiple of the ranks, and prints the digest of the result's bytes
    and the time of each call."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", required=True,
                    help="the group's address, e.g. tcp://localhost:29511")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", default="gloo", choices=["nccl", "gloo"])
    ap.add_argument("--device", default=None,
                    help="this rank's device (default cuda:(rank mod the "
                         "card count); 'cpu' runs on the host)")
    ap.add_argument("--log-size", type=int, default=8)
    ap.add_argument("--window-bits", type=int, default=None,
                    help="given this, --scan-lanes or --scalar-bits, the "
                         "configuration is MsmConfig of them (8, 8, 254 where "
                         "not given); else select_config of the shard's size")
    ap.add_argument("--scan-lanes", type=int, default=None)
    ap.add_argument("--scalar-bits", type=int, default=None,
                    help="keep the low bits of each scalar and configure "
                         "for them (a short run on the CPU)")
    ap.add_argument("--collective", default="gather_tree",
                    choices=list(sharded.COLLECTIVES))
    ap.add_argument("--repeats", type=int, default=1,
                    help="calls of msm_distributed; the digest is the last "
                         "one's")
    args = ap.parse_args(argv)

    dev = rank_device(args.rank, args.device)
    if args.backend == "nccl":  # NCCL takes the current card as the rank's
        torch.cuda.set_device(dev)
    initialize(args.init_method, args.world_size, args.rank, args.backend)
    try:
        n = 1 << args.log_size
        world, rank = dist.get_world_size(), dist.get_rank()
        # As msm_sharded: n padded to a multiple of the ranks with zero
        # scalars on the (0, 0) infinity, then equal contiguous shards.
        per_rank = -(-n // world)
        lo, hi = rank * per_rank, (rank + 1) * per_rank
        cfg = None
        if any(v is not None for v in (args.window_bits, args.scan_lanes,
                                        args.scalar_bits)):
            cfg = MsmConfig(window_bits=args.window_bits or 8,
                            scan_lanes=args.scan_lanes or 8,
                            scalar_bits=args.scalar_bits or 254)
        shard = [np.ascontiguousarray(np.pad(a, ((0, 0), (0, per_rank * world
                                                          - n)))[:, lo:hi])
                 for a in workload(args.log_size, args.scalar_bits)]
        times = []
        for _ in range(max(1, args.repeats)):
            dist.barrier()
            t0 = time.perf_counter()
            x, y, z = msm_distributed(*shard, cfg=cfg,
                                      collective=args.collective, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"proc {rank}/{world} devices={dev} backend={args.backend} "
              f"collective={args.collective} ms={[round(t, 3) for t in times]}"
              f" result_sha256={digest(x, y, z)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
