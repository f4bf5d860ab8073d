"""The EC kernels of the MSM main path: wrappers, plain versions, counters
(counterpart of `tpu_msm/ops/pallas_curve.py`).

Each wrapper dispatches on its operands' device: CPU tensors run the plain
PyTorch version beside it (built from ops/field.py and ops/ec_rows.py), CUDA
tensors launch the hand-written kernel in `csrc/ec_kernels.cu`, or raise.
There is no fallback from one to the other.

  wrapper     kernel              replaces (tpu_msm/ops/pallas_curve.py)
  scan_madd   scan_madd_kernel    scan_madd_packed_u16_f15d (:799) and its
                                  aliases scan_madd_packed_u16 (:615),
                                  scan_madd_packed_u16_f15 (:687),
                                  scan_madd_packed_u16_mxu (:860)
  padd        padd_kernel         padd_packed (:1009)
  fold_add    fold_add_kernel     fold_add_packed (:953)

What bounds the kernels, and what their design does about it, is written at
the top of `csrc/ec_kernels.cu`.

Counters: `<wrapper>.launches` counts kernel launches and
`<plain>.calls` counts plain-version calls; callers may reset them to 0.
Operands are int32 tensors that carry u32 bit patterns.
"""

from __future__ import annotations

import torch

from tpu_msm_torch import _build
from tpu_msm_torch.ops import curve
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint

_I32, _I64 = torch.int32, torch.int64


def unpack_u16_pairs(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) packed words -> (16, ...) int64 u16 limbs: row 2i is the low
    half of word i, row 2i+1 the high half."""
    w = words.to(_I64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(
        (16,) + tuple(words.shape[1:]))


# --------------------------------------------------------------------------
# scan: per-lane inclusive prefix sum over the step axis by mixed add.
# --------------------------------------------------------------------------

def scan_madd_plain(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """gx, gy: (8, steps, lanes) packed affine coordinates, (0, 0) =
    infinity. Returns (48, steps, lanes) int32 canonical u16 rows X‖Y‖Z:
    column (k, l) is the sum of points 0..k of lane l, starting from
    (0 : 1 : 0)."""
    scan_madd_plain.calls += 1
    qx, qy = unpack_u16_pairs(gx), unpack_u16_pairs(gy)
    acc = curve.proj_infinity((gx.shape[2],), gx.device, _I64)
    rows = []
    for k in range(gx.shape[1]):
        acc = curve.proj_madd(acc, AffinePoint(qx[:, k], qy[:, k]))
        rows.append(torch.cat(acc))
    return torch.stack(rows, dim=1).to(_I32)


scan_madd_plain.calls = 0


def scan_madd(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of scan_madd_plain (same arguments and result)."""
    if not _build.on_cuda(gx, gy):
        return scan_madd_plain(gx, gy)
    if gx.dim() != 3 or gx.shape[0] != 8 or gy.shape != gx.shape:
        raise ValueError(f"scan inputs must both be (8, steps, lanes), got "
                         f"{tuple(gx.shape)} and {tuple(gy.shape)}")
    _, steps, lanes = gx.shape
    if steps < 1 or lanes < 1:
        raise ValueError("scan needs at least one step and one lane")
    out = torch.empty((48, steps, lanes), dtype=_I32, device=gx.device)
    _build.launch("tpu_msm_scan_madd", gx.device, gx, gy, out, steps, lanes)
    scan_madd.launches += 1
    return out


scan_madd.launches = 0


# --------------------------------------------------------------------------
# padd: elementwise complete projective add.
# --------------------------------------------------------------------------

def padd_plain(ax, ay, az, bx, by, bz):
    """Six (16, N) u16-row coordinate tensors -> the three of P + Q."""
    padd_plain.calls += 1
    p = ProjPoint(ax.to(_I64), ay.to(_I64), az.to(_I64))
    q = ProjPoint(bx.to(_I64), by.to(_I64), bz.to(_I64))
    return tuple(a.to(_I32) for a in curve.proj_add(p, q))


padd_plain.calls = 0


def padd(ax, ay, az, bx, by, bz):
    """Kernel wrapper of padd_plain (same arguments and result)."""
    ops = (ax, ay, az, bx, by, bz)
    if not _build.on_cuda(*ops):
        return padd_plain(*ops)
    if ax.dim() != 2 or ax.shape[0] != 16 or any(t.shape != ax.shape for t in ops):
        raise ValueError("padd operands must all be (16, N)")
    n = ax.shape[1]
    if n < 1:
        raise ValueError("padd needs N >= 1")
    out = tuple(torch.empty_like(ax) for _ in range(3))
    _build.launch("tpu_msm_padd", ax.device, *ops, *out, n)
    padd.launches += 1
    return out


padd.launches = 0


# --------------------------------------------------------------------------
# fold_add: per-lane EC sum over the step axis.
# --------------------------------------------------------------------------

def fold_add_plain(bx, by, bz):
    """Three (16, steps, lanes) coordinate tensors -> the three (16, lanes)
    of each lane's sum over the steps, starting from (0 : 1 : 0)."""
    fold_add_plain.calls += 1
    acc = curve.proj_infinity((bx.shape[2],), bx.device, _I64)
    for k in range(bx.shape[1]):
        acc = curve.proj_add(
            acc, ProjPoint(bx[:, k].to(_I64), by[:, k].to(_I64),
                           bz[:, k].to(_I64)))
    return tuple(a.to(_I32) for a in acc)


fold_add_plain.calls = 0


def fold_add(bx, by, bz):
    """Kernel wrapper of fold_add_plain (same arguments and result)."""
    if not _build.on_cuda(bx, by, bz):
        return fold_add_plain(bx, by, bz)
    if bx.dim() != 3 or bx.shape[0] != 16 or by.shape != bx.shape \
            or bz.shape != bx.shape:
        raise ValueError("fold_add operands must all be (16, steps, lanes)")
    _, steps, lanes = bx.shape
    if steps < 1 or lanes < 1:
        raise ValueError("fold_add needs at least one step and one lane")
    out = tuple(torch.empty((16, lanes), dtype=_I32, device=bx.device)
                for _ in range(3))
    _build.launch("tpu_msm_fold_add", bx.device, bx, by, bz, *out, steps,
                  lanes)
    fold_add.launches += 1
    return out


fold_add.launches = 0
