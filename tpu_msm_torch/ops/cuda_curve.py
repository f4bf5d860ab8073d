"""The EC kernels: wrappers, plain versions, counters (counterpart of
`tpu_msm/ops/pallas_curve.py`).

Each wrapper dispatches on its operands' device: CPU tensors run the plain
PyTorch version beside it (built from ops/field.py and ops/ec_rows.py), CUDA
tensors launch the hand-written kernel in `csrc/ec_kernels.cu`, or raise.
There is no fallback from one to the other.

  wrapper         kernel                 replaces (tpu_msm/ops/pallas_curve.py)
  scan_madd       scan_madd_kernel       scan_madd_packed_u16_f15d (:799) and
                                         its aliases scan_madd_packed_u16
                                         (:615), scan_madd_packed_u16_f15
                                         (:687), scan_madd_packed_u16_mxu (:860)
  padd            padd_kernel            padd_packed (:1009)
  fold_add        fold_add_kernel        fold_add_packed (:953)
  pmadd           pmadd_kernel           pmadd_packed (:988)
  jac_madd        jac_madd_kernel        madd_packed (:367)
  jac_add         jac_add_kernel         add_packed (:385)
  scan_madd_rows  scan_madd_rows_kernel  scan_madd_packed (:565)
  montmul_chain   montmul_chain_kernel   benches/montmul_benchmark.py `run`
                                         (:89-107, built by _build_kernel)

The fused MSM path runs scan_madd, padd and fold_add; the per-window path
runs pmadd (one launch per scan step), padd and fold_add. jac_madd, jac_add
and scan_madd_rows run in the profiler's kernel check
(`tpu_msm_torch.cli.profiler --check-kernels`), as their TPU kernels did.
montmul_chain runs in the field core's microbench
(`tpu_msm_torch.benches.montmul_benchmark`), whose rate the roofline
(`utils/profiling.py`) takes.

What bounds the kernels, and what their design does about it, is written at
the top of `csrc/ec_kernels.cu` and `csrc/montmul.cu` (the montmul kernel is
in its own source).

Counters: `<wrapper>.launches` counts kernel launches and
`<plain>.calls` counts plain-version calls; callers may reset them to 0.
Operands are int32 tensors that carry u32 bit patterns.
"""

from __future__ import annotations

import torch

from tpu_msm_torch import _build
from tpu_msm_torch.ops import curve, ec_rows, field
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint

_I32, _I64 = torch.int32, torch.int64


def unpack_u16_pairs(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) packed words -> (16, ...) int64 u16 limbs: row 2i is the low
    half of word i, row 2i+1 the high half."""
    w = words.to(_I64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(
        (16,) + tuple(words.shape[1:]))


def _i64(ts):
    return tuple(t.to(_I64) for t in ts)


def _i32(ts):
    return tuple(t.to(_I32) for t in ts)


def _elementwise(name, ops):
    """Launch the elementwise kernel `tpu_msm_<name>` on the card for
    (16, N) CUDA operands; returns its three (16, N) results."""
    if ops[0].dim() != 2 or ops[0].shape[0] != 16 or any(
            t.shape != ops[0].shape for t in ops):
        raise ValueError(f"{name} operands must all be (16, N)")
    n = ops[0].shape[1]
    if n < 1:
        raise ValueError(f"{name} needs N >= 1")
    out = tuple(torch.empty_like(ops[0]) for _ in range(3))
    _build.launch(f"tpu_msm_{name}", ops[0].device, *ops, *out, n)
    return out


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
    return _i32(ec_rows.proj_add(field.F, *_i64((ax, ay, az, bx, by, bz))))


padd_plain.calls = 0


def padd(ax, ay, az, bx, by, bz):
    """Kernel wrapper of padd_plain (same arguments and result)."""
    ops = (ax, ay, az, bx, by, bz)
    if not _build.on_cuda(*ops):
        return padd_plain(*ops)
    out = _elementwise("padd", ops)
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


# --------------------------------------------------------------------------
# Elementwise adds of (16, N) u16-row operands: the RCB mixed add and the
# two Jacobian adders.
# --------------------------------------------------------------------------

def pmadd_plain(px, py, pz, qx, qy):
    """Projective P (three (16, N)) + affine Q (two (16, N), (0, 0) =
    infinity) by RCB Algorithm 8 -> the three coordinates of P + Q."""
    pmadd_plain.calls += 1
    return _i32(ec_rows.proj_madd(field.F, *_i64((px, py, pz, qx, qy))))


pmadd_plain.calls = 0


def pmadd(px, py, pz, qx, qy):
    """Kernel wrapper of pmadd_plain (same arguments and result)."""
    ops = (px, py, pz, qx, qy)
    if not _build.on_cuda(*ops):
        return pmadd_plain(*ops)
    out = _elementwise("pmadd", ops)
    pmadd.launches += 1
    return out


pmadd.launches = 0


def jac_madd_plain(x1, y1, z1, x2, y2):
    """Jacobian P + affine Q ((0, 0) = infinity), madd-2007-bl with the
    fallback and selects of `_madd_rows` -> three Jacobian coordinates."""
    jac_madd_plain.calls += 1
    return _i32(ec_rows.jac_madd(field.F, *_i64((x1, y1, z1, x2, y2))))


jac_madd_plain.calls = 0


def jac_madd(x1, y1, z1, x2, y2):
    """Kernel wrapper of jac_madd_plain (same arguments and result)."""
    ops = (x1, y1, z1, x2, y2)
    if not _build.on_cuda(*ops):
        return jac_madd_plain(*ops)
    out = _elementwise("jac_madd", ops)
    jac_madd.launches += 1
    return out


jac_madd.launches = 0


def jac_add_plain(x1, y1, z1, x2, y2, z2):
    """Jacobian P + Q, add-2007-bl with the fallback and selects of
    `_add_rows` -> three Jacobian coordinates."""
    jac_add_plain.calls += 1
    return _i32(ec_rows.jac_add(field.F, *_i64((x1, y1, z1, x2, y2, z2))))


jac_add_plain.calls = 0


def jac_add(x1, y1, z1, x2, y2, z2):
    """Kernel wrapper of jac_add_plain (same arguments and result)."""
    ops = (x1, y1, z1, x2, y2, z2)
    if not _build.on_cuda(*ops):
        return jac_add_plain(*ops)
    out = _elementwise("jac_add", ops)
    jac_add.launches += 1
    return out


jac_add.launches = 0


# --------------------------------------------------------------------------
# scan_madd_rows: the prefix scan of scan_madd on unpacked u16 rows, with
# the three coordinates as three outputs.
# --------------------------------------------------------------------------

def scan_madd_rows_plain(gx: torch.Tensor, gy: torch.Tensor):
    """gx, gy: (16, steps, lanes) affine u16 rows, (0, 0) = infinity.
    Returns three (16, steps, lanes) int32 tensors X, Y, Z: column (k, l)
    is the sum of points 0..k of lane l, starting from (0 : 1 : 0)
    (`_scan_madd_kernel`, one step per TPU grid step)."""
    scan_madd_rows_plain.calls += 1
    qx, qy = gx.to(_I64), gy.to(_I64)
    acc = curve.proj_infinity((gx.shape[2],), gx.device, _I64)
    steps = []
    for k in range(gx.shape[1]):
        acc = curve.proj_madd(acc, AffinePoint(qx[:, k], qy[:, k]))
        steps.append(acc)
    return tuple(torch.stack(c, dim=1).to(_I32) for c in zip(*steps))


scan_madd_rows_plain.calls = 0


def scan_madd_rows(gx: torch.Tensor, gy: torch.Tensor):
    """Kernel wrapper of scan_madd_rows_plain (same arguments and result)."""
    if not _build.on_cuda(gx, gy):
        return scan_madd_rows_plain(gx, gy)
    if gx.dim() != 3 or gx.shape[0] != 16 or gy.shape != gx.shape:
        raise ValueError(f"scan inputs must both be (16, steps, lanes), got "
                         f"{tuple(gx.shape)} and {tuple(gy.shape)}")
    _, steps, lanes = gx.shape
    if steps < 1 or lanes < 1:
        raise ValueError("scan needs at least one step and one lane")
    out = tuple(torch.empty_like(gx) for _ in range(3))
    _build.launch("tpu_msm_scan_madd_rows", gx.device, gx, gy, *out, steps,
                  lanes)
    scan_madd_rows.launches += 1
    return out


scan_madd_rows.launches = 0


# --------------------------------------------------------------------------
# montmul_chain: the chained Montgomery-multiply microbench (the field core's
# rate, benches/montmul_benchmark.py).
# --------------------------------------------------------------------------

MONTMUL_MAX_ILP = 8


def _check_montmul_args(chain: int, steps: int, ilp: int) -> None:
    if chain < 0 or steps < 0:
        raise ValueError("chain and steps must be >= 0")
    if not 1 <= ilp <= MONTMUL_MAX_ILP:
        raise ValueError(f"ilp must be in 1..{MONTMUL_MAX_ILP}, got {ilp}")


def montmul_chain_plain(a, x, chain: int, steps: int, ilp: int = 1):
    """a, x: (16, N) u16 rows, x < P and a < 2^256. Per lane, `steps`
    times: start `ilp` chains from the limb rotations of the accumulator
    (chain k holds limb (i + k) mod 16 at limb i), multiply each `chain`
    times by x in Montgomery form (field.mont_mul), and XOR-fold them into
    the accumulator (`benches/montmul_benchmark.py:64-74`). Returns the
    (16, N) int32 accumulator; with ilp = 1 it is a·x^(chain·steps)·
    2^(-256·chain·steps) mod P."""
    montmul_chain_plain.calls += 1
    _check_montmul_args(chain, steps, ilp)
    acc, xx = a.to(_I64), x.to(_I64)
    for _ in range(steps):
        chains = [torch.roll(acc, -k, dims=0) for k in range(ilp)]
        for _ in range(chain):
            chains = [field.mont_mul(c, xx) for c in chains]
        acc = chains[0]
        for c in chains[1:]:
            acc = acc ^ c
    return acc.to(_I32)


montmul_chain_plain.calls = 0


def montmul_chain(a, x, chain: int, steps: int, ilp: int = 1):
    """Kernel wrapper of montmul_chain_plain (same arguments and result)."""
    if not _build.on_cuda(a, x):
        return montmul_chain_plain(a, x, chain, steps, ilp)
    _check_montmul_args(chain, steps, ilp)
    if a.dim() != 2 or a.shape[0] != 16 or x.shape != a.shape \
            or a.shape[1] < 1:
        raise ValueError(f"montmul_chain operands must both be (16, N), "
                         f"N >= 1, got {tuple(a.shape)} and {tuple(x.shape)}")
    out = torch.empty_like(a)
    _build.launch("tpu_msm_montmul_chain", a.device, a, x, out, a.shape[1],
                  chain, steps, ilp)
    montmul_chain.launches += 1
    return out


montmul_chain.launches = 0
