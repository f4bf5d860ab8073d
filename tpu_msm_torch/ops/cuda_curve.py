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
  padd            padd_kernel,           padd_packed (:1009)
                  padd_group_kernel
  window_tail     window_tail_kernel     padd_packed, in pippenger.py's
                                         M·X(n) - sum X(s_b) (:475-482)
  horner          horner_kernel          padd_packed, in pippenger.py's
                                         horner_fold (:690-708)
  fold_add        fold_add_kernel,       fold_add_packed (:953)
                  fold_add_group_kernel
  pmadd           pmadd_kernel,          pmadd_packed (:988)
                  pmadd_group_kernel
  jac_madd        jac_madd_kernel        madd_packed (:367)
  jac_add         jac_add_kernel         add_packed (:385)
  scan_madd_rows  scan_madd_rows_kernel  scan_madd_packed (:565)
                  after its totals and
                  prefix kernels
  montmul_chain   montmul_chain_kernel   benches/montmul_benchmark.py `run`
                                         (:89-107, built by _build_kernel)
  scan_layout     scan_layout_kernel     no Pallas kernel: the gather of
                  (csrc/layout.cu)       pippenger.py's `_sorted_scan_inputs`
                                         ("rank", :289-297), left to XLA
  scan_madd_      scan_madd_sorted_      scan_madd_packed_u16_f15d (:799)
  sorted          kernel                 after that gather: scan_layout and
                                         scan_madd in one kernel

padd, fold_add and pmadd each launch one of two kernels: one thread an
element (padd_kernel, fold_add_kernel, pmadd_kernel; for fold_add an
element is a lane's chain) or eight lanes an element (padd_group_kernel,
fold_add_group_kernel, pmadd_group_kernel), whichever `kernel_path` gives
for the width and the card's SM count. scan_madd_rows launches its three
kernels (chunk totals, their running sums, each chunk's scan) at the K
chunks of the step axis that `scan_rows_chunks` gives, or the caller.

The fused MSM path runs scan_madd_sorted (one launch per group of
windows: the scan, each step's point read from the point-major table in
sort order), padd, fold_add, window_tail and horner; the per-window path
runs pmadd (one launch per scan step), padd, fold_add, window_tail (once
per window) and horner. scan_madd_sorted computes scan_madd(*scan_layout(
...)) without writing the layout; the pair stays as the reference it is
held to on the card, scan_layout in the sort bench
(`benches/sort_benchmark.py` (b)). scan_madd, jac_madd, jac_add
and scan_madd_rows run in the profiler's kernel check
(`tpu_msm_torch.cli.profiler --check-kernels`), as their TPU kernels did.
montmul_chain runs in the field core's microbench
(`tpu_msm_torch.benches.montmul_benchmark`), whose rate the roofline
(`utils/profiling.py`) takes.

What bounds the kernels, and what their design does about it, is written at
the top of `csrc/ec_kernels.cu`, `csrc/montmul.cu` (the montmul kernel is
in its own source) and `csrc/layout.cu`.

Each wrapper checks its operands' device, makes the choices that read the
card (the kernel of padd, fold_add and pmadd; the chunks of
scan_madd_rows) and calls its operator `torch.ops.tpu_msm_torch.<wrapper>` (ops/library.py),
defined here beside it: the kernel's launch is the operator's CUDA
implementation (with the checks of its operands' shapes and arguments, so
a direct call of the operator is checked too), the plain version its CPU one
(the module's `<wrapper>_plain` at each call, so a caller may replace it),
and a fake one gives the output shapes to `torch.export`
(bindings/export.py).

Counters: `<wrapper>.launches` counts kernel launches (both kernels of
padd, fold_add and pmadd; `<wrapper>.group_launches` those of the group
kernel alone) and `<plain>.calls` counts plain-version calls; callers may reset
them to 0. The operators' implementations count, so the launches of a
program that `torch.export` saved and loaded are counted too.
Operands are int32 tensors that carry u32 bit patterns, but the
permutation (int64, as torch.sort gives it) and masks (bool) of scan_layout
and scan_madd_sorted.
"""

from __future__ import annotations

import functools
import math

import torch

from tpu_msm_torch import _build
from tpu_msm_torch.ops import curve, ec_rows, field, library
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


def _empty3(shape, like):
    """Three new int32 tensors of `shape` on `like`'s device."""
    return tuple(torch.empty(shape, dtype=_I32, device=like.device)
                 for _ in range(3))


def _check_elementwise(name, ops):
    if ops[0].dim() != 2 or ops[0].shape[0] != 16 or any(
            t.shape != ops[0].shape for t in ops):
        raise ValueError(f"{name} operands must all be (16, N)")
    if ops[0].shape[1] < 1:
        raise ValueError(f"{name} needs N >= 1")


def _elementwise(name, entry, ops):
    """Launch the elementwise kernel of C entry `entry` (wrapper `name`) on
    the card for (16, N) CUDA operands; returns its three (16, N)
    results."""
    _check_elementwise(name, ops)
    out = _empty3(ops[0].shape, ops[0])
    _build.launch(entry, ops[0].device, *ops, *out, ops[0].shape[1])
    return out


def _elementwise_fake(*args):
    return _empty3(args[0].shape, args[0])


# --------------------------------------------------------------------------
# scan: per-lane inclusive prefix sum over the step axis by mixed add.
# --------------------------------------------------------------------------

def scan_madd_plain(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """gx, gy: (8, steps, lanes) packed affine coordinates, (0, 0) =
    infinity, or (G, 8, steps, lanes) for G windows at once. Returns
    (48, steps, lanes) (or (G, 48, steps, lanes)) int32 canonical u16 rows
    X‖Y‖Z: column (k, l) is the sum of points 0..k of lane l, starting from
    (0 : 1 : 0)."""
    scan_madd_plain.calls += 1
    one = gx.dim() == 3
    if one:
        gx, gy = gx[None], gy[None]
    g, _, steps, lanes = gx.shape

    def lanes_last(a):  # (G, 8, S, L) -> (8, S, G·L): windows side by side
        return a.permute(1, 2, 0, 3).reshape(8, steps, g * lanes)

    qx, qy = unpack_u16_pairs(lanes_last(gx)), unpack_u16_pairs(lanes_last(gy))
    acc = curve.proj_infinity((g * lanes,), gx.device, _I64)
    rows = []
    for k in range(steps):
        acc = curve.proj_madd(acc, AffinePoint(qx[:, k], qy[:, k]))
        rows.append(torch.cat(acc))
    out = (torch.stack(rows, dim=1).to(_I32).reshape(48, steps, g, lanes)
           .permute(2, 0, 1, 3).contiguous())
    return out[0] if one else out


scan_madd_plain.calls = 0


def _scan_madd_fake(gx, gy):
    return torch.empty(gx.shape[:-3] + (48,) + gx.shape[-2:], dtype=_I32,
                       device=gx.device)


def _scan_madd_cuda(gx, gy):
    if gx.dim() not in (3, 4) or gx.shape[-3] != 8 or gy.shape != gx.shape:
        raise ValueError(f"scan inputs must both be (8, steps, lanes) or "
                         f"(G, 8, steps, lanes), got {tuple(gx.shape)} and "
                         f"{tuple(gy.shape)}")
    if min(gx.shape[0] if gx.dim() == 4 else 1, *gx.shape[-2:]) < 1:
        raise ValueError("scan needs at least one window, step and lane")
    out = _scan_madd_fake(gx, gy)
    g = gx.shape[0] if gx.dim() == 4 else 1
    _build.launch("tpu_msm_scan_madd", gx.device, gx, gy, out, g,
                  *gx.shape[-2:])
    scan_madd.launches += 1
    return out


def _scan_madd_cpu(gx, gy):
    return scan_madd_plain(gx, gy)


_SCAN_MADD = library.define("scan_madd(Tensor gx, Tensor gy) -> Tensor",
                            cuda=_scan_madd_cuda, cpu=_scan_madd_cpu,
                            fake=_scan_madd_fake)


def scan_madd(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of scan_madd_plain (same arguments and result): one
    launch for all G windows."""
    _build.on_cuda(gx, gy)
    return _SCAN_MADD(gx, gy)


scan_madd.launches = 0


# --------------------------------------------------------------------------
# scan_layout: the sorted points in the scan's layout (the sort stage's
# gather; csrc/layout.cu).
# --------------------------------------------------------------------------

def _check_scan_layout(perm, rows, negm, lanes: int,
                       name: str = "scan_layout") -> None:
    if perm.dim() != 2 or perm.dtype != _I64:
        raise ValueError(f"{name} perm must be (G, n_pad) int64, got "
                         f"{tuple(perm.shape)} {perm.dtype}")
    g, n_pad = perm.shape
    width = 16 if negm is None else 24
    if rows.dim() != 2 or rows.dtype != _I32 \
            or tuple(rows.shape) != (n_pad, width):
        raise ValueError(f"{name} rows must be ({n_pad}, 16) int32, "
                         f"or ({n_pad}, 24) with negm; got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if negm is not None and (negm.shape != perm.shape
                             or negm.dtype != torch.bool):
        raise ValueError(f"{name} negm must be {tuple(perm.shape)} "
                         f"bool, got {tuple(negm.shape)} {negm.dtype}")
    if lanes < 1 or n_pad % lanes:
        raise ValueError(f"{name} lanes {lanes} must divide n_pad "
                         f"{n_pad}")


def scan_layout_plain(perm: torch.Tensor, rows: torch.Tensor, negm,
                      lanes: int):
    """Each window's points in sort order, in the scan's layout: the JAX
    package's "rank" strategy (`pippenger.py:289-297`) after its sort.

    perm: (G, n_pad) int64 stable sort permutations; rows: the packed
    words of each point, (n_pad, 16) int32 [x | y] with negm None, or
    (n_pad, 24) [x | y | -y] with negm the (G, n_pad) bool negation masks;
    lanes must divide n_pad. Returns (sgx, sgy), each (G, 8, steps, lanes) int32 with
    steps = n_pad // lanes: column k·lanes + l of window g is the point
    src = perm[g, l·steps + k], its x words, and its y words or, where
    negm[g, src], its -y words."""
    scan_layout_plain.calls += 1
    _check_scan_layout(perm, rows, negm, lanes)
    g, n_pad = perm.shape
    steps = n_pad // lanes
    # Column k·lanes + l of window g is its sorted position l·steps + k.
    src = perm.view(g, lanes, steps).transpose(1, 2).reshape(g, n_pad)
    taken = rows.index_select(0, src.reshape(-1)).view(g, steps, lanes, -1)
    y = taken[..., 8:16]
    if negm is not None:
        neg = torch.gather(negm, 1, src).view(g, steps, lanes, 1)
        y = torch.where(neg, taken[..., 16:24], y)

    def lay(a):  # (G, steps, lanes, 8) -> (G, 8, steps, lanes)
        return a.permute(0, 3, 1, 2).contiguous()

    return lay(taken[..., :8]), lay(y)


scan_layout_plain.calls = 0


def _scan_layout_fake(perm, rows, negm, lanes):
    shape = (perm.shape[0], 8, perm.shape[1] // lanes, lanes)
    return tuple(torch.empty(shape, dtype=_I32, device=perm.device)
                 for _ in range(2))


def _scan_layout_cuda(perm, rows, negm, lanes):
    _check_scan_layout(perm, rows, negm, lanes)
    sgx, sgy = _scan_layout_fake(perm, rows, negm, lanes)
    g, n_pad = perm.shape
    if g and n_pad:
        _build.launch("tpu_msm_scan_layout", perm.device, perm, rows, negm,
                      sgx, sgy, g, n_pad, lanes,
                      dtypes=(_I64, _I32, torch.bool))
        scan_layout.launches += 1
    return sgx, sgy


def _scan_layout_cpu(perm, rows, negm, lanes):
    return scan_layout_plain(perm, rows, negm, lanes)


_SCAN_LAYOUT = library.define(
    "scan_layout(Tensor perm, Tensor rows, Tensor? negm, int lanes) -> "
    "(Tensor, Tensor)",
    cuda=_scan_layout_cuda, cpu=_scan_layout_cpu, fake=_scan_layout_fake)


def scan_layout(perm: torch.Tensor, rows: torch.Tensor, negm, lanes: int):
    """Kernel wrapper of scan_layout_plain (same arguments and result): one
    launch for all G windows."""
    _build.on_cuda(perm, rows, *(() if negm is None else (negm,)))
    return _SCAN_LAYOUT(perm, rows, negm, lanes)


scan_layout.launches = 0


# --------------------------------------------------------------------------
# scan_madd_sorted: the scan over the sorted points, read from the
# point-major table (the main path's scan).
# --------------------------------------------------------------------------

def scan_madd_sorted_plain(perm: torch.Tensor, rows: torch.Tensor, negm,
                           lanes: int) -> torch.Tensor:
    """scan_madd_plain(*scan_layout_plain(perm, rows, negm, lanes)): the
    (G, 48, steps, lanes) running sums of each window's points in the order
    of its permutation, lane l taking sorted positions l·steps ..
    (l + 1)·steps - 1 (arguments as scan_layout_plain's)."""
    scan_madd_sorted_plain.calls += 1
    return scan_madd_plain(*scan_layout_plain(perm, rows, negm, lanes))


scan_madd_sorted_plain.calls = 0


def _scan_madd_sorted_fake(perm, rows, negm, lanes):
    return torch.empty((perm.shape[0], 48, perm.shape[1] // lanes, lanes),
                       dtype=_I32, device=perm.device)


def _scan_madd_sorted_cuda(perm, rows, negm, lanes):
    _check_scan_layout(perm, rows, negm, lanes, "scan_madd_sorted")
    out = _scan_madd_sorted_fake(perm, rows, negm, lanes)
    g, n_pad = perm.shape
    if g and n_pad:
        _build.launch("tpu_msm_scan_madd_sorted", perm.device, perm, rows,
                      negm, out, g, n_pad, lanes,
                      dtypes=(_I64, _I32, torch.bool))
        scan_madd_sorted.launches += 1
    return out


def _scan_madd_sorted_cpu(perm, rows, negm, lanes):
    _check_scan_layout(perm, rows, negm, lanes, "scan_madd_sorted")
    return scan_madd_sorted_plain(perm, rows, negm, lanes)


_SCAN_MADD_SORTED = library.define(
    "scan_madd_sorted(Tensor perm, Tensor rows, Tensor? negm, int lanes) -> "
    "Tensor",
    cuda=_scan_madd_sorted_cuda, cpu=_scan_madd_sorted_cpu,
    fake=_scan_madd_sorted_fake)


def scan_madd_sorted(perm: torch.Tensor, rows: torch.Tensor, negm,
                     lanes: int) -> torch.Tensor:
    """Kernel wrapper of scan_madd_sorted_plain (same arguments and result):
    one launch for all G windows; the layout scan_layout would write is
    never written."""
    _build.on_cuda(perm, rows, *(() if negm is None else (negm,)))
    return _SCAN_MADD_SORTED(perm, rows, negm, lanes)


scan_madd_sorted.launches = 0


# --------------------------------------------------------------------------
# padd: elementwise complete projective add.
# --------------------------------------------------------------------------

def padd_plain(ax, ay, az, bx, by, bz):
    """Six (16, N) u16-row coordinate tensors -> the three of P + Q."""
    padd_plain.calls += 1
    return _i32(ec_rows.proj_add(field.F, *_i64((ax, ay, az, bx, by, bz))))


padd_plain.calls = 0


# padd, fold_add and pmadd each have two kernels: one thread an element (a
# lane's chain, for fold_add), or a group of eight lanes an element. One
# thread an element is the faster wherever the card is full; with few
# elements an SM it is latency-bound (one padd or pmadd launch takes about
# 0.0085-0.0095 ms from 2048 to 16,384 elements), and eight lanes an
# element give eight times the warps at about 2.2 times the instructions.
# Both kernels of each timed by chip_smoke.py phase 2 (NVIDIA H100 80GB
# HBM3, 700.00 W, 132 SMs; PERF.md §6), with the field product on carry
# chains: padd group 0.0071 ms against thread 0.0089 at 8192 elements,
# 0.0117 against 0.0095 at 16,384; pmadd group 0.0046, 0.0069, 0.0115
# against thread 0.0081, 0.0083, 0.0087 at 4096, 8192 and 16,384; fold_add
# at 64 steps group 0.300 against 0.449 at 8192 lanes, 0.577 against 0.451
# at 16,384. The group time grows linearly there, the thread time hardly,
# so the crossovers fall at about 83 (pmadd) and 89 (padd) elements an SM;
# one rule serves all three.
GROUP_BELOW_PER_SM = 80
PATHS = ("thread", "group")


def kernel_path(width: int, sm_count: int) -> str:
    """The kernel of padd, pmadd or fold_add for `width` elements (fold_add:
    lanes) on a card of `sm_count` SMs: "group" (eight lanes an element)
    below GROUP_BELOW_PER_SM elements an SM, else "thread"."""
    return "group" if width < GROUP_BELOW_PER_SM * sm_count else "thread"


def _group(path, width: int, device) -> bool:
    """Whether the group kernel runs: `path`, or the path kernel_path gives
    `width` on `device`'s SM count when path is None."""
    if path is None:
        path = kernel_path(width, _sm_count(device))
    return path == "group"


def _entry(name: str, group: bool) -> str:
    return f"tpu_msm_{name}" + ("_group" if group else "")


def _check_path(path) -> None:
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got "
                         f"{path!r}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _padd_cuda(ax, ay, az, bx, by, bz, group):
    out = _elementwise("padd", _entry("padd", group),
                       (ax, ay, az, bx, by, bz))
    padd.launches += 1
    padd.group_launches += group
    return out


def _padd_cpu(ax, ay, az, bx, by, bz, group):
    return padd_plain(ax, ay, az, bx, by, bz)


_PADD = library.define(
    "padd(Tensor ax, Tensor ay, Tensor az, Tensor bx, Tensor by, Tensor bz, "
    "bool group) -> (Tensor, Tensor, Tensor)",
    cuda=_padd_cuda, cpu=_padd_cpu, fake=_elementwise_fake)


def _group_on(ops, path, width) -> bool:
    """Whether the group kernel runs for `ops`, of `width` elements or
    lanes: on the card by `_group`; on the CPU False (the plain version
    runs either way)."""
    _check_path(path)
    return _build.on_cuda(*ops) and _group(path, width, ops[0].device)


def padd(ax, ay, az, bx, by, bz, path=None):
    """Kernel wrapper of padd_plain (same arguments and result). `path`
    ("thread" or "group") picks the kernel; None lets kernel_path choose."""
    ops = (ax, ay, az, bx, by, bz)
    return _PADD(*ops, _group_on(ops, path, ax.shape[-1]))


padd.launches = 0
padd.group_launches = 0


# --------------------------------------------------------------------------
# The serial tail of the MSM: the window sums M·X(n) - sum X(s_b), and the
# Horner fold of the window sums. Chains of dependent complete adds, one
# launch each on the card.
# --------------------------------------------------------------------------

def window_tail_by_adds(add, nx, ny, nz, sx, sy, sz, c: int,
                        signed_digits: bool):
    """M·X(n) - sum X(s_b) for (16, W) coordinates by `add`, one
    elementwise add at a time (`tpu_msm/ops/pippenger.py:475-482`):
    M = 2^(c-1) by c - 1 doublings (signed digits) or M = 2^c - 1 by c - 1
    rounds of acc = 2·acc + X(n); a doubling is the add of a point to
    itself."""
    xn = (nx, ny, nz)
    acc = xn
    for _ in range(c - 1):
        acc = add(*acc, *acc)
        if not signed_digits:
            acc = add(*acc, *xn)
    return add(*acc, sx, field.neg_mod(sy), sz)


def horner_by_adds(add, wx, wy, wz, c: int):
    """Fold (W, 16, 1) window sums into the (16, 1) MSM result by `add`,
    top window first, c doublings between windows
    (`tpu_msm/ops/pippenger.py:690-708`)."""
    acc = (wx[-1], wy[-1], wz[-1])
    for widx in range(wx.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = add(*acc, *acc)
        acc = add(*acc, wx[widx], wy[widx], wz[widx])
    return acc


def window_tail_plain(nx, ny, nz, sx, sy, sz, c: int, signed_digits: bool):
    """X(n) (nx, ny, nz) and sum X(s_b) (sx, sy, sz), each three (16, W)
    u16-row coordinates -> the three of the W window sums
    M·X(n) - sum X(s_b), by padd_plain (window_tail_by_adds)."""
    window_tail_plain.calls += 1
    return window_tail_by_adds(padd_plain, nx, ny, nz, sx, sy, sz, c,
                               signed_digits)


window_tail_plain.calls = 0


def _check_tail_args(c: int, w: int) -> None:
    if c < 1 or w < 1:
        raise ValueError(f"the tail needs c >= 1 and W >= 1, got c = {c}, "
                         f"W = {w}")


def _window_tail_cuda(nx, ny, nz, sx, sy, sz, c, signed_digits):
    ops = (nx, ny, nz, sx, sy, sz)
    if nx.dim() != 2 or nx.shape[0] != 16 or any(t.shape != nx.shape
                                                 for t in ops):
        raise ValueError("window_tail operands must all be (16, W)")
    _check_tail_args(c, nx.shape[1])
    out = _empty3(nx.shape, nx)
    _build.launch("tpu_msm_window_tail", nx.device, nx, ny, nz, sx, sy, sz,
                  *out, nx.shape[1], c, int(signed_digits))
    window_tail.launches += 1
    return out


def _window_tail_cpu(nx, ny, nz, sx, sy, sz, c, signed_digits):
    return window_tail_plain(nx, ny, nz, sx, sy, sz, c, signed_digits)


_WINDOW_TAIL = library.define(
    "window_tail(Tensor nx, Tensor ny, Tensor nz, Tensor sx, Tensor sy, "
    "Tensor sz, int c, bool signed_digits) -> (Tensor, Tensor, Tensor)",
    cuda=_window_tail_cuda, cpu=_window_tail_cpu, fake=_elementwise_fake)


def window_tail(nx, ny, nz, sx, sy, sz, c: int, signed_digits: bool):
    """Kernel wrapper of window_tail_plain (same arguments and result): one
    launch, one block of eight lanes per window."""
    ops = (nx, ny, nz, sx, sy, sz)
    _build.on_cuda(*ops)
    return _WINDOW_TAIL(*ops, c, signed_digits)


window_tail.launches = 0


def horner_plain(wx, wy, wz, c: int):
    """Three (W, 16, 1) u16-row coordinates of the window sums -> the three
    (16, 1) of the MSM result, by padd_plain (horner_by_adds)."""
    horner_plain.calls += 1
    return horner_by_adds(padd_plain, wx, wy, wz, c)


horner_plain.calls = 0


def _horner_fake(wx, wy, wz, c):
    return _empty3((16, 1), wx)


def _horner_cuda(wx, wy, wz, c):
    if wx.dim() != 3 or wx.shape[1:] != (16, 1) or wy.shape != wx.shape \
            or wz.shape != wx.shape:
        raise ValueError("horner operands must all be (W, 16, 1)")
    _check_tail_args(c, wx.shape[0])
    out = _horner_fake(wx, wy, wz, c)
    _build.launch("tpu_msm_horner", wx.device, wx, wy, wz, *out, wx.shape[0],
                  c)
    horner.launches += 1
    return out


def _horner_cpu(wx, wy, wz, c):
    # One window's sum is the result itself: copied, since an operator's
    # output is never a view of its input.
    return tuple(a.clone() for a in horner_plain(wx, wy, wz, c))


_HORNER = library.define(
    "horner(Tensor wx, Tensor wy, Tensor wz, int c) -> (Tensor, Tensor, "
    "Tensor)", cuda=_horner_cuda, cpu=_horner_cpu, fake=_horner_fake)


def horner(wx, wy, wz, c: int):
    """Kernel wrapper of horner_plain (same arguments and result): one
    launch of one block of eight lanes."""
    _build.on_cuda(wx, wy, wz)
    return _HORNER(wx, wy, wz, c)


horner.launches = 0


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


def _fold_add_fake(bx, by, bz, group):
    return _empty3((16, bx.shape[2]), bx)


def _fold_add_cuda(bx, by, bz, group):
    if bx.dim() != 3 or bx.shape[0] != 16 or by.shape != bx.shape \
            or bz.shape != bx.shape:
        raise ValueError("fold_add operands must all be (16, steps, lanes)")
    if min(bx.shape[1:]) < 1:
        raise ValueError("fold_add needs at least one step and one lane")
    out = _fold_add_fake(bx, by, bz, group)
    _build.launch(_entry("fold_add", group), bx.device, bx, by, bz, *out,
                  *bx.shape[1:])
    fold_add.launches += 1
    fold_add.group_launches += group
    return out


def _fold_add_cpu(bx, by, bz, group):
    return fold_add_plain(bx, by, bz)


_FOLD_ADD = library.define(
    "fold_add(Tensor bx, Tensor by, Tensor bz, bool group) -> (Tensor, "
    "Tensor, Tensor)", cuda=_fold_add_cuda, cpu=_fold_add_cpu,
    fake=_fold_add_fake)


def fold_add(bx, by, bz, path=None):
    """Kernel wrapper of fold_add_plain (same arguments and result), one
    launch. `path` ("thread" or "group") picks the kernel; None lets
    kernel_path choose."""
    ops = (bx, by, bz)
    return _FOLD_ADD(*ops, _group_on(ops, path, bx.shape[-1]))


fold_add.launches = 0
fold_add.group_launches = 0


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


def _pmadd_cuda(px, py, pz, qx, qy, group):
    out = _elementwise("pmadd", _entry("pmadd", group),
                       (px, py, pz, qx, qy))
    pmadd.launches += 1
    pmadd.group_launches += group
    return out


def _pmadd_cpu(px, py, pz, qx, qy, group):
    return pmadd_plain(px, py, pz, qx, qy)


_PMADD = library.define(
    "pmadd(Tensor px, Tensor py, Tensor pz, Tensor qx, Tensor qy, "
    "bool group) -> (Tensor, Tensor, Tensor)",
    cuda=_pmadd_cuda, cpu=_pmadd_cpu, fake=_elementwise_fake)


def pmadd(px, py, pz, qx, qy, path=None):
    """Kernel wrapper of pmadd_plain (same arguments and result). `path`
    ("thread" or "group") picks the kernel; None lets kernel_path choose."""
    ops = (px, py, pz, qx, qy)
    return _PMADD(*ops, _group_on(ops, path, px.shape[-1]))


pmadd.launches = 0
pmadd.group_launches = 0


def jac_madd_plain(x1, y1, z1, x2, y2):
    """Jacobian P + affine Q ((0, 0) = infinity), madd-2007-bl with the
    fallback and selects of `_madd_rows` -> three Jacobian coordinates."""
    jac_madd_plain.calls += 1
    return _i32(ec_rows.jac_madd(field.F, *_i64((x1, y1, z1, x2, y2))))


jac_madd_plain.calls = 0


def _jac_madd_cuda(x1, y1, z1, x2, y2):
    out = _elementwise("jac_madd", "tpu_msm_jac_madd", (x1, y1, z1, x2, y2))
    jac_madd.launches += 1
    return out


def _jac_madd_cpu(x1, y1, z1, x2, y2):
    return jac_madd_plain(x1, y1, z1, x2, y2)


_JAC_MADD = library.define(
    "jac_madd(Tensor x1, Tensor y1, Tensor z1, Tensor x2, Tensor y2) -> "
    "(Tensor, Tensor, Tensor)",
    cuda=_jac_madd_cuda, cpu=_jac_madd_cpu, fake=_elementwise_fake)


def jac_madd(x1, y1, z1, x2, y2):
    """Kernel wrapper of jac_madd_plain (same arguments and result)."""
    ops = (x1, y1, z1, x2, y2)
    _build.on_cuda(*ops)
    return _JAC_MADD(*ops)


jac_madd.launches = 0


def jac_add_plain(x1, y1, z1, x2, y2, z2):
    """Jacobian P + Q, add-2007-bl with the fallback and selects of
    `_add_rows` -> three Jacobian coordinates."""
    jac_add_plain.calls += 1
    return _i32(ec_rows.jac_add(field.F, *_i64((x1, y1, z1, x2, y2, z2))))


jac_add_plain.calls = 0


def _jac_add_cuda(x1, y1, z1, x2, y2, z2):
    out = _elementwise("jac_add", "tpu_msm_jac_add",
                       (x1, y1, z1, x2, y2, z2))
    jac_add.launches += 1
    return out


def _jac_add_cpu(x1, y1, z1, x2, y2, z2):
    return jac_add_plain(x1, y1, z1, x2, y2, z2)


_JAC_ADD = library.define(
    "jac_add(Tensor x1, Tensor y1, Tensor z1, Tensor x2, Tensor y2, "
    "Tensor z2) -> (Tensor, Tensor, Tensor)",
    cuda=_jac_add_cuda, cpu=_jac_add_cpu, fake=_elementwise_fake)


def jac_add(x1, y1, z1, x2, y2, z2):
    """Kernel wrapper of jac_add_plain (same arguments and result)."""
    ops = (x1, y1, z1, x2, y2, z2)
    _build.on_cuda(*ops)
    return _JAC_ADD(*ops)


jac_add.launches = 0


# --------------------------------------------------------------------------
# scan_madd_rows: the prefix scan of scan_madd on unpacked u16 rows, with
# the three coordinates as three outputs, as a reduce-then-scan over K
# chunks of the step axis (csrc/ec_kernels.cu).
# --------------------------------------------------------------------------

# The chunks that fill the card: each chunk of each lane is one thread of
# phases 1 and 3, in blocks of 128 threads, SCAN_ROWS_BLOCKS_PER_SM of them
# an SM (the kernels' __launch_bounds__).
SCAN_ROWS_BLOCKS_PER_SM = 4
# More chunks shorten phases 1 and 3 (2·steps/K mixed adds in series) but
# lengthen phase 2's chain (K - 2 adds), so the time is least near K =
# sqrt(2·steps·t_madd / t_add): the sweep of benches/scan_rows_benchmark.py
# on the H100 put the cap at K^2 <= SCAN_ROWS_BALANCE·steps (PERF.md §6).
SCAN_ROWS_BALANCE = 4


def scan_rows_chunking(steps: int, chunks: int):
    """(K, length): `chunks` chunks of ceil(steps / chunks) steps, with the
    empty ones dropped, so that every chunk holds a step and only the last
    may be shorter."""
    if steps < 1 or chunks < 1:
        raise ValueError(f"the scan needs steps >= 1 and chunks >= 1, got "
                         f"{steps} and {chunks}")
    length = -(-steps // chunks)
    return -(-steps // length), length


def scan_rows_chunks(steps: int, lanes: int, sm_count: int) -> int:
    """K for scan_madd_rows at (16, steps, lanes) on `sm_count` SMs: 1
    where the lanes alone fill the card (one thread a lane), else the
    least K whose K x lanes threads fill it, capped at
    isqrt(SCAN_ROWS_BALANCE·steps) and at `steps`; chunks of equal
    length."""
    fill = SCAN_ROWS_BLOCKS_PER_SM * 128 * sm_count
    if lanes >= fill:
        return 1
    k = min(-(-fill // lanes), math.isqrt(SCAN_ROWS_BALANCE * steps), steps)
    return scan_rows_chunking(steps, k)[0]


def scan_madd_rows_plain(gx: torch.Tensor, gy: torch.Tensor, chunks=1):
    """gx, gy: (16, steps, lanes) affine u16 rows, (0, 0) = infinity.
    Returns three (16, steps, lanes) int32 tensors X, Y, Z: column (k, l)
    is the sum of points 0..k of lane l (`_scan_madd_kernel`, one step per
    TPU grid step). chunks = 1 adds them in order from (0 : 1 : 0); K > 1
    (scan_rows_chunking) runs the kernel's three phases: the totals of
    chunks 0 .. K-2, their running sums, and each chunk's scan from the
    sum of the chunks before it. Chunk 0 is then chunks = 1's bits, the
    rest the same points in other projective coordinates."""
    scan_madd_rows_plain.calls += 1
    _, steps, lanes = gx.shape
    k, length = scan_rows_chunking(steps, chunks)
    qx, qy = gx.to(_I64), gy.to(_I64)
    pad = k * length - steps  # (0, 0) sentinels leave a sum unchanged
    qx, qy = (torch.cat([q, q.new_zeros(16, pad, lanes)], dim=1)
              for q in (qx, qy))

    def by_chunk(q, n):  # chunks 0..n-1, chunk-major lanes: (16, length, n·L)
        return (q[:, :n * length].reshape(16, n, length, lanes)
                .transpose(1, 2).reshape(16, length, n * lanes))

    def run(acc, n, keep):
        xs, ys = by_chunk(qx, n), by_chunk(qy, n)
        sums = []
        for j in range(length):
            acc = curve.proj_madd(acc, AffinePoint(xs[:, j], ys[:, j]))
            if keep:
                sums.append(acc)
        return acc, sums

    start = curve.proj_infinity((lanes,), gx.device, _I64)
    if k > 1:
        totals, _ = run(curve.proj_infinity(((k - 1) * lanes,), gx.device,
                                            _I64), k - 1, False)
        prefix = [ProjPoint(*(c[:, :lanes] for c in totals))]
        for i in range(1, k - 1):
            prefix.append(curve.proj_add(prefix[-1], ProjPoint(
                *(c[:, i * lanes:(i + 1) * lanes] for c in totals))))
        start = ProjPoint(*(torch.cat(c, dim=1)
                            for c in zip(start, *prefix)))
    _, sums = run(start, k, True)
    return tuple(torch.stack(c, dim=1).reshape(16, length, k, lanes)
                 .transpose(1, 2).reshape(16, k * length, lanes)[:, :steps]
                 .to(_I32).contiguous() for c in zip(*sums))


scan_madd_rows_plain.calls = 0


def _scan_madd_rows_fake(gx, gy, chunks):
    return _empty3(gx.shape, gx)


def _scan_madd_rows_cuda(gx, gy, chunks):
    if gx.dim() != 3 or gx.shape[0] != 16 or gy.shape != gx.shape:
        raise ValueError(f"scan inputs must both be (16, steps, lanes), got "
                         f"{tuple(gx.shape)} and {tuple(gy.shape)}")
    _, steps, lanes = gx.shape
    if lanes < 1:
        raise ValueError("scan needs at least one step and one lane")
    k, _ = scan_rows_chunking(steps, chunks)
    out = _empty3(gx.shape, gx)
    sums = torch.empty((k - 1, 48, lanes), dtype=_I32, device=gx.device)
    _build.launch("tpu_msm_scan_madd_rows", gx.device, gx, gy, *out, sums,
                  steps, lanes, k)
    scan_madd_rows.launches += 1
    return out


def _scan_madd_rows_cpu(gx, gy, chunks):
    return scan_madd_rows_plain(gx, gy, chunks)


_SCAN_MADD_ROWS = library.define(
    "scan_madd_rows(Tensor gx, Tensor gy, int chunks) -> (Tensor, Tensor, "
    "Tensor)", cuda=_scan_madd_rows_cuda, cpu=_scan_madd_rows_cpu,
    fake=_scan_madd_rows_fake)


def scan_madd_rows(gx: torch.Tensor, gy: torch.Tensor, chunks=None):
    """Kernel wrapper of scan_madd_rows_plain (same arguments and result):
    one C entry, three launches, at `chunks` chunks; None takes
    scan_rows_chunks on the card and 1 on the CPU."""
    on_card = _build.on_cuda(gx, gy)
    if chunks is None:
        chunks = 1
        if on_card and gx.dim() == 3 and min(gx.shape[1:]) >= 1:
            chunks = scan_rows_chunks(*gx.shape[1:], _sm_count(gx.device))
    return _SCAN_MADD_ROWS(gx, gy, chunks)


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


def _montmul_chain_fake(a, x, chain, steps, ilp):
    return torch.empty(a.shape, dtype=_I32, device=a.device)


def _montmul_chain_cuda(a, x, chain, steps, ilp):
    _check_montmul_args(chain, steps, ilp)
    if a.dim() != 2 or a.shape[0] != 16 or x.shape != a.shape \
            or a.shape[1] < 1:
        raise ValueError(f"montmul_chain operands must both be (16, N), "
                         f"N >= 1, got {tuple(a.shape)} and {tuple(x.shape)}")
    out = _montmul_chain_fake(a, x, chain, steps, ilp)
    _build.launch("tpu_msm_montmul_chain", a.device, a, x, out, a.shape[1],
                  chain, steps, ilp)
    montmul_chain.launches += 1
    return out


def _montmul_chain_cpu(a, x, chain, steps, ilp):
    return montmul_chain_plain(a, x, chain, steps, ilp)


_MONTMUL_CHAIN = library.define(
    "montmul_chain(Tensor a, Tensor x, int chain, int steps, int ilp) -> "
    "Tensor", cuda=_montmul_chain_cuda, cpu=_montmul_chain_cpu,
    fake=_montmul_chain_fake)


def montmul_chain(a, x, chain: int, steps: int, ilp: int = 1):
    """Kernel wrapper of montmul_chain_plain (same arguments and result)."""
    _build.on_cuda(a, x)
    return _MONTMUL_CHAIN(a, x, chain, steps, ilp)


montmul_chain.launches = 0
