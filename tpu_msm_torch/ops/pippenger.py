"""Pippenger MSM on torch tensors (counterpart of `tpu_msm/ops/pippenger.py`).

With points sorted by digit, let X(p) be the EC prefix sum of the first p
sorted points and s_b the first position of digit b. Since
bucket_b = X(s_{b+1}) - X(s_b), each window sum telescopes:

    sum_{b=1}^{M} b * bucket_b  =  M * X(n) - sum_{b=1}^{M} X(s_b)

Two routes compute the window sums, as in the JAX package:

* the fused route (`_fused_sums`): `_window_heavy` per group of windows
  (`window_group_size`; for the group one stable digit sort, the radix
  sort of `ops/sort.py`, one scan_madd_sorted launch, the scan that reads
  each step's point from the point-major table in sort order, one
  histogram launch and one gather of the prefix sums at the bucket
  boundaries), then
  `_sides_batched` over all windows (inter-lane carries, the X(s_b) fold
  and rolled tree, the window_tail kernel);
* the per-window route (`_per_window_sums`, the JAX package's `_msm_window`
  fallback): per window, the digit sort, one `pmadd` launch per
  scan step, a Hillis–Steele scan of the lane totals, the query adds,
  `ec_reduce` and the window_tail kernel.

Which route runs is the JAX package's device rule (`pippenger.py:630`,
`_use_pallas` and `_FUSED_MAX_LANES`): the fused route iff the scan lanes
are a multiple of 1024 between 1024 and 8192, else the per-window route.
On the TPU the rule came from the Pallas kernels' (8, 128) tiling and VMEM
budget; the CUDA kernels take any width. The port keeps the rule as it is
and applies it on every device, so one configuration takes one route, with
one association of EC adds, on the CPU, on the card and in the JAX package:
the per-window sums are bit-identical to `tpu_msm.ops.pippenger.window_sums`
on the JAX CPU backend, and the fused ones projectively equal to it.

`horner_fold` then joins the windows (the horner kernel). Every other EC
add goes through `ec_add` or `ec_madd` (the padd and pmadd kernels on the
card, their plain versions on the CPU), every fold through the fold_add
kernel. The JAX package left the point-major table, the digit sort and
the sorted layout to XLA; the port builds the table in one `pack_rows`
launch, sorts by its own radix sort kernel (`ops/sort.digit_sort`, an
int32 permutation), and the fused route's scan reads the sorted points
itself: a point's 64-byte row, in place of a layout written and read back.
Everything else is plain torch, as the JAX package left it to XLA.

With `cfg.glv` both routes first split every scalar by the GLV
endomorphism (`_glv_split`, `pippenger.py:583-598` of the JAX package):
2n points over half the windows, the halves' signs XORed into the signed
digits' negation masks. The route is chosen after the split, on 2n points,
as in the JAX package.

Dropped from the JAX fused route: the `_FUSED_MAX_LANES // w` fanout clamp
and the query padding to 4096. They change only the association of EC
adds, so window sums stay projectively equal. Above STREAM_THRESHOLD
`msm` runs this pipeline a chunk at a time (`ops/streaming.py`).

While a profiler records, the fused route's stages each open a span
(`utils/profiling.span`): `tpu_msm_torch.pippenger.operands`
(`scan_operands`), `.group` (`_window_heavy`, one a window group), `.sides`
(`_sides_batched`) and `.horner` (`horner_fold`, every route).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_msm_torch.ops import curve, field, glv, hist, sort, u256
# pack_u16_rows lives beside the kernels that read its words; it is
# imported from here too, as the JAX package's pippenger.pack_u16_rows.
from tpu_msm_torch.ops.cuda_curve import (fold_add, horner,  # noqa: F401
                                          pack_rows, pack_u16_rows, padd,
                                          pmadd, scan_layout,
                                          scan_madd_sorted, window_tail)
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint
from tpu_msm_torch.utils.config import MsmConfig, select_config
from tpu_msm_torch.utils.profiling import span

# Coordinate row blocks of the scan kernel's 48-row output.
_XYZ = (slice(0, 16), slice(16, 32), slice(32, 48))

# What one window of a `_window_heavy` group holds per padded point at its
# peak: the sorted digit (where the segment starts read it), the sort's
# int32 permutation (which the scan reads), and then the larger of the
# sort's scratch (its first pass's keys and indices, freed when the sort
# returns) and the scan's 48 output rows, which live one after the other:
# 4 + 4 + 192 = 200 bytes. The point-major table that the scan reads
# (`scan_operands`, 64 or 96 bytes a point) is one for all the groups.
GROUP_BYTES_PER_POINT = 4 + 4 + max(sort.SCRATCH_BYTES_PER_KEY, 4 * 48)
# The group budget on the CPU, which has no device memory to take 1/8 of.
CPU_GROUP_BUDGET = 1 << 30

# The JAX package's route rule: its Pallas kernels took lane counts that are
# multiples of 1024 (`_PALLAS_MIN_WIDTH`), its whole-stage kernels at most
# 8192 lanes (`_FUSED_MAX_LANES`).
_FUSED_TILE = 1024
_FUSED_MAX_LANES = 8192


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def ec_add(p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Complete projective add of two (16, N) point batches (padd kernel)."""
    return ProjPoint(*padd(*(a.contiguous() for a in (*p, *q))))


def ec_madd(acc: ProjPoint, pt: AffinePoint) -> ProjPoint:
    """Complete projective + affine add of (16, N) batches (pmadd kernel);
    (0, 0) affine points are infinity."""
    return ProjPoint(*pmadd(*(a.contiguous() for a in (*acc, *pt))))


def fused_route(lanes: int) -> bool:
    """Whether `lanes` scan lanes take the fused route (module docstring)."""
    return lanes % _FUSED_TILE == 0 and _FUSED_TILE <= lanes <= _FUSED_MAX_LANES


def window_digits(scalar_limbs: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """(16, N) standard-form scalar limbs -> (W', N) unsigned window digits
    (W' = cfg.num_windows() rows, at most the 256 bits the limbs hold). With
    c = 16 the digits are the limbs; with c = 8 they are limb halves; any
    other c takes bits [i·c, i·c + c) of every scalar (`u256.extract_bits`,
    `pippenger.py:117-119`)."""
    c = cfg.window_bits
    w = cfg.num_windows()
    if c == 16:
        return scalar_limbs[:w]
    if c == 8:
        lo = scalar_limbs & 0xFF
        hi = scalar_limbs >> 8
        return torch.stack([lo, hi], dim=1).reshape(
            2 * scalar_limbs.shape[0], scalar_limbs.shape[1])[:w]
    return torch.stack([u256.extract_bits(scalar_limbs, i * c,
                                          min(c, 256 - i * c))
                        for i in range(w)])


def signed_window_digits(scalar_limbs: torch.Tensor, cfg: MsmConfig):
    """(16, N) scalar limbs -> (W, N) |digit| and (W, N) bool negation mask.

    Balanced recoding: digit d plus the incoming carry becomes
    d' = d + carry - 2^c (carry 1) when d + carry > 2^(c-1), else
    d' = d + carry (carry 0); sum_i d'_i 2^(c*i) == scalar exactly."""
    c = cfg.window_bits
    half, full = 1 << (c - 1), 1 << c
    raw = window_digits(scalar_limbs,
                        dataclasses.replace(cfg, signed_digits=False))
    zero = torch.zeros_like(raw[0])
    carry = zero
    abs_rows, neg_rows = [], []
    for i in range(cfg.num_windows()):
        d = (raw[i] if i < raw.shape[0] else zero) + carry
        neg = d > half
        abs_rows.append(torch.where(neg, full - d, d))
        neg_rows.append(neg)
        carry = neg.to(d.dtype)
    return torch.stack(abs_rows), torch.stack(neg_rows)


def _sorted_scan_inputs(digits, negm, rows, lanes: int,
                        key_bits: int = sort.MAX_KEY_BITS):
    """Stable digit sort of each of G windows, and the sorted points in the
    scan kernel's (G, 8, steps, lanes) layout: sorted position p sits at
    lane p // steps, step p % steps (`pippenger.py:302-305`). Two steps:
    the digit sort (`sort.digit_sort` of `key_bits`-bit digits, its sorted
    digits and int32 permutation; 18 bits by default, the most any window
    width gives), then one `scan_layout` launch, which takes each column's
    point as one row of the point-major table (the JAX package's "rank"
    strategy, `pippenger.py:289-297`; both JAX `sort_impl` values give this
    permutation). The main path does not write this layout
    (`_window_heavy` hands the permutation to scan_madd_sorted); the sort
    bench (b) and the layout's tests call this.

    digits: (G, n_pad); negm: (G, n_pad) negation masks or None; rows:
    (n_pad, 16) packed words of each point, [x | y], or (n_pad, 24)
    [x | y | -y] with negm, where window g takes -y at the points its mask
    negates (`scan_operands`). Returns (sorted_digits (G, n_pad), sgx,
    sgy)."""
    sorted_digits, perm = sort.digit_sort(digits, key_bits, want_keys=True)
    return (sorted_digits, *scan_layout(perm, rows, negm, lanes))


def window_group_size(w: int, n_pad: int, device) -> int:
    """How many windows `_fused_sums` hands `_window_heavy` at once:
    G = min(W, budget // (n_pad · GROUP_BYTES_PER_POINT)), at least 1.

    The budget is 1/8 of the card's memory
    (`torch.cuda.get_device_properties(device).total_memory`), or the fixed
    CPU_GROUP_BUDGET on the CPU. At 2^20 points on the H100 that is all 16
    windows of c = 16 in one group (about 3.4 GB of transients, one scan
    launch of 1024 blocks); at 2^24 three windows a group, at 2^22 (a
    streamed chunk) twelve."""
    return max(1, min(w, group_budget(device)
                      // (n_pad * GROUP_BYTES_PER_POINT)))


def group_budget(device) -> int:
    """The bytes a window group's transients may take on `device`: 1/8 of
    the card's `total_memory`, or CPU_GROUP_BUDGET on the CPU."""
    device = torch.device(device)
    return (torch.cuda.get_device_properties(device).total_memory // 8
            if device.type == "cuda" else CPU_GROUP_BUDGET)


def _segment_starts(digits, m: int, cfg: MsmConfig):
    """s_b = #{i : digits[g, i] < b} for b = 1..m of each of G windows,
    (G, n) -> (G, m) int32, by cfg.segment_starts (`pippenger.py:239-268`).
    "hist" counts the digits in any order (the unsorted ones on the fused
    route); every other value is handed the SORTED digits, as the JAX
    pipeline hands them. "hist" and "hist_cols" run the digit_hist kernel,
    one launch for the G windows; "bincount" counts by torch.bincount and
    sums; "ss_scan", "ss_sort" and "ss_2level" search 1..m in each row with
    torch.searchsorted (the JAX package's three search schedules for the
    TPU give the same exact starts)."""
    if cfg.segment_starts == "hist":
        return hist.segment_starts_hist(digits, m)
    if cfg.segment_starts == "hist_cols":
        return hist.segment_starts_hist_cols(digits, m)
    g = digits.shape[0]
    if cfg.segment_starts == "bincount":
        # One bincount for the group: row g's digit d counts at g·(m+2) + d.
        flat = digits.to(torch.int64) + (m + 2) * torch.arange(
            g, device=digits.device)[:, None]
        counts = torch.bincount(flat.reshape(-1), minlength=g * (m + 2))
        return torch.cumsum(counts.view(g, m + 2)[:, :m], dim=1,
                            dtype=torch.int32)
    bvals = torch.arange(1, m + 1, dtype=digits.dtype,
                         device=digits.device).repeat(g, 1)
    return torch.searchsorted(digits, bvals, side="left", out_int32=True)


def _window_heavy(digits, negm, rows, n: int, cfg: MsmConfig):
    """The heavy stages of a group of G windows, each stage once for the
    group: the digit sort (`sort.digit_sort`, one call: the radix sort's
    two passes over the (m + 1).bit_length() bits of the digits and the
    sentinel), the scan launch (scan_madd_sorted, which reads each step's
    point from `rows` by the sort's int32 permutation), the segment starts
    (one digit_hist launch with "hist"), and one gather of the prefix sums
    at the bucket boundaries. digits, negm: (G, n_pad) rows of the group's
    windows (negm None for unsigned digits); rows the point-major table as
    `_sorted_scan_inputs` takes it.

    Returns the group's small arrays, stacked: the lane totals
    (G, 48, lanes), the prefix sums at the m+1 queries s_1..s_m, n
    (G, 48, m+1), the query lanes and the zero-query mask (G, m+1). The
    group's O(G·n) transients die here, before the next group starts: the
    sort's permutation (4 bytes a point and window) and its sorted digits
    (4, written only where the segment starts read them: not with "hist",
    which counts the unsorted digits), then the sort's scratch (8, freed as
    it returns) or the 48-row scan output (192), GROUP_BYTES_PER_POINT
    (200) at the peak, which `window_group_size` keeps within 1/8 of the
    card's memory (about 3.4 GB for 16 windows at 2^20; at 2^24 a group of
    three windows holds about 10 GB)."""
    with span("tpu_msm_torch.pippenger.group"):
        m = cfg.buckets_per_window()
        g = digits.shape[0]
        lanes = cfg.scan_lanes
        steps = digits.shape[1] // lanes
        # "hist" is order-free: it counts the unsorted digits.
        hist_starts = cfg.segment_starts == "hist"
        sorted_digits, perm = sort.digit_sort(digits, sort.key_bits(m),
                                              want_keys=not hist_starts)
        ys = scan_madd_sorted(perm, rows, negm, lanes).view(
            g, 48, steps * lanes)  # one launch
        del perm
        starts = _segment_starts(digits if hist_starts else sorted_digits, m,
                                 cfg)
        queries = torch.cat([starts, starts.new_full((g, 1), n)], dim=1)
        is_zero = queries == 0
        pos = queries.clamp(min=1) - 1
        lq = pos // steps
        # Column k*lanes + l of the flat prefix array is step k of lane l.
        flat = ((pos % steps) * lanes + lq).to(torch.int64)
        loc48 = torch.gather(ys, 2, flat[:, None].expand(g, 48, m + 1))
        # A copy, not a view: a view would keep the group's whole prefix
        # array alive until the sides stage (16 x 201 MB at 2^20).
        totals = ys[:, :, (steps - 1) * lanes:].clone()
        return totals, loc48, lq, is_zero


def _win_roll(a, wins: int, sh: int, seg: int):
    """torch.roll along the last axis within each of `wins` equal segments
    of length `seg` (lanes never cross window boundaries)."""
    shp = a.shape
    return torch.roll(a.reshape(shp[:-1] + (wins, seg)), sh, dims=-1).reshape(shp)


def _window_tail(x_n: ProjPoint, sum_starts: ProjPoint,
                 cfg: MsmConfig) -> ProjPoint:
    """The (16, W) window sums M·X(n) - sum_b X(s_b) (window_tail kernel)."""
    return ProjPoint(*window_tail(
        *(a.contiguous() for a in (*x_n, *sum_starts)), cfg.window_bits,
        cfg.signed_digits))


def _sides_batched(groups, cfg: MsmConfig) -> ProjPoint:
    """All windows' side stages as full-width batched ops
    (`pippenger.py:374-482`). `groups` holds _window_heavy's outputs, one
    tuple a group of windows, which are concatenated here first (inside the
    stage's span): totals48 (W, 48, L), loc48 (W, 48, Q), lq (W, Q),
    is_zero (W, Q). Returns (W, 16, 1) window sums."""
    with span("tpu_msm_torch.pippenger.sides"):
        totals48, loc48, lq, is_zero = (torch.cat(s) for s in zip(*groups))
        w, _, lanes = totals48.shape
        q = loc48.shape[-1]
        m = cfg.buckets_per_window()
        dev = totals48.device

        def rows(a, s, width):  # (W, 48, X) -> (16, W*X) for one coordinate
            return a[:, s].permute(1, 0, 2).reshape(16, w * width)

        # Inter-lane inclusive scan, all windows at once, window-local rolls.
        t = ProjPoint(*(rows(totals48, s, lanes) for s in _XYZ))
        lane_idx = torch.arange(lanes, device=dev).repeat(w)
        for i in range(_ceil_log2(lanes)):
            sh = 1 << i
            rolled = ProjPoint(*(_win_roll(a, w, sh, lanes) for a in t))
            t = curve.select_point(lane_idx >= sh, ec_add(t, rolled), t)
        carry = curve.select_point(
            lane_idx >= 1, ProjPoint(*(_win_roll(a, w, 1, lanes) for a in t)),
            curve.proj_infinity((w * lanes,), dev))  # exclusive lane carries

        # Lane carry at each query's lane plus the in-lane prefix: X(s_b).
        idx = lq.to(torch.int64)[None].expand(16, w, q)
        car = ProjPoint(*(a.reshape(16, w, lanes).gather(2, idx)
                          .reshape(16, w * q) for a in carry))
        local = ProjPoint(*(rows(loc48, s, q) for s in _XYZ))
        xvals = curve.select_point(is_zero.reshape(-1),
                                   curve.proj_infinity((w * q,), dev),
                                   ec_add(car, local))
        xv = ProjPoint(*(a.reshape(16, w, q) for a in xvals))
        x_n = ProjPoint(*(a[:, :, m] for a in xv))  # (16, W)

        # Each window's X(s_b) batch, padded to a power of two with infinities.
        m_pad = 1 << _ceil_log2(m)
        x_starts = ProjPoint(*(a[:, :, :m] for a in xv))
        if m_pad != m:
            inf = curve.proj_infinity((w, m_pad - m), dev)
            x_starts = ProjPoint(*(torch.cat([a, b], dim=-1)
                                   for a, b in zip(x_starts, inf)))
        m = m_pad

        # Fold each window's batch down to `fanout` lanes, then a window-local
        # rolled tree; lane 0 of each window ends with the window's sum.
        fanout = 1 << (cfg.reduce_fanout.bit_length() - 1)
        if m > fanout:
            steps_f = m // fanout
            pts = ProjPoint(*fold_add(*(
                a.reshape(16, w, fanout, steps_f).permute(0, 3, 1, 2)
                .reshape(16, steps_f, w * fanout).contiguous()
                for a in x_starts)))
            width = fanout
        else:
            pts = ProjPoint(*(a.reshape(16, w * m) for a in x_starts))
            width = m
        for i in range(_ceil_log2(width)):
            rolled = ProjPoint(*(_win_roll(a, w, -(1 << i), width)
                                 for a in pts))
            pts = ec_add(pts, rolled)
        sum_starts = ProjPoint(*(a.reshape(16, w, width)[:, :, 0]
                                 for a in pts))

        # window_sum = M·X(n) - sum_b X(s_b), all windows in one launch.
        out = _window_tail(x_n, sum_starts, cfg)  # (16, W)
        return ProjPoint(*(a.permute(1, 0)[:, :, None] for a in out))


# --------------------------------------------------------------------------
# The per-window route (`pippenger.py:150-217,485-568`).
# --------------------------------------------------------------------------

def _lane_inclusive_scan(totals: ProjPoint, lanes: int) -> ProjPoint:
    """Hillis–Steele inclusive EC scan across the lane axis (last axis)."""
    lane_idx = torch.arange(lanes, device=totals.x.device)
    t = totals
    for i in range(_ceil_log2(lanes)):
        sh = 1 << i
        rolled = ProjPoint(*(torch.roll(a, sh, dims=-1) for a in t))
        t = curve.select_point(lane_idx >= sh, ec_add(t, rolled), t)
    return t


def _sequential_fold(pts: ProjPoint, lanes: int, steps: int) -> ProjPoint:
    """(16, lanes*steps) -> (16, lanes): lane i sums points
    [i*steps, (i+1)*steps), the jnp association (`pippenger.py:176-182`),
    through the fold_add kernel on a (16, steps, lanes) layout."""
    return ProjPoint(*fold_add(*(
        a.reshape(16, lanes, steps).transpose(1, 2).contiguous()
        for a in pts)))


def _roll_reduce(pts: ProjPoint, width: int) -> ProjPoint:
    """EC sum of (16, width) -> (16, 1) by log2(width) full-width rolled
    adds; lane 0 ends with the total."""
    for i in range(_ceil_log2(width)):
        rolled = ProjPoint(*(torch.roll(a, -(1 << i), dims=-1) for a in pts))
        pts = ec_add(pts, rolled)
    return ProjPoint(*(a[..., :1] for a in pts))


def ec_reduce(pts: ProjPoint, fanout: int) -> ProjPoint:
    """EC sum of a (16, B) batch -> (16, 1): pad to a power of two with
    infinities, fold down to `fanout` lanes (rounded down to a power of
    two, as the fold's grouping needs; the JAX package takes only such
    fanouts here), then a rolled tree."""
    fanout = 1 << (fanout.bit_length() - 1)
    b = pts.x.shape[-1]
    b_pad = 1 << _ceil_log2(max(b, 1))
    if b_pad != b:
        inf = curve.proj_infinity((b_pad - b,), pts.x.device)
        pts = ProjPoint(*(torch.cat([a, i], dim=-1) for a, i in zip(pts, inf)))
        b = b_pad
    if b > fanout:
        pts = _sequential_fold(pts, fanout, b // fanout)
        b = fanout
    return _roll_reduce(pts, b)


def _msm_window(digits, negm, px, py, n: int, cfg: MsmConfig) -> ProjPoint:
    """One window's sum, (16, 1). digits: (n_pad,) with the m+1 sentinel at
    the padding; negm: (n_pad,) negation mask or None; px: (16, n+1) and
    py: ((16, n+1), (16, n+1) or None), the coordinates (y and -y) with an
    infinity column appended, which the padding positions point at."""
    m = cfg.buckets_per_window()
    n_pad = digits.shape[0]
    lanes = cfg.scan_lanes
    steps = n_pad // lanes
    dev = digits.device

    if negm is None:
        py_w = py[0]
    else:
        negm_cols = torch.cat([negm[:n], negm.new_zeros(1)])
        py_w = torch.where(negm_cols[None, :], py[1], py[0])
    # lax.sort_key_val(digits, min(i, n)) is stable: its values are the
    # stable order with the padding positions sent to column n.
    sorted_digits, order = sort.digit_sort(digits, sort.key_bits(m),
                                           want_keys=True)
    sorted_idx = order.clamp(max=n)
    # Lane l scans sorted positions [l*steps, (l+1)*steps); step k of every
    # lane is one contiguous (16, lanes) operand.
    perm = sorted_idx.reshape(lanes, steps).t().reshape(-1)

    def lay(a):
        return (a.index_select(1, perm).reshape(16, steps, lanes)
                .transpose(0, 1).contiguous())

    gx, gy = lay(px), lay(py_w)

    acc = curve.proj_infinity((lanes,), dev)
    prefix = []
    for k in range(steps):  # one pmadd launch per step, as lax.scan runs it
        acc = ec_madd(acc, AffinePoint(gx[k], gy[k]))
        prefix.append(acc)
    ys = ProjPoint(*(torch.stack(c, dim=1) for c in zip(*prefix)))
    del gx, gy, prefix

    inc = _lane_inclusive_scan(acc, lanes)
    lane_idx = torch.arange(lanes, device=dev)
    carry = curve.select_point(
        lane_idx >= 1, ProjPoint(*(torch.roll(a, 1, dims=-1) for a in inc)),
        curve.proj_infinity((lanes,), dev))  # exclusive lane carries

    starts = _segment_starts(sorted_digits[None], m, cfg)[0]
    queries = torch.cat([starts, starts.new_full((1,), n)])  # s_1..s_m, n
    is_zero = queries == 0
    pos = queries.clamp(min=1).to(torch.int64) - 1
    lq = pos // steps
    kq = pos % steps
    local = ProjPoint(*(a[:, kq, lq] for a in ys))
    lane_carry = ProjPoint(*(a[:, lq] for a in carry))
    xvals = curve.select_point(
        is_zero, curve.proj_infinity((queries.shape[0],), dev),
        ec_add(lane_carry, local))

    x_n = ProjPoint(*(a[:, m:m + 1] for a in xvals))
    sum_starts = ec_reduce(ProjPoint(*(a[:, :m] for a in xvals)),
                           cfg.reduce_fanout)
    return _window_tail(x_n, sum_starts, cfg)


# --------------------------------------------------------------------------
# Window sums: shared set-up, the two routes, the rule between them.
# --------------------------------------------------------------------------

def _scan_lanes(n: int, cfg: MsmConfig) -> int:
    return min(cfg.scan_lanes, 1 << _ceil_log2(max(n, 1)))


def _pad_cols(a, pad: int, value):
    if not pad:
        return a
    return torch.cat([a, a.new_full((*a.shape[:-1], pad), value)], dim=-1)


def _glv_split(points: AffinePoint, scalar_limbs, cfg: MsmConfig):
    """The GLV split (`pippenger.py:583-598`): 2n points (P_i, then
    phi(P_i) = (BETA·x, y)), the 2n magnitudes |k1|, |k2| below 2^127, their
    (2n,) negation mask, and cfg for 127-bit scalars without glv."""
    if not cfg.signed_digits or cfg.scalar_bits != 254:
        raise ValueError("glv requires signed_digits and scalar_bits=254")
    m1, s1, m2, s2 = glv.decompose_limbs(scalar_limbs)
    phix = field.mont_mul_const(points.x, glv.BETA_MONT)
    points = AffinePoint(torch.cat([points.x, phix], dim=1),
                         torch.cat([points.y, points.y], dim=1))
    cfg = dataclasses.replace(cfg, glv=False, scalar_bits=glv.GLV_BITS)
    return points, torch.cat([m1, m2], dim=1), torch.cat([s1, s2]), cfg


def _digits(points: AffinePoint, scalar_limbs, cfg: MsmConfig):
    """Set-up both routes share: the GLV split when cfg.glv, the scan
    lanes for n, the (W, n_pad) digits with the sentinel m+1 on the padding
    (it sorts last and its bin is dropped), the negation masks and -y
    (signed digits) or None. Returns (points, cfg with the lanes, n,
    digits, negm, y_neg); n and the points are the split's 2n with glv."""
    n = points.x.shape[1]
    if scalar_limbs.shape[1] != n:
        raise ValueError(f"points ({n}) and scalars ({scalar_limbs.shape[1]}) "
                         "differ in count")
    glv_neg = None
    if cfg.glv:
        points, scalar_limbs, glv_neg, cfg = _glv_split(points, scalar_limbs,
                                                        cfg)
        n = 2 * n
    lanes = _scan_lanes(n, cfg)
    pad = lanes * -(-n // lanes) - n
    cfg = dataclasses.replace(cfg, scan_lanes=lanes)
    if cfg.signed_digits:
        digits, negm = signed_window_digits(scalar_limbs, cfg)
        if glv_neg is not None:  # a negative GLV half negates every digit
            negm = negm ^ glv_neg[None, :]
        negm = _pad_cols(negm, pad, False)
        y_neg = field.neg_mod(points.y)  # for negative digits; -0 stays 0
    else:
        digits, negm, y_neg = window_digits(scalar_limbs, cfg), None, None
    return points, cfg, n, _pad_cols(digits, pad, cfg.buckets_per_window()
                                     + 1), negm, y_neg


def scan_operands(points: AffinePoint, scalar_limbs, cfg: MsmConfig):
    """What the fused route sorts: (cfg with the lanes, n, digits (W,
    n_pad), negm (W, n_pad) or None, rows), as `_sorted_scan_inputs` takes
    them a group of windows at a time. rows is the point-major table of the
    packed words (`pack_u16_rows`), one row a point: (n_pad, 16) [x | y],
    or (n_pad, 24) [x | y | -y] with signed digits, built once a call (64
    or 96 bytes a point) by one `pack_rows` launch, so that each window's
    layout reads a point as one 64-byte row."""
    with span("tpu_msm_torch.pippenger.operands"):
        points, cfg, n, digits, negm, y_neg = _digits(points, scalar_limbs,
                                                      cfg)
        # The padding positions carry the (0, 0) affine infinity: the scan
        # skips it.
        rows = pack_rows(points.x, points.y, y_neg, digits.shape[1])
        return cfg, n, digits, negm, rows


def _fused_sums(points: AffinePoint, scalar_limbs, cfg: MsmConfig) -> ProjPoint:
    """Window sums (W, 16, 1) by the fused route: `_window_heavy` over
    groups of `window_group_size` windows, then `_sides_batched`."""
    cfg, n, digits, negm, rows = scan_operands(points, scalar_limbs, cfg)
    w, n_pad = digits.shape
    group = window_group_size(w, n_pad, digits.device)
    smalls = [_window_heavy(digits[s:s + group],
                            None if negm is None else negm[s:s + group],
                            rows, n, cfg)
              for s in range(0, w, group)]
    return _sides_batched(smalls, cfg)


def _per_window_sums(points: AffinePoint, scalar_limbs,
                     cfg: MsmConfig) -> ProjPoint:
    """Window sums (W, 16, 1) by the per-window route, one `_msm_window`
    each."""
    points, cfg, n, digits, negm, y_neg = _digits(points, scalar_limbs, cfg)
    inf = field.zero((1,), points.x.device)
    px = torch.cat([points.x, inf], dim=1)
    py = (torch.cat([points.y, inf], dim=1),
          None if y_neg is None else torch.cat([y_neg, inf], dim=1))
    wins = [_msm_window(digits[i], None if negm is None else negm[i],
                        px, py, n, cfg)
            for i in range(cfg.num_windows())]
    return ProjPoint(*(torch.stack(c) for c in zip(*wins)))


def window_sums(points: AffinePoint, scalar_limbs: torch.Tensor,
                cfg: MsmConfig) -> ProjPoint:
    """Per-window sums sum_b b·bucket_b for every window, (W, 16, 1), by the
    route the scan lanes select for the points after the GLV split (module
    docstring); with cfg.glv, W is that of 127-bit scalars.

    points: (16, N) int32 Montgomery affine coordinates; scalar_limbs:
    (16, N) int32 standard-form scalars below 2^cfg.scalar_bits."""
    n = points.x.shape[1] * (2 if cfg.glv else 1)
    if fused_route(_scan_lanes(n, cfg)):
        return _fused_sums(points, scalar_limbs, cfg)
    return _per_window_sums(points, scalar_limbs, cfg)


def horner_fold(wsums: ProjPoint, c: int) -> ProjPoint:
    """Fold (W, 16, 1) window sums into the (16, 1) MSM result, top window
    first, c doublings between windows: one horner kernel launch."""
    with span("tpu_msm_torch.pippenger.horner"):
        return ProjPoint(*horner(*(a.contiguous() for a in wsums), c))


def msm_projective(points: AffinePoint, scalar_limbs: torch.Tensor,
                   cfg: MsmConfig | None = None) -> ProjPoint:
    """sum_i scalars[i] * points[i] as a (16, 1) projective point."""
    if cfg is None:
        cfg = select_config(points.x.shape[1], points.x.device)
    return horner_fold(window_sums(points, scalar_limbs, cfg), cfg.window_bits)
