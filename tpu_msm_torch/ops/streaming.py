"""Chunked (streamed) MSM (counterpart of `tpu_msm/ops/streaming.py:36-113`).

Window sums are linear over the (point, digit) multiset, so the MSM of n
points is the Horner fold of the sum of its chunks' window sums. Each chunk
of 2^chunk_log points runs `pippenger.window_sums` with one configuration
for all chunks; the (W, 16, 1) sums accumulate on the device, one `padd`
launch a chunk at width W (`cuda_curve.kernel_path` gives the group kernel
there); one `horner_fold` ends it. The chunk bounds the pipeline's
transients (`pippenger.window_group_size` sizes each chunk's window groups
by the chunk, not by n).

Where the inputs live while the chunks run:

* resident: the whole input is put on the device once and sliced;
* host-streamed (on the card): each chunk is copied in turn through two
  pinned staging buffers on a side stream, so that the next chunk's copy
  overlaps this chunk's compute (the JAX package leaves this to XLA's async
  dispatch). Each buffer is refilled only after the event recorded behind
  its last copy has fired, and each chunk's compute waits for its copy's
  event. On the CPU the input already lies where the pipeline runs, and
  both settings slice it there.

While a profiler records, each chunk opens the span
`tpu_msm_torch.streaming.chunk` (its slices or staging, then its window
sums) and each accumulate `tpu_msm_torch.streaming.accumulate`
(`utils/profiling.span`).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_msm_torch.models.bn254 import LIMBS
from tpu_msm_torch.ops import pippenger
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint
from tpu_msm_torch.utils import interop
from tpu_msm_torch.utils.config import MsmConfig, select_config
from tpu_msm_torch.utils.profiling import span

# Device bytes of one input point: x, y and the scalar, 16 int32 limbs each.
INPUT_BYTES_PER_POINT = 3 * LIMBS * 4
# A chunk's working set beside the resident inputs, over and above its
# window groups' transients (`pippenger.group_budget`), in bytes a point of
# the chunk: its padded copy of the inputs' slices, digits and sums. On an
# H100 80GB HBM3 at chunks of 2^22 the peak `max_memory_allocated` of a
# resident 2^24 call was 13456 MiB: 3072 MiB of inputs, 9648 MiB of
# transients (G = 9 windows of 268 B a point), 736 MiB more, 184 B a point
# (chip_smoke.py phase 11). 256 keeps a margin over that.
CHUNK_BYTES_PER_POINT = 256
# The share of the card's memory the default leaves free beside the
# inputs and one chunk's working set (the caching allocator's slack).
FREE_SHARE = 1 / 8
# Host inputs of at most this many chunks go to the card whole by default;
# more are host-streamed. From numpy on an H100 80GB HBM3 in chunks of
# 2^22 (`benches/dispatch_benchmark.py --stream`), resident against
# host-streamed, ms: 2 chunks 348.0-392.7 against 360.0-483.0; 4 chunks
# 746.3-843.1 against 760.1-792.8; 8, 16 and 32 chunks 1634.8-1804.9,
# 2886.6-3140.1 and 6486.4-7404.9 against 1441.9-1589.7, 2433.8-2665.1 and
# 5868.3-6056.7. Both are bound by the host's copy; streaming hides all
# but the first chunk's behind the compute, the whole copy does not.
RESIDENT_MAX_CHUNKS = 4


def resident_by_default(n: int, chunk: int, device) -> bool:
    """Whether msm_streamed puts n host input points on the card whole when
    not told, in chunks of `chunk` points.

    On the card iff n is at most RESIDENT_MAX_CHUNKS chunks and the inputs
    and one chunk's working set fit in all but FREE_SHARE of the card's
    memory (`torch.cuda.get_device_properties(device).total_memory`):
    n · INPUT_BYTES_PER_POINT + `pippenger.group_budget(device)` + chunk ·
    CHUNK_BYTES_PER_POINT <= (1 - FREE_SHARE) · total_memory. On an 80 GB
    H100 with chunks of 2^22, up to 2^24 points. Always on the CPU, where
    the input already lies in the memory the pipeline uses."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    total = torch.cuda.get_device_properties(device).total_memory
    need = (n * INPUT_BYTES_PER_POINT + pippenger.group_budget(device)
            + chunk * CHUNK_BYTES_PER_POINT)
    return n <= RESIDENT_MAX_CHUNKS * chunk and need <= (1 - FREE_SHARE) * total


def accumulate(acc: ProjPoint, ws: ProjPoint) -> ProjPoint:
    """acc + ws for (W, 16, 1) window sums, one padd launch at width W (the
    JAX `_accumulate`, a vmap of proj_add over the windows)."""
    w = acc.x.shape[0]

    def rows(p):  # (W, 16, 1) -> (16, W)
        return ProjPoint(*(a.reshape(w, LIMBS).t() for a in p))

    with span("tpu_msm_torch.streaming.accumulate"):
        out = pippenger.ec_add(rows(acc), rows(ws))
        return ProjPoint(*(a.t().reshape(w, LIMBS, 1).contiguous()
                           for a in out))


def _resident_chunks(arrays, starts: range, device):
    """The chunks as (px, py, scalars) slices of the input, put on `device`
    once, one at each of `starts` (range(0, n, chunk)); the last one padded
    with zero scalars on the (0, 0) infinity."""
    n, chunk = starts.stop, starts.step
    whole = interop.limbs_to_device(*arrays, device)
    for lo in starts:
        hi = min(lo + chunk, n)
        yield tuple(pippenger._pad_cols(a[:, lo:hi], lo + chunk - hi, 0)
                    .contiguous() for a in whole)


def _host_chunks(arrays, starts: range, device):
    """The chunks as (px, py, scalars) tensors on the card, one at each of
    `starts`, copied from the host (uint32 numpy) one at a time, padded as
    _resident_chunks pads.

    Two pinned staging buffers of (3, 16, chunk) and a copy stream. Chunk i
    is written into buffer i % 2 once the event behind that buffer's
    previous copy has fired, then copied with non_blocking=True on the copy
    stream, which records a new event; the compute stream waits for that
    event before it uses the chunk. The generator stages chunk i + 1 only
    after the caller has enqueued chunk i's compute, so the copy overlaps
    it."""
    n, chunk = starts.stop, starts.step
    compute = torch.cuda.current_stream(device)
    copier = torch.cuda.Stream(device)
    staging = [torch.empty((3, LIMBS, chunk), dtype=torch.int32,
                           pin_memory=True) for _ in range(2)]
    copied = [None, None]  # the event behind each buffer's last copy

    def stage(i):
        k = i % 2
        if copied[k] is not None:
            copied[k].synchronize()  # the buffer's previous copy is done
        lo = starts[i]
        hi = min(lo + chunk, n)
        buf = staging[k].numpy()
        for j, a in enumerate(arrays):
            buf[j, :, :hi - lo] = a[:, lo:hi].view(np.int32)
            buf[j, :, hi - lo:] = 0
        with torch.cuda.stream(copier):
            dev_chunk = staging[k].to(device, non_blocking=True)
            copied[k] = torch.cuda.Event()
            copied[k].record(copier)
        return dev_chunk, copied[k]

    ahead = stage(0)
    for i in range(len(starts)):
        dev_chunk, event = ahead
        compute.wait_event(event)
        # Made on the copy stream, used on the compute stream: the caching
        # allocator must not hand its memory out until the compute is done.
        dev_chunk.record_stream(compute)
        yield tuple(dev_chunk)
        if i + 1 < len(starts):
            ahead = stage(i + 1)
    for event in copied:  # no buffer is released with a copy in flight
        if event is not None:
            event.synchronize()


def msm_streamed(px, py, scalars, cfg: MsmConfig | None = None,
                 chunk_log: int = 20, resident: bool | None = None,
                 device=None) -> ProjPoint:
    """MSM over (16, N) limb arrays, chunked at 2^chunk_log points.

    px, py: Montgomery affine coordinates; scalars: standard form; each
    uint32 numpy or an int32 tensor (`interop.limb_tensor`). `device` is
    where the pipeline runs (None means "cuda"). With N <= 2^chunk_log one
    `window_sums` and one `horner_fold` run, with `select_config(N)` unless
    cfg is given. Otherwise the last chunk is padded with zero scalars on
    the (0, 0) infinity point, every chunk runs with
    cfg or `select_config(2^chunk_log)`, and the window sums accumulate
    (`accumulate`) before one `horner_fold`.

    resident=True puts the whole input on the device once and slices it;
    resident=False copies each chunk from the host in turn (see
    _host_chunks; tensors are first brought to the host). None keeps inputs
    that all lie on `device` as tensors where they are, and decides the
    others by size (`resident_by_default`). On the CPU both settings slice
    the input where it lies. Returns a ProjPoint of (16, 1) tensors on the
    device."""
    dev = interop.resolve_device(device)
    arrays = tuple(a if isinstance(a, torch.Tensor) else
                   np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
                   for a in (px, py, scalars))
    n = arrays[0].shape[1]
    chunk = 1 << chunk_log
    if n <= chunk:
        cfg = cfg or select_config(n, dev)
        dpx, dpy, dsl = interop.limbs_to_device(*arrays, dev)
        return pippenger.horner_fold(
            pippenger.window_sums(AffinePoint(dpx, dpy), dsl, cfg),
            cfg.window_bits)

    cfg = cfg or select_config(chunk, dev)
    if resident is None:
        resident = (all(_lies_on(a, dev) for a in arrays)
                    or resident_by_default(-(-n // chunk) * chunk, chunk, dev))
    # One range of chunk starts, which the generator and the loop both step.
    starts = range(0, n, chunk)
    if resident or dev.type != "cuda":
        chunks = _resident_chunks(arrays, starts, dev)
    else:
        chunks = _host_chunks(
            tuple(interop.tensor_to_limbs(a) if isinstance(a, torch.Tensor)
                  else a for a in arrays), starts, dev)
    acc = None
    for _ in starts:
        # The chunk's span holds the generator's step: its slices, padding
        # and copy (or the host route's staging), then its window sums.
        with span("tpu_msm_torch.streaming.chunk"):
            cx, cy, cs = next(chunks)
            ws = pippenger.window_sums(AffinePoint(cx, cy), cs, cfg)
        acc = ws if acc is None else accumulate(acc, ws)
    next(chunks, None)  # the generator's end: the host route's last waits
    return pippenger.horner_fold(acc, cfg.window_bits)


def _lies_on(a, device: torch.device) -> bool:
    """Whether `a` is a tensor on `device` (any index where it names none)."""
    return (isinstance(a, torch.Tensor) and a.device.type == device.type
            and device.index in (None, a.device.index))
