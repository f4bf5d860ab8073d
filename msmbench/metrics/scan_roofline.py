"""scan_roofline: the least time of the bucket accumulation these inputs
need (`roofline.accumulation_s`: one mixed addition a nonzero digit, at the
card's 32-bit multiply rate, or its bytes, whichever binds), over the
device time a call of the kernels that do it, in %. Those are the kernels
named `*scan_madd*` (today `scan_madd_sorted_kernel`); where none runs the
metric is left out."""

from msmbench import roofline
from msmbench.trace import short_name


def read(rec):
    if rec.trace is None or not rec.trace.calls:
        return None
    scan = [e for e in rec.trace.kernels() if "scan_madd" in short_name(e["name"])]
    spent = rec.trace.seconds(scan) / rec.trace.calls
    least = rec.mean_over(rec.trace_sets, lambda d: roofline.accumulation_s(
        d, rec.n, rec.scalar_bits, rec.window_bits))
    if not spent or least is None:
        return None
    return 100 * least / spent
