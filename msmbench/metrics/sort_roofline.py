"""sort_roofline: the least time of sorting every window's digits
(`roofline.sort_s`: each key read once and its int32 index written once, at
HBM's rate), over the device time a call of the radix sort's kernels
(`radix_*`), in %; left out where none runs."""

from msmbench import roofline
from msmbench.trace import short_name


def read(rec):
    if rec.trace is None or not rec.trace.calls:
        return None
    sort = [e for e in rec.trace.kernels()
            if short_name(e["name"]).startswith("radix_")]
    spent = rec.trace.seconds(sort) / rec.trace.calls
    if not spent:
        return None
    return 100 * roofline.sort_s(rec.n, rec.scalar_bits, rec.window_bits) / spent
