"""msm_ms_p95: the 95th percentile of the wall time of every call in the
window, each ending with its point on the host (host clock). None below 20
calls, where no percentile of the 95th has a call beyond it."""

import statistics


def read(rec):
    if len(rec.call_s) < 20:
        return None
    return 1e3 * statistics.quantiles(rec.call_s, n=20, method="inclusive")[18]
