"""idle_share: the share, in %, of the traced window (the first call's start
to the last call's end) in which no kernel, copy or set runs."""


def read(rec):
    if rec.trace is None or not rec.trace.device or rec.trace.window_s <= 0:
        return None
    return 100 * (1 - rec.trace.busy_s() / rec.trace.window_s)
