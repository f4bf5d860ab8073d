"""launches: device kernels, copies and sets a call in the traced stretch
(an exact count where every call launches alike)."""


def read(rec):
    if rec.trace is None or not rec.trace.calls or not rec.trace.device:
        return None
    return len(rec.trace.device) / rec.trace.calls
