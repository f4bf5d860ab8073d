"""torch_ms: device ms a call of PyTorch's own kernels (named in PyTorch's
namespaces, `trace.is_torch_kernel`) in the traced stretch."""

from msmbench.trace import is_torch_kernel


def read(rec):
    if rec.trace is None or not rec.trace.calls or not rec.trace.device:
        return None
    mine = [e for e in rec.trace.kernels() if is_torch_kernel(e["name"])]
    return 1e3 * rec.trace.seconds(mine) / rec.trace.calls
