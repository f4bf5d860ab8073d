"""h2d_ms: device ms a call of the copies from host to device (`gpu_memcpy`
events named `Memcpy HtoD ...`) in the traced stretch: where the mix places
an input on the host, the program's copy of it to the card on every call.
Left out where the stretch holds no such copy."""


def read(rec):
    if rec.trace is None or not rec.trace.calls:
        return None
    copies = [e for e in rec.trace.device if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    if not copies:
        return None
    return 1e3 * rec.trace.seconds(copies) / rec.trace.calls
