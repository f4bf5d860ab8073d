"""peak_mem_mib: torch.cuda.max_memory_allocated over the window, reset
after set-up, in MiB: what the MSM leaves the prover for its other
buffers."""


def read(rec):
    if not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2**20
