"""setup_s: from the process's start to the first timed call (imports, the
CUDA context, the kernel library's load or build, the inputs, two warm
calls)."""


def read(rec):
    return rec.setup_s
