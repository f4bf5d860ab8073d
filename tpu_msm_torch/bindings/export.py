"""Ahead-of-time export of the device MSM with `torch.export` (counterpart
of `tpu_msm/bindings/export.py`).

`export_msm` traces `msm_device` at one size and one configuration into an
ExportedProgram and serializes it (`torch.export.save`, a .pt2 archive);
`load_msm` gives it back as a callable, for a serving process that skips
this package's tracing path (the digit recoding, the route rule, the
window groups and every other choice made in Python at trace time).

    data = export_msm(1 << 20, path="msm_log20.pt2")      # build time
    fn = load_msm("msm_log20.pt2"); x, y, z = fn(px, py, sl)   # serving time

What the artifact holds: the graph of torch operations of one call at
(16, n) int32 inputs, its constants (not its example inputs), and the calls
of the port's kernels as the operators `tpu_msm_torch::<kernel>`
(ops/library.py), each with the choices the wrappers made at export time
(which kernel of two, the histogram's launch plan) as its arguments. It does not hold the kernels:
unlike the JAX artifact, which embeds its compiled kernels, a .pt2 names
operators, so the loading process needs `tpu_msm_torch` importable;
`load_msm` registers the operators before it loads. On the card they launch
the kernels of this checkout's build (`_build.load`).

Which device it runs on: the one it was exported on. An artifact exported
on CUDA tensors runs on CUDA tensors and launches the kernels; one exported
on the CPU runs the plain versions. `device=None` means "cuda", and raises
without a card, as every entry point of the package does.
"""

from __future__ import annotations

import io
from pathlib import Path

import torch

from tpu_msm_torch.models import bn254
from tpu_msm_torch.ops import library
from tpu_msm_torch.utils import interop
from tpu_msm_torch.utils.config import MsmConfig, select_config


class _MsmModule(torch.nn.Module):
    def __init__(self, cfg: MsmConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, px, py, scalar_limbs):
        from tpu_msm_torch import msm_device

        # A plain (x, y, z) tuple: the artifact must not depend on
        # ProjPoint being registered as a pytree in the loader.
        return tuple(msm_device(px, py, scalar_limbs, self.cfg))


def export_msm(n: int, cfg: MsmConfig | None = None,
               path: str | Path | None = None, device=None) -> bytes:
    """Export the (px, py, scalar_limbs) -> (x, y, z) MSM at size n on
    `device` with `cfg` (default `select_config(n, device)`): (16, n) int32
    inputs, three (16, 1) int32 outputs as `msm_device` returns them.
    Returns the serialized bytes; writes them to `path` when given."""
    dev = interop.resolve_device(device)
    cfg = cfg or select_config(n, dev)
    example = tuple(torch.zeros((bn254.LIMBS, n), dtype=torch.int32,
                                device=dev) for _ in range(3))
    program = torch.export.export(_MsmModule(cfg), example, strict=False)
    # Not kept: the example inputs (at 2^20 they are 192 MiB of zeros).
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(data)
    return data


def load_msm(src: str | Path | bytes):
    """Load an exported MSM from a path or its bytes; returns a callable
    (px, py, scalar_limbs) -> (x, y, z) on the device it was exported on.
    Registers the port's operators first, so it needs `tpu_msm_torch`
    importable."""
    library.register()
    f = io.BytesIO(src) if isinstance(src, (bytes, bytearray)) else src
    return torch.export.load(f).module()
