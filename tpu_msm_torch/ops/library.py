"""The port's kernels as PyTorch operators: `torch.ops.tpu_msm_torch.<name>`.

One operator for each C entry point of the kernel library (`_build.load`),
all in the namespace `tpu_msm_torch`:

  operator        C entry (kernels)                  defined in
  scan_madd       tpu_msm_scan_madd                  ops/cuda_curve.py
  padd            tpu_msm_padd, tpu_msm_padd_group   ops/cuda_curve.py
  window_tail     tpu_msm_window_tail                ops/cuda_curve.py
  horner          tpu_msm_horner                     ops/cuda_curve.py
  fold_add        tpu_msm_fold_add,                  ops/cuda_curve.py
                  tpu_msm_fold_add_group
  pmadd           tpu_msm_pmadd, tpu_msm_pmadd_group ops/cuda_curve.py
  jac_madd        tpu_msm_jac_madd                   ops/cuda_curve.py
  jac_add         tpu_msm_jac_add                    ops/cuda_curve.py
  scan_madd_rows  tpu_msm_scan_madd_rows             ops/cuda_curve.py
  montmul_chain   tpu_msm_montmul_chain              ops/cuda_curve.py
  scan_layout     tpu_msm_scan_layout                ops/cuda_curve.py
  scan_madd_sorted tpu_msm_scan_madd_sorted          ops/cuda_curve.py
  digit_hist      tpu_msm_digit_hist                 ops/hist.py

Each operator has three implementations, registered by `define`:
  * CUDA: the kernel launch on the tensors' device and current stream, and
    the wrapper's launch counters (so that a program loaded by
    `bindings.export.load_msm` counts its launches too);
  * CPU: the plain PyTorch version beside the wrapper;
  * fake: the output shapes and dtypes alone, for `torch.export` and
    FakeTensor tracing.
There is no path from one device's implementation to another's: a kernel
that fails to build or to launch raises. No operator writes its inputs;
every output is a new tensor.

The choices a wrapper makes from the card (which of two kernels, the
histogram's launch plan, the chunks of scan_madd_rows) are operator
arguments, so an exported graph records them. The operators are registered
with the low-level `torch.library.Library` API, whose dispatch costs the
least host time of PyTorch's registration APIs; the wrappers in
`ops/cuda_curve.py` and `ops/hist.py` keep their names and signatures and
call the operators.
"""

from __future__ import annotations

import torch

NAMESPACE = "tpu_msm_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")

OPS = ("scan_madd", "padd", "window_tail", "horner", "fold_add", "pmadd",
       "jac_madd", "jac_add", "scan_madd_rows", "montmul_chain", "digit_hist",
       "scan_layout", "scan_madd_sorted")


def define(schema: str, *, cuda, cpu, fake) -> torch._ops.OpOverload:
    """Define the operator of `schema` with its CUDA, CPU and fake
    implementations; returns its overload, which the wrapper calls."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def register() -> None:
    """Import the modules that define the operators. A serialized program
    that names `tpu_msm_torch::<op>` loads only after this."""
    from tpu_msm_torch.ops import cuda_curve, hist  # noqa: F401
