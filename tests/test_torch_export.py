"""The port's ahead-of-time export on the CPU (plain kernel versions), the
counterpart of tests/test_export.py: `tpu_msm_torch.bindings.export`
exports `msm_device` at a small configuration with `torch.export`, saves,
loads and runs it; the loaded program's (x, y, z) is bit-identical to
eager `msm_device`, and its affine point equals `tpu_msm.msm` on the JAX CPU
backend and the pure-Python oracle. The program also loads from its bytes
in a process that imports no jax.

Every kernel is an operator of the library `tpu_msm_torch`
(`ops/library.py`); `torch.library.opcheck` holds each one's schema and fake
implementation against its CPU implementation here. The CUDA
implementations are held by chip_smoke.py on the card (phase 17 runs an
exported program there).

The inputs and configuration are tests/test_torch_pippenger.py's `jax_case`
(seed 41, n = 256, c = 8 signed, 64 lanes, fanout 64: the per-window route),
so the JAX reference compiles one graph both files share through the
persistent compilation cache.
"""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_msm  # noqa: E402
import tpu_msm_torch  # noqa: E402
from tpu_msm.utils import oracle  # noqa: E402
from tpu_msm.utils.config import MsmConfig as JaxMsmConfig  # noqa: E402
from tpu_msm_torch.bindings import export, native  # noqa: E402
from tpu_msm_torch.ops import library  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

N = 256
SMALL = dict(window_bits=8, scan_lanes=64, reduce_fanout=64,
             signed_digits=True, segment_starts="hist")


def _inputs(seed, n):
    """tests/test_torch_pippenger.py's `_inputs`: n points k_i·G
    (Montgomery) and n scalars below r, as numpy limb arrays."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    scalars = [int.from_bytes(rng.bytes(32), "little") % oracle.FR
               for _ in range(n)]
    return px, py, interop.ints_to_limbs(scalars)


def _digest(xyz):
    return hashlib.sha256(b"".join(
        a.contiguous().numpy().tobytes() for a in xyz)).hexdigest()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the artifact (written to a path) and eager msm_device's
    (x, y, z) on them, computed once."""
    px, py, sl = _inputs(41, N)
    cfg = MsmConfig(**SMALL)
    path = tmp_path_factory.mktemp("export") / "msm.pt2"
    data = export.export_msm(N, cfg, path=path, device="cpu")
    args = interop.limbs_to_device(px, py, sl, "cpu")
    eager = tuple(tpu_msm_torch.msm_device(*args, cfg))
    return {"limbs": (px, py, sl), "args": args, "path": path, "data": data,
            "eager": eager}


def test_export_returns_the_bytes_it_writes(case):
    assert case["path"].read_bytes() == case["data"]
    assert len(case["data"]) > 1000


def test_loaded_program_matches_eager_jax_and_oracle(case):
    """Loaded from the path: bit for bit eager msm_device's three (16, 1)
    int32 tensors; as affine, tpu_msm.msm's and the oracle's point."""
    fn = export.load_msm(case["path"])
    got = fn(*case["args"])
    assert isinstance(got, tuple) and len(got) == 3
    for g, e in zip(got, case["eager"]):
        assert g.shape == (16, 1) and g.dtype == torch.int32
        assert torch.equal(g, e)
    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in got))
    px, py, sl = case["limbs"]
    want = tpu_msm.msm((jnp.asarray(px), jnp.asarray(py)), jnp.asarray(sl),
                       cfg=JaxMsmConfig(**SMALL))
    assert pt == want
    points = interop.limbs_to_affine_points(px, py)
    assert pt == oracle.msm(interop.limbs_to_ints(sl), points)


def test_loads_from_bytes_in_a_process_without_jax(case, tmp_path):
    """A fresh process that imports only the loader reads the artifact's
    bytes, runs it on the saved inputs and gives eager's bytes."""
    inputs = tmp_path / "inputs.pt"
    torch.save(case["args"], inputs)
    code = (
        "import hashlib, sys, torch\n"
        "from tpu_msm_torch.bindings.export import load_msm\n"
        f"fn = load_msm(open({str(case['path'])!r}, 'rb').read())\n"
        f"out = fn(*torch.load({str(inputs)!r}))\n"
        "assert 'jax' not in sys.modules and 'tpu_msm' not in sys.modules\n"
        "print(hashlib.sha256(b''.join(a.contiguous().numpy().tobytes() "
        "for a in out)).hexdigest())\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=Path(tpu_msm_torch.__file__).parents[1], timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == _digest(case["eager"])


def test_export_default_device_is_the_card(monkeypatch):
    """device=None means "cuda": without a card export_msm raises and never
    exports for the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_msm(8, MsmConfig(**SMALL))


def _op_cases():
    """Small CPU arguments for every operator: u16 limb rows (packed u32
    words for the scan and the layout), the launch arguments as the
    wrappers pass them on the CPU; horner at W = 1 too, where the plain
    result is the input; the layout and the sorted scan with and without
    masks."""
    rng = np.random.RandomState(11)

    def rows(*shape):
        return torch.from_numpy(rng.randint(0, 1 << 16, size=shape)
                                .astype(np.int32))

    def words(*shape):
        return torch.from_numpy(rng.randint(-(1 << 31), 1 << 31, size=shape,
                                            dtype=np.int64).astype(np.int32))

    e = [rows(16, 4) for _ in range(6)]
    digits = torch.from_numpy(rng.randint(0, 10, size=(2, 50))
                              .astype(np.int32))
    perm = torch.from_numpy(np.stack([rng.permutation(12) for _ in range(2)]))
    negm = torch.from_numpy(rng.rand(2, 12) < 0.5)
    return [
        ("scan_madd", (words(2, 8, 3, 4), words(2, 8, 3, 4))),
        ("scan_madd", (words(8, 3, 4), words(8, 3, 4))),
        ("padd", (*e, False)),
        ("window_tail", (*[rows(16, 2) for _ in range(6)], 3, True)),
        ("horner", (*[rows(2, 16, 1) for _ in range(3)], 2)),
        ("horner", (*[rows(1, 16, 1) for _ in range(3)], 2)),
        ("fold_add", (*[rows(16, 3, 4) for _ in range(3)], False)),
        ("pmadd", (*e[:5], False)),
        ("jac_madd", tuple(e[:5])),
        ("jac_add", tuple(e)),
        ("scan_madd_rows", (rows(16, 5, 4), rows(16, 5, 4), 2)),
        ("montmul_chain", (rows(16, 4), rows(16, 4), 2, 1, 2)),
        ("digit_hist", (digits, 8, 0, 0, 0, 0, 0)),
        ("scan_layout", (perm, words(12, 24), negm, 4)),
        ("scan_layout", (perm, words(12, 16), None, 3)),
        ("scan_madd_sorted", (perm, words(12, 24), negm, 4)),
        ("scan_madd_sorted", (perm, words(12, 16), None, 3)),
    ]


def test_every_kernel_has_an_operator():
    assert sorted({name for name, _ in _op_cases()}) == sorted(library.OPS)


@pytest.mark.parametrize("name,args", _op_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_operator_opcheck(name, args):
    """Schema, fake implementation (shapes, dtypes, strides) and dispatch of
    each operator against its CPU implementation."""
    op = getattr(torch.ops.tpu_msm_torch, name).default
    torch.library.opcheck(op, args)
