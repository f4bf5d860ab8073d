"""The port's C ABI (tpu_msm_torch.bindings.embed and
tpu_msm_torch/csrc/tpu_msm_torch_embed.cpp) on the CPU.

`msm_best_wire(..., device="cpu")` returns the JAX package's
`tpu_msm.bindings.embed.msm_best_wire` bytes, and raises its errors. The C
library and its smoke host program build with g++; the program, a host
that is not Python, reaches the MSM through `tpu_msm_best`, which runs on
the card: on a host without one it must return its error code with the
Python error printed, never compute on the CPU instead. The `cuda` case
runs the program on the card:
    python -m pytest --noconftest -m cuda tests/test_torch_embed.py
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch import _build  # noqa: E402
from tpu_msm_torch.bindings import embed, native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402


def _wire(scalars, points):
    """ints and affine points -> (scalar bytes, point bytes)."""
    sl = interop.ints_to_limbs(scalars)
    px, py = interop.affine_points_to_limbs(points)  # Montgomery (wire form)
    pxy = np.stack([interop.to_h2c_bytes(px), interop.to_h2c_bytes(py)],
                   axis=1)  # (n, 2, 32)
    return interop.to_h2c_bytes(sl).tobytes(), pxy.tobytes()


@pytest.fixture(scope="module")
def case():
    """24 points with a zero scalar, r - 1 and the point at infinity."""
    rng = np.random.RandomState(77)
    n = 24
    scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.FR
               for _ in range(n - 2)] + [0, bn254.FR - 1]
    ks = [int(k) for k in rng.randint(1, 1 << 20, size=n - 1)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    points = interop.limbs_to_affine_points(px, py) + [None]
    want = oracle.msm(scalars, points)
    return scalars, points, want


def _result(out: bytes):
    assert len(out) == 64
    return (int.from_bytes(out[:32], "little"),
            int.from_bytes(out[32:], "little"))


def test_msm_best_wire_matches_jax_embedding(case):
    from tpu_msm.bindings import embed as jembed

    scalars, points, want = case
    s, p = _wire(scalars, points)
    got = embed.msm_best_wire(s, p, device="cpu")
    assert got == jembed.msm_best_wire(s, p)
    assert _result(got) == want


def test_wire_errors():
    with pytest.raises(ValueError, match="n\\*32"):
        embed.msm_best_wire(bytes(31), bytes(64), device="cpu")
    with pytest.raises(ValueError, match="n\\*32"):
        embed.msm_best_wire(bytes(32), bytes(65), device="cpu")
    with pytest.raises(ValueError, match="2 scalars but 1 points"):
        embed.msm_best_wire(bytes(64), bytes(64), device="cpu")


def test_empty_and_all_zero_give_the_infinity_encoding():
    assert embed.msm_best_wire(b"", b"", device="cpu") == bytes(64)
    s, p = _wire([0, 0, 0], [oracle.ec_mul(oracle.GEN, k) for k in (2, 3, 4)])
    assert embed.msm_best_wire(s, p, device="cpu") == bytes(64)


def test_wire_call_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s, p = _wire([5], [oracle.GEN])
    with pytest.raises(RuntimeError, match="CUDA device"):
        embed.msm_best_wire(s, p)
    with pytest.raises(RuntimeError, match="CUDA device"):
        embed.benchmark_msm_best(4)


@pytest.fixture(scope="module")
def host():
    res = _build.build_embed()
    for path in (res["lib"], res["host"]):
        assert Path(path).exists(), path
    return res["host"]


def _run_host(host, scalars, points, timeout=300):
    s, p = _wire(scalars, points)
    return subprocess.run([host, str(len(scalars))],
                          input=f"{s.hex()}\n{p.hex()}\n", capture_output=True,
                          text=True, env=_build.embed_env(), timeout=timeout)


def test_c_library_builds_and_is_current(host):
    """build_embed builds the library and the host program with g++ and gcc, and
    a second call finds them current."""
    assert _build.build_embed()["built"] is False
    nm = subprocess.run(["nm", "-D", "--defined-only", _build.EMBED_LIB],
                        capture_output=True, text=True)
    if nm.returncode == 0:
        for sym in ("tpu_msm_init", "tpu_msm_best", "tpu_msm_benchmark",
                    "tpu_msm_shutdown"):
            assert sym in nm.stdout


def test_c_host_returns_the_error_code_without_a_card(host, case):
    """tpu_msm_best returns -2 with the RuntimeError printed: the C ABI's
    MSM runs on the card, and without one it fails rather than computing
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scalars, points, _ = case
    r = _run_host(host, scalars, points)
    assert r.returncode == 4, r.stderr[-2000:]
    assert "tpu_msm_best rc=-2" in r.stderr
    assert "RuntimeError" in r.stderr and "CUDA device" in r.stderr
    assert r.stdout == ""


@pytest.mark.cuda
def test_c_host_on_the_card(host, case):
    """The 24-point case (below CPU_THRESHOLD: msm_best's native engine) and
    4096 points (the card's pipeline), each against its reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scalars, points, want = case
    r = _run_host(host, scalars, points)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _result(bytes.fromhex(r.stdout.strip())) == want
    rng = np.random.RandomState(78)
    n = 4096
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.FR
               for _ in range(n)]
    r = _run_host(host, scalars, interop.limbs_to_affine_points(px, py))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _result(bytes.fromhex(r.stdout.strip())) == native.msm(
        px, py, interop.ints_to_limbs(scalars))
