"""The port's card + CPU split (tpu_msm_torch.hybrid), on the CPU: the split
ladder against the JAX package's, `msm_hybrid(..., device="cpu")` against
the native engine and the oracle at each share, a failing CPU part
re-raised on the caller, and share 1.0 without the native engine.

The scalars lie below 2^64 and the device part runs eight c = 8 windows:
the split and the join are under test here, and every window costs the
plain EC ops seconds on the CPU. The `cuda` case runs full scalars with the
card's configuration:
    python -m pytest --noconftest -m cuda tests/test_torch_hybrid.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch import hybrid  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

CFG = MsmConfig(window_bits=8, scan_lanes=8, scalar_bits=64,
                signed_digits=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of narrow plain EC ops; beside other test workers torch's
    intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """64 seeded points and scalars below 2^64: (points, scalars, px, py,
    sl)."""
    rng = np.random.RandomState(101)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=64)]
    pts = [oracle.ec_mul(oracle.GEN, k) for k in ks]
    sc = [int.from_bytes(rng.bytes(8), "little") for _ in range(64)]
    px, py = interop.affine_points_to_limbs(pts)
    return pts, sc, px, py, interop.ints_to_limbs(sc)


def test_device_share_matches_jax():
    from tpu_msm.hybrid import device_share as jax_share

    for n in [1, 2, 1000, (1 << 18) - 1, 1 << 18, (1 << 20) - 1, 1 << 20,
              1 << 24]:
        assert hybrid.device_share(n) == jax_share(n)
    assert [hybrid.device_share(n) for n in (1 << 17, 1 << 19, 1 << 21)] \
        == [1 / 3, 1 / 2, 2 / 3]


@pytest.mark.parametrize("share", [1 / 3, 1 / 2, 1.0])
def test_msm_hybrid_matches_native_and_oracle(case, share):
    pts, sc, px, py, sl = case
    got = hybrid.msm_hybrid(px, py, sl, CFG, share=share, device="cpu")
    assert got == native.msm(px, py, sl) == oracle.msm(sc, pts)


def test_cpu_part_failure_is_reraised(case, monkeypatch):
    _, _, px, py, sl = case

    def broken(*a):
        raise ValueError("native engine failed")

    monkeypatch.setattr(native, "msm", broken)
    with pytest.raises(RuntimeError, match="CPU part") as err:
        hybrid.msm_hybrid(px[:, :16], py[:, :16], sl[:, :16], CFG,
                          share=0.5, device="cpu")
    assert isinstance(err.value.__cause__, ValueError)


def test_without_native_engine_the_device_takes_all(case, monkeypatch):
    pts, sc, px, py, sl = case
    monkeypatch.setattr(native, "available", lambda: False)

    def unused(*a):
        raise AssertionError("the native engine ran")

    monkeypatch.setattr(native, "msm", unused)
    got = hybrid.msm_hybrid(px[:, :16], py[:, :16], sl[:, :16], CFG,
                            share=0.5, device="cpu")
    assert got == oracle.msm(sc[:16], pts[:16])


@pytest.mark.cuda
def test_msm_hybrid_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(102)
    n = 1 << 12
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    sl = interop.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % bn254.FR
         for _ in range(n)])
    want = native.msm(px, py, sl)
    for share in (1 / 3, 1 / 2, 2 / 3, 1.0, None):
        assert hybrid.msm_hybrid(px, py, sl, share=share,
                                 device="cuda") == want
