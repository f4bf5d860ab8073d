"""The port's MSM end to end on the CPU (plain kernel versions):
tpu_msm_torch.msm / msm_best against tpu_msm.msm on the JAX CPU backend, the
pure-Python oracle and the native C++ engine, compared as affine points. At
these sizes the scan lanes fall outside the fused route's rule, so the port
takes the per-window route, as JAX on the CPU does (its window sums are
held bit for bit in tests/test_torch_window.py). The tests named `*_fused_route`
force the fused route, the main path on the card, through the same edge
cases and configurations.

The JAX reference runs at n = 256 with c = 8 (a c = 16 graph takes minutes
to compile on the CPU).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_msm  # noqa: E402
import tpu_msm_torch  # noqa: E402
from tpu_msm.ops import pippenger as jpip  # noqa: E402
from tpu_msm.utils import oracle  # noqa: E402
from tpu_msm.utils.config import MsmConfig as JaxMsmConfig  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import pippenger  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig, select_config  # noqa: E402

FR = bn254.FR
# The small configuration both packages run here: c = 8 signed windows,
# 64 scan lanes, fanout 64 (the port folds m = 128 buckets down to 64).
SMALL = dict(window_bits=8, scan_lanes=64, reduce_fanout=64,
             signed_digits=True, segment_starts="hist")


def _inputs(seed, n, zero_share=0.0):
    """Seeded numpy limb arrays: n points k_i·G (Montgomery) and n scalars
    below r, a `zero_share` of them zero."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR for _ in range(n)]
    for i in rng.permutation(n)[:int(zero_share * n)]:
        scalars[i] = 0
    return px, py, interop.ints_to_limbs(scalars)


@pytest.fixture(scope="module")
def jax_case():
    px, py, sl = _inputs(41, 256)
    want = tpu_msm.msm((jnp.asarray(px), jnp.asarray(py)), jnp.asarray(sl),
                       cfg=JaxMsmConfig(**SMALL))
    assert want == native.msm(px, py, sl)
    return px, py, sl, want


@pytest.fixture
def small_dispatch(monkeypatch):
    """msm_best reaches the device pipeline at any size, with SMALL."""
    monkeypatch.setattr(tpu_msm_torch, "CPU_THRESHOLD", 0)
    monkeypatch.setattr(tpu_msm_torch, "select_config",
                        lambda n: MsmConfig(**SMALL))


def test_msm_matches_jax(jax_case):
    px, py, sl, want = jax_case
    got = tpu_msm_torch.msm((px, py), sl, cfg=MsmConfig(**SMALL), device="cpu")
    assert got == want


def test_msm_best_matches_jax(jax_case, small_dispatch):
    px, py, sl, want = jax_case
    assert tpu_msm_torch.msm_best(sl, (px, py), device="cpu") == want


@pytest.fixture
def fused_only(monkeypatch):
    """window_sums takes the fused route (the main path on the card) at any
    lane count; reaching the per-window route fails the test."""
    def per_window(*args, **kwargs):
        raise AssertionError("the per-window route ran")

    monkeypatch.setattr(pippenger, "fused_route", lambda lanes: True)
    monkeypatch.setattr(pippenger, "_per_window_sums", per_window)


def _edge_case(case):
    """>= 30 % zero scalars (the zero filter) at an n that is no multiple
    of the lanes; duplicate points, scalar r-1, infinity points and
    negative scalars in list form; all-zero scalars."""
    if case == "zeros_ragged":
        px, py, sl = _inputs(42, 150, zero_share=0.4)
        assert tpu_msm_torch.msm_best(sl, (px, py), device="cpu") == \
            native.msm(px, py, sl)
    elif case == "exceptional":
        rng = np.random.RandomState(43)
        pts = [oracle.ec_mul(oracle.GEN, int(k))
               for k in rng.randint(1, 1 << 20, size=12)]
        pts = pts + pts[:6] + [None, None] + [oracle.ec_neg(pts[0])]
        scalars = [int(s) for s in rng.randint(1, 1 << 62, size=len(pts))]
        scalars[0] = FR - 1
        scalars[1] = -5
        scalars[6] = -(FR - 1)
        got = tpu_msm_torch.msm_best(scalars, pts, device="cpu")
        assert got == oracle.msm([s % FR for s in scalars], pts)
    else:
        px, py, _ = _inputs(44, 20)
        zero = np.zeros((16, 20), np.uint32)
        assert tpu_msm_torch.msm_best(zero, (px, py), device="cpu") is None
        assert tpu_msm_torch.msm_best([], [], device="cpu") is None


@pytest.mark.parametrize("case", ["zeros_ragged", "exceptional", "all_zero"])
def test_msm_best_edge_cases(small_dispatch, case):
    """The edge cases of _edge_case by the route rule (per window here)."""
    _edge_case(case)


@pytest.mark.parametrize("case", ["zeros_ragged", "exceptional"])
def test_msm_best_edge_cases_fused_route(small_dispatch, fused_only, case):
    """The same edge cases through the fused route."""
    _edge_case(case)


# unsigned c = 8: m = 255 buckets pad to 256, M·X(n) by all-ones; the main
# path's c = 16 signed windows (m = 2^15) on 32-bit scalars.
CONFIGS = pytest.mark.parametrize("cfg", [
    MsmConfig(window_bits=8, scan_lanes=16, reduce_fanout=32,
              signed_digits=False),
    MsmConfig(window_bits=16, scan_lanes=16, reduce_fanout=2048,
              scalar_bits=32, signed_digits=True),
], ids=["c8_unsigned", "c16_signed_32bit"])


def _config_case(cfg):
    px, py, sl = _inputs(45, 100)
    if cfg.scalar_bits < 254:
        sl[cfg.scalar_bits // 16:] = 0
    want = native.msm(px, py, sl)
    assert tpu_msm_torch.msm((px, py), sl, cfg=cfg, device="cpu") == want


@CONFIGS
def test_msm_configs_match_native(cfg):
    _config_case(cfg)


@CONFIGS
def test_msm_configs_match_native_fused_route(fused_only, cfg):
    _config_case(cfg)


@pytest.mark.parametrize("c", [8, 16])
def test_signed_window_digits_match_jax(c):
    _, _, sl = _inputs(46, 50)
    sl[:, :3] = interop.ints_to_limbs([0, FR - 1, (1 << (c - 1))])
    cfg = MsmConfig(window_bits=c, signed_digits=True)
    jcfg = JaxMsmConfig(window_bits=c, signed_digits=True)
    got = pippenger.signed_window_digits(torch.from_numpy(sl.view(np.int32)), cfg)
    want = jpip.signed_window_digits(jnp.asarray(sl), jcfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_window_digits_match_oracle():
    _, _, sl = _inputs(47, 9)
    t = torch.from_numpy(sl.view(np.int32))
    for c in (8, 16):
        cfg = MsmConfig(window_bits=c, signed_digits=False)
        got = pippenger.window_digits(t, cfg).numpy()
        for i, s in enumerate(interop.limbs_to_ints(sl)):
            assert got[:, i].tolist() == oracle.window_digits(s, c, cfg.num_windows())


def test_select_config_is_tuned_row():
    assert select_config(1 << 20) == MsmConfig()
    assert dataclasses.astuple(MsmConfig())[:2] == (16, 4096)
    assert select_config(256).scan_lanes == 128
    assert select_config(5).scan_lanes == 8


def test_mismatched_lengths_raise():
    px, py, sl = _inputs(48, 10)
    with pytest.raises(ValueError):
        tpu_msm_torch.msm_best(sl[:, :9], (px, py), device="cpu")
    with pytest.raises(ValueError):
        tpu_msm_torch.msm((px, py), sl[:, :9], device="cpu")


def test_import_leaves_jax_out():
    code = ("import sys, tpu_msm_torch, tpu_msm_torch.ops.pippenger, "
            "tpu_msm_torch.bindings.native; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(tpu_msm_torch.__file__).parents[1], timeout=120)


def test_cuda_request_without_card_raises():
    """Asking for the card where there is none raises; it does not run the
    MSM on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    px, py, sl = _inputs(49, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_msm_torch.msm_best(sl, (px, py), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_msm_torch.msm((px, py), sl, device="cuda")
