"""The port's per-window MSM route and the route rule, on the CPU (plain
kernel versions), against the JAX package on its CPU backend.

JAX on the CPU runs `_msm_window` for every window, and so does the port
whenever the scan lanes fall outside the fused route's rule (64 lanes
here), so the two must give BIT-IDENTICAL projective window sums. The fused
route, called directly at the same size, must give the same affine result.
`segment_starts="hist_cols"` must give the starts of the JAX package's
`segment_starts_hist_pallas` (run in interpret mode, as tests/test_hist.py
runs it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_msm.ops import curve as jcurve  # noqa: E402
from tpu_msm.ops import hist as jhist  # noqa: E402
from tpu_msm.ops import pippenger as jpip  # noqa: E402
from tpu_msm.utils.config import MsmConfig as JaxMsmConfig  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import hist, pippenger  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

# c = 8 signed windows, 64 scan lanes (the per-window route), fanout 64:
# the 128 X(s_b) of a window fold to 64 lanes, then a rolled tree.
SMALL = dict(window_bits=8, scan_lanes=64, reduce_fanout=64,
             signed_digits=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _affine(res):
    return interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a).reshape(16, 1) for a in res))[0]


@pytest.fixture(scope="module")
def case():
    """n = 256 seeded points and scalars, the JAX package's window sums on
    its CPU backend, its MSM (horner_fold of those sums, which is what
    `tpu_msm.msm` computes) and the native engine's."""
    rng = np.random.RandomState(51)
    n = 256
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    sl = interop.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % bn254.FR for _ in range(n)])
    sl[:, :4] = interop.ints_to_limbs([0, 1, bn254.FR - 1, 1 << 7])
    jcfg = JaxMsmConfig(segment_starts="hist", **SMALL)
    pts = jcurve.AffinePoint(jnp.asarray(px), jnp.asarray(py))
    wsums = jax.jit(jpip.window_sums, static_argnums=2)(
        pts, jnp.asarray(sl), jcfg)
    jres = jax.jit(jpip.horner_fold, static_argnums=1)(wsums, 8)
    want = interop.proj_limbs_to_affine_points(
        *(np.asarray(a) for a in jres))[0]
    assert want == native.msm(px, py, sl)
    return px, py, sl, [np.asarray(a) for a in wsums], want


@pytest.mark.parametrize("starts", ["hist", "hist_cols"])
def test_per_window_sums_bit_identical_to_jax(case, starts):
    px, py, sl, want_ws, want = case
    cfg = MsmConfig(segment_starts=starts, **SMALL)
    pts = AffinePoint(_t(px), _t(py))
    assert not pippenger.fused_route(pippenger._scan_lanes(256, cfg))
    got = pippenger.window_sums(pts, _t(sl), cfg)
    assert got.x.shape == (32, 16, 1)
    for g, w in zip(got, want_ws):
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32), w.astype(np.uint32))
    assert _affine(pippenger.horner_fold(got, 8)) == want


def test_fused_route_called_directly_matches_jax(case):
    """The fused route keeps its CPU coverage: at the same size, called
    directly, its affine result equals the JAX package's MSM."""
    px, py, sl, _, want = case
    cfg = MsmConfig(segment_starts="hist", **SMALL)
    wsums = pippenger._fused_sums(AffinePoint(_t(px), _t(py)), _t(sl), cfg)
    assert _affine(pippenger.horner_fold(wsums, 8)) == want


@pytest.mark.parametrize("lanes,fused", [
    (64, False), (512, False), (1024, True), (2048, True), (4096, True),
    (8192, True), (3072, True), (1536, False), (16384, False)])
def test_route_rule(monkeypatch, lanes, fused):
    """Fused iff lanes % 1024 == 0 and 1024 <= lanes <= 8192, whatever the
    device; window_sums takes the route the rule names."""
    assert pippenger.fused_route(lanes) is fused
    taken = []
    monkeypatch.setattr(pippenger, "_fused_sums",
                        lambda *a: taken.append("fused"))
    monkeypatch.setattr(pippenger, "_per_window_sums",
                        lambda *a: taken.append("per_window"))
    n = 16384
    zeros = torch.zeros((16, n), dtype=torch.int32)
    pippenger.window_sums(AffinePoint(zeros, zeros), zeros,
                          MsmConfig(scan_lanes=lanes))
    assert taken == ["fused" if fused else "per_window"]


def test_small_n_takes_the_per_window_route(monkeypatch):
    """The lanes shrink to the next power of two of n: at n = 100 even the
    tuned 4096-lane row runs per window."""
    taken = []
    monkeypatch.setattr(pippenger, "_per_window_sums",
                        lambda *a: taken.append("per_window"))
    zeros = torch.zeros((16, 100), dtype=torch.int32)
    pippenger.window_sums(AffinePoint(zeros, zeros), zeros, MsmConfig())
    assert taken == ["per_window"]


@pytest.mark.parametrize("m", [1 << 15, 127])
def test_hist_cols_starts_match_pallas(m):
    rng = np.random.RandomState(m)
    digits = np.sort(rng.randint(0, m + 2, size=4096).astype(np.uint32))
    want = np.asarray(jhist.segment_starts_hist_pallas(
        jnp.asarray(digits), m, interpret=True))
    got = hist.segment_starts_hist_cols(_t(digits), m).numpy()
    np.testing.assert_array_equal(got, want)
    before = hist.digit_hist_plain.calls
    hist.segment_starts_hist_cols(_t(digits), m)
    assert hist.digit_hist_plain.calls == before + 1  # the one histogram


def test_segment_starts_option_is_checked():
    """A value neither package takes raises in both; every value the JAX
    package takes is taken."""
    with pytest.raises(ValueError, match="segment_starts"):
        JaxMsmConfig(segment_starts="ss_bisect")
    with pytest.raises(ValueError, match="segment_starts"):
        MsmConfig(segment_starts="ss_bisect")
    for value in ("bincount", "ss_scan", "ss_sort", "ss_2level", "hist",
                  "hist_cols"):
        assert JaxMsmConfig(segment_starts=value).segment_starts == value
        assert MsmConfig(segment_starts=value).segment_starts == value
