"""Window widths other than 8 and 16 in the port, on the CPU.

The JAX package takes any window width its digit extraction takes
(`u256.extract_bits`, 1 to 17 bits); so does the port. Its digit
extraction and signed recoding must equal the JAX package's eager
functions bit for bit, and its MSM must equal the native engine's at
c = 4, 5, 12 and 13, signed and unsigned; one case (c = 5 unsigned, small
scalars) is also held against `tpu_msm.msm` on the JAX CPU backend (one
compile of its pipeline, about 40 s).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_msm  # noqa: E402
import tpu_msm_torch  # noqa: E402
from tpu_msm.ops import pippenger as jpip  # noqa: E402
from tpu_msm.ops import u256 as ju256  # noqa: E402
from tpu_msm.utils.config import MsmConfig as JaxMsmConfig  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import pippenger, u256  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

WIDTHS = [4, 5, 12, 13]
# Scalars of the MSM cases: below 2^16, so that a case runs 2 to 5 windows.
SMALL_BITS = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The MSM cases run plain EC ops up to 8192 wide. With several test
    workers on one machine, torch's intra-op threads oversubscribe the
    cores and such a case slows 40-fold (7 s alone, 287 s beside five
    other workers), so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scalars():
    """(16, 96) standard-form scalars below 2^254: seeded ones below r, and
    0, 1, r - 1, 2^253 and 2^254 - 1 (every window's bits set)."""
    rng = np.random.RandomState(61)
    ints = [int.from_bytes(rng.bytes(32), "little") % bn254.FR
            for _ in range(96)]
    ints[:5] = [0, 1, bn254.FR - 1, 1 << 253, (1 << 254) - 1]
    return interop.ints_to_limbs(ints)


@pytest.mark.parametrize("start,width", [
    (0, 4), (3, 5), (12, 12), (14, 13), (15, 17), (16, 16), (240, 16),
    (247, 9), (250, 6), (252, 4), (0, 1)])
def test_extract_bits_matches_jax(scalars, start, width):
    want = np.asarray(ju256.extract_bits(jnp.asarray(scalars), start, width))
    got = u256.extract_bits(_t(scalars), start, width).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_extract_bits_rejects_wider_than_17():
    with pytest.raises(ValueError, match="17"):
        u256.extract_bits(torch.zeros((16, 2), dtype=torch.int32), 0, 18)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("c", WIDTHS + [1, 7, 8, 16, 17])
def test_window_digits_match_jax(scalars, c, signed):
    jcfg = JaxMsmConfig(window_bits=c, signed_digits=signed)
    cfg = MsmConfig(window_bits=c, signed_digits=signed)
    sl = _t(scalars)
    if signed:
        jd, jneg = jpip.signed_window_digits(jnp.asarray(scalars), jcfg)
        d, neg = pippenger.signed_window_digits(sl, cfg)
        np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    else:
        jd = jpip.window_digits(jnp.asarray(scalars), jcfg)
        d = pippenger.window_digits(sl, cfg)
    assert d.shape == (cfg.num_windows(), scalars.shape[1])
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd).astype(np.int32))


@pytest.mark.parametrize("c", [0, 18, 32])
def test_config_rejects_widths_the_extraction_does_not_take(c):
    with pytest.raises(ValueError, match="window_bits"):
        MsmConfig(window_bits=c)


@pytest.fixture(scope="module")
def small_msm():
    """n = 64 seeded points, scalars below 2^SMALL_BITS (with 0, the
    largest and a top bit), and the native engine's MSM of them."""
    rng = np.random.RandomState(62)
    n = 64
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    ints = [int(s) for s in rng.randint(0, 1 << SMALL_BITS, size=n)]
    ints[:3] = [0, (1 << SMALL_BITS) - 1, 1 << (SMALL_BITS - 1)]
    sl = interop.ints_to_limbs(ints)
    return px, py, sl, native.msm(px, py, sl)


def _fused_msm(px, py, sl, cfg):
    """The fused route called directly (the route rule sends n = 64 per
    window), then Horner: the affine point."""
    wsums = pippenger._fused_sums(AffinePoint(_t(px), _t(py)), _t(sl), cfg)
    return interop.proj_limbs_to_affine_points(*(
        interop.tensor_to_limbs(a).reshape(16, 1)
        for a in pippenger.horner_fold(wsums, cfg.window_bits)))[0]


def _width_cfg(c, signed):
    return MsmConfig(window_bits=c, signed_digits=signed, scan_lanes=64,
                     reduce_fanout=1 << 13, scalar_bits=SMALL_BITS)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_msm_at_width_matches_native(small_msm, c, signed):
    """`msm` on the CPU (the per-window route at n = 64) at an odd width."""
    px, py, sl, want = small_msm
    cfg = _width_cfg(c, signed)
    assert tpu_msm_torch.msm((px, py), sl, cfg=cfg, device="cpu") == want


@pytest.mark.parametrize("c,signed", [(4, True), (13, False)])
def test_fused_route_at_width_matches_native(small_msm, c, signed):
    """The fused route at the fewest buckets (m = 8: the batched sides
    stage's m + 1 queries, no padding to a power of two) and the most
    (m = 8191) of these widths."""
    px, py, sl, want = small_msm
    assert _fused_msm(px, py, sl, _width_cfg(c, signed)) == want


def test_msm_at_width_5_matches_jax_msm(small_msm):
    """The one end-to-end case against the JAX package: `tpu_msm.msm` at
    c = 5 unsigned on its CPU backend, and the port's `msm` on both routes
    (the fused one called directly)."""
    px, py, sl, want = small_msm
    kw = dict(window_bits=5, signed_digits=False, scan_lanes=64,
              reduce_fanout=64, scalar_bits=SMALL_BITS)
    jres = tpu_msm.msm((px, py), sl, cfg=JaxMsmConfig(**kw))
    assert jres == want
    cfg = MsmConfig(**kw)
    assert tpu_msm_torch.msm((px, py), sl, cfg=cfg, device="cpu") == jres
    assert _fused_msm(px, py, sl, cfg) == jres
