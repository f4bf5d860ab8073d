"""The digit histogram of a group of windows and the six segment-start
options, on the CPU against the JAX package; the redesigned histogram
kernel against its plain version on the card.

`digit_hist_plain` of (G, n) digits must equal the JAX package's
`digit_hist_pallas2` (interpret mode, as tests/test_hist.py runs it) row by
row; `pippenger._segment_starts` must give the JAX package's
`_segment_starts` for all six values of `segment_starts`, and each value the
same MSM as "hist". Tests marked `cuda` launch the kernel in every regime
of `hist.plan` (one part of int32 counters, split bins, 16-bit counters)
for groups of 1, 3 and 16 windows and on the edge cases (ragged n, n = 0,
one bin, sorted input, digits past the last bin), bit for bit against
`digit_hist_plain`, and skip without a card. jax is imported inside a
fixture only, so the `cuda` cases also run where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_hist.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_msm_torch  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import hist, pippenger  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402
from tpu_msm_torch.utils.config import SEGMENT_STARTS, MsmConfig  # noqa: E402

H100_SMS = 132


@pytest.fixture(scope="module")
def jax_hist():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_msm.ops import hist as jhist
    from tpu_msm.ops import pippenger as jpip
    from tpu_msm.utils.config import MsmConfig as JaxMsmConfig

    return jnp, jhist, jpip, JaxMsmConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _digits(rng, g, n, m, past=0):
    """(G, n) int32 digits in [0, m+1] (m+1 is the padding sentinel), a
    heavy bin in row 0, and `past` digits at or past the last bin."""
    d = rng.randint(0, m + 2, size=(g, n)).astype(np.int64)
    d[0, : n // 4] = min(7, m)
    if past:
        nb = hist.num_bins(m)
        d.reshape(-1)[rng.choice(g * n, past, replace=False)] = rng.choice(
            [nb, nb + 1, 2 * nb, (1 << 31) - 1], past)
    return d.astype(np.int32)


@pytest.mark.parametrize("m", [8, 255, (1 << 16) - 1])
def test_digit_hist_group_plain_matches_pallas2(jax_hist, m):
    jnp, jhist, _, _ = jax_hist
    digits = _digits(np.random.RandomState(m), 3, 2048, m, past=9)
    got = hist.digit_hist_plain(torch.from_numpy(digits), m)
    assert got.shape == (3, hist.num_bins(m))
    for row, want in zip(got.numpy(), digits):
        np.testing.assert_array_equal(row, np.asarray(jhist.digit_hist_pallas2(
            jnp.asarray(want.view(np.uint32)), m, interpret=True)))
    # A row of the group is the histogram of that row alone.
    np.testing.assert_array_equal(
        got[1].numpy(), hist.digit_hist_plain(torch.from_numpy(digits[1]), m))


@pytest.mark.parametrize("n", [0, 1, 5])
def test_digit_hist_plain_of_few_digits(n):
    digits = torch.arange(n, dtype=torch.int32).reshape(1, n).repeat(2, 1)
    got = hist.digit_hist_plain(digits, 8)
    assert got.shape == (2, hist.num_bins(8)) and int(got.sum()) == 2 * n


# The windows' buckets m of every width the port takes, signed and unsigned.
MS = sorted({(1 << c) - 1 for c in range(1, 18)}
            | {1 << (c - 1) for c in range(1, 18)})


@pytest.mark.parametrize("m", MS)
def test_plan_covers_the_bins(m):
    """Every plan holds bins [0, m+2) in shared memory in parts no part of
    which is empty and each fits one block; 16-bit counters read at most
    65,535 digits a block; the chunks cover n; a block flushes at most four
    counters a digit it reads, unless the window is shorter."""
    for g, n in ((16, 1 << 20), (1, 1 << 20), (3, 5000), (20, 1 << 16)):
        for big in ("split", "u16"):
            p = hist.plan(g, n, m, H100_SMS, big=big)
            assert p.held == min(hist.num_bins(m), m + 2)
            assert (p.parts - 1) * p.part_bins < p.held <= p.parts * p.part_bins
            assert p.smem <= hist.SMEM_BLOCK
            assert p.chunks * p.chunk >= n > (p.chunks - 1) * p.chunk
            if p.regime == "u16":
                assert p.chunk <= hist.U16_CHUNK and p.part_bins % 2 == 0
            assert 4 * p.chunk >= min(p.part_bins, 4 * n)
            assert p.regime == ("fits" if p.held * 4 <= hist.SMEM_BLOCK
                                else big)


def test_plan_of_the_main_path():
    """The tuned row at 2^20 (c = 16 unsigned, 16 windows in one group):
    16-bit counters, the 65,537 bins in one block and 17 chunks of at most
    65,535 digits a window (272 blocks). One window (the per-window route,
    or G = 1) would give 17 blocks so: split bins, two parts of 32,769, and
    a block for every SM. c = 16 signed fits one block: 32,770 int32
    counters, and one window nearly fills the card too."""
    m = (1 << 16) - 1
    p = hist.plan(16, 1 << 20, m, H100_SMS)
    assert (p.regime, p.parts, p.chunk, p.chunks) == (
        "u16", 1, hist.U16_CHUNK, 17)
    for g in (1, 3):
        p = hist.plan(g, 1 << 20, m, H100_SMS)
        assert (p.regime, p.parts, p.part_bins) == ("split", 2, 32769)
        assert g * p.parts * p.chunks == H100_SMS
    p = hist.plan(1, 1 << 20, 1 << 15, H100_SMS)  # a quarter of the bins
    assert (p.regime, p.parts, p.chunk, p.chunks) == ("fits", 1, 8193, 128)
    assert hist.plan(16, 1 << 20, 1 << 15, H100_SMS).chunks == 8


def _sorted_case(m, g=3, n=4096):
    rng = np.random.RandomState(m + g)
    digits = _digits(rng, g, n, m)
    return torch.from_numpy(digits), torch.from_numpy(np.sort(digits, axis=1))


@pytest.mark.parametrize("mode", SEGMENT_STARTS)
@pytest.mark.parametrize("m", [128, 255])
def test_segment_starts_match_jax(jax_hist, mode, m):
    """Each value's starts for a group of three windows, row by row, equal
    the JAX package's `_segment_starts` of that row's sorted digits ("hist"
    is handed the unsorted ones, as the fused route hands them)."""
    jnp, _, jpip, JaxMsmConfig = jax_hist
    digits, srt = _sorted_case(m)
    cfg = MsmConfig(segment_starts=mode)
    got = pippenger._segment_starts(digits if mode == "hist" else srt, m, cfg)
    assert got.shape == (3, m) and got.dtype == torch.int32
    jcfg = JaxMsmConfig(segment_starts=mode)
    for row, s in zip(got.numpy(), srt.numpy()):
        want = jpip._segment_starts(jnp.asarray(s.view(np.uint32)), m, jcfg)
        np.testing.assert_array_equal(row, np.asarray(want))


@pytest.fixture(scope="module")
def msm_case():
    rng = np.random.RandomState(63)
    n = 64
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    sl = interop.ints_to_limbs([int(s) for s in
                                rng.randint(0, 1 << 16, size=n)])
    return px, py, sl, native.msm(px, py, sl)


@pytest.mark.parametrize("route", ["per_window", "fused"])
@pytest.mark.parametrize("mode", SEGMENT_STARTS)
def test_msm_of_each_segment_starts_equals_hist(msm_case, mode, route):
    """Every value gives the native engine's point, as "hist" does: `msm`
    (the per-window route at n = 64) and the fused route called directly."""
    px, py, sl, want = msm_case
    cfg = MsmConfig(window_bits=8, scan_lanes=8, reduce_fanout=64,
                    scalar_bits=16, segment_starts=mode)
    if route == "per_window":
        got = tpu_msm_torch.msm((px, py), sl, cfg=cfg, device="cpu")
    else:
        to_t = interop.limbs_to_device
        tpx, tpy, tsl = to_t(px, py, sl, "cpu")
        wsums = pippenger._fused_sums(AffinePoint(tpx, tpy), tsl, cfg)
        got = interop.proj_limbs_to_affine_points(*(
            interop.tensor_to_limbs(a).reshape(16, 1)
            for a in pippenger.horner_fold(wsums, 8)))[0]
    assert got == want


# --------------------------------------------------------------------------
# The kernel on the card.
# --------------------------------------------------------------------------

# (regime, m): one part of int32 counters at c = 4 signed, 13 unsigned and
# 16 signed; split bins and 16-bit counters at c = 16 unsigned and 17.
REGIMES = [("fits", 8), ("fits", 8191), ("fits", 1 << 15),
           ("split", (1 << 16) - 1), ("u16", (1 << 16) - 1),
           ("split", (1 << 17) - 1), ("u16", (1 << 17) - 1)]


def _check_kernel(dev, digits, m, big=None):
    d = torch.from_numpy(np.ascontiguousarray(digits)).to(dev)
    launches = hist.digit_hist.launches
    got = hist.digit_hist(d, m, big=big)
    want = hist.digit_hist_plain(d, m)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)
    assert hist.digit_hist.launches == launches + int(d.numel() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 16])
@pytest.mark.parametrize("regime,m", REGIMES)
def test_digit_hist_kernel_matches_plain(cuda, regime, m, g):
    """One launch for G windows of a ragged n, a heavy bin and digits past
    the last bin, in every regime."""
    digits = _digits(np.random.RandomState(g * m), g, 70001, m, past=13)
    big = None if regime == "fits" else regime
    assert hist.plan(g, 70001, m, H100_SMS, big=big).regime == regime
    _check_kernel(cuda, digits, m, big)


@pytest.mark.cuda
@pytest.mark.parametrize("big", ["split", "u16"])
@pytest.mark.parametrize("case", ["one_bin", "sorted", "empty", "one_row",
                                  "past_last_bin"])
def test_digit_hist_kernel_edge_cases(cuda, case, big):
    m = (1 << 16) - 1
    rng = np.random.RandomState(5)
    digits = _digits(rng, 3, 1 << 17, m)
    if case == "one_bin":  # every atomic of a row on one bin
        digits[:] = 12345
        digits[2] = m + 1
    elif case == "sorted":
        digits = np.sort(digits, axis=1)
    elif case == "empty":
        digits = digits[:, :0]
    elif case == "one_row":
        digits = digits[1]
    else:  # only digits at or past the last bin, and the bins below it
        nb = hist.num_bins(m)
        digits = rng.choice([m + 2, nb - 1, nb, 1 << 30], size=(3, 4096))
        digits = digits.astype(np.int32)
    _check_kernel(cuda, digits, m, big)
    for fits_m in (8, 1 << 15):  # the same case where the bins fit
        _check_kernel(cuda, np.minimum(digits, fits_m + 1), fits_m)
