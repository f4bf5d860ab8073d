"""The sort stage's layout (`cuda_curve.scan_layout`, csrc/layout.cu): on the
CPU against the JAX package, on the card the kernel against its plain
version.

On the CPU, `scan_layout_plain` (after the digit sort's int32 permutation)
and the port's `pippenger._sorted_scan_inputs` must equal the JAX package's
`_sorted_scan_inputs` (`tpu_msm/ops/pippenger.py:271-307`) bit for bit,
under both of its `sort_impl` values ("payload": one 17-operand sort;
"rank": a (digit, position) sort and one gather of the (n, 16) table),
window by window. The inputs, drawn with numpy from a seed: c = 16 digits
(m = 65535 unsigned, 32768 signed) with the padding sentinel m + 1 at the
padded positions, random or all equal (which tests that the sort is
stable), and a point-major table of random u32 words [x | y | -y] whose
padding rows and one real row are the (0, 0) point; negation masks where
the digits are signed (False at the padding, as `pippenger._digits` pads
them). Windows G in {1, 3}, 1024 lanes, steps in {1, 3, 32, 33}.

Layout mapping: the port's sgx, sgy are (G, 8, steps, lanes) int32 and its
sorted digits (G, n_pad) int32; the JAX function takes one window's uint32
digits, (8, n_pad) x words and (8, n_pad) y words already negated where the
mask says (ppy_w), and returns (8, steps, lanes / 128, 128) uint32 and
(n_pad,) uint32. So window g's port block holds the JAX block reshaped to
(8, steps, lanes), as u32 bit patterns.

Tests marked `cuda` launch the kernel at ragged shapes and with indices
outside the table, bit for bit against the plain version, and skip without
a card. jax is imported inside a fixture only, so they also run where jax
is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_layout.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.ops import cuda_curve as cc  # noqa: E402
from tpu_msm_torch.ops import pippenger, sort  # noqa: E402

LANES = 1024
SEED = 14


@pytest.fixture(scope="module")
def jax_sort():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_msm.ops import pippenger as jpip

    return jnp, jpip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, g, steps, signed, equal, lanes=LANES):
    """(digits (G, n_pad) int64, words (n_pad, 24) uint32, negm (G, n_pad)
    bool or None) for n = n_pad - n_pad // 7 real points."""
    rng = np.random.RandomState(seed)
    n_pad = lanes * steps
    n = n_pad - n_pad // 7
    m = 32768 if signed else 65535
    digits = (np.full((g, n_pad), 7) if equal
              else rng.randint(0, m + 1, size=(g, n_pad)))
    digits[:, n:] = m + 1
    words = rng.randint(0, 1 << 32, size=(n_pad, 24),
                        dtype=np.uint64).astype(np.uint32)
    words[n:] = 0
    words[rng.randint(n)] = 0  # a (0, 0) point among the real ones
    negm = None
    if signed:
        negm = rng.rand(g, n_pad) < 0.5
        negm[:, n:] = False
    return digits, words, negm


def _tensors(digits, words, negm):
    """The port's operands: int32 digits, (n_pad, 24 or 16) int32 rows
    (16 words without masks), bool masks or None."""
    rows = words if negm is not None else words[:, :16]
    return (torch.from_numpy(digits.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)),
            None if negm is None else torch.from_numpy(negm))


def _u32(t):
    return t.numpy().view(np.uint32)


# (G, steps, signed digits, all digits equal): every G, steps and digit
# sign, all-equal digits under both signs.
CASES = [(1, 1, False, False), (3, 3, True, False), (3, 32, False, True),
         (1, 33, True, True), (3, 33, False, False)]


@pytest.mark.parametrize("g,steps,signed,equal", CASES)
def test_layout_matches_jax(jax_sort, g, steps, signed, equal):
    jnp, jpip = jax_sort
    digits, words, negm = _inputs(SEED + steps, g, steps, signed, equal)
    d, rows, m = _tensors(digits, words, negm)
    calls = cc.scan_layout_plain.calls
    sorted_digits, sgx, sgy = pippenger._sorted_scan_inputs(d, m, rows, LANES)
    assert cc.scan_layout_plain.calls == calls + 1  # the CPU's plain version
    _, perm = sort.digit_sort_plain(d, sort.MAX_KEY_BITS)
    px, py = cc.scan_layout_plain(perm, rows, m, LANES)
    assert sgx.shape == sgy.shape == px.shape == (g, 8, steps, LANES)
    assert sgx.dtype == sgy.dtype == torch.int32
    for w in range(g):
        y = words[:, 8:16].T
        if signed:
            y = np.where(negm[w][None, :], words[:, 16:24].T, y)
        for impl in ("payload", "rank"):
            jd, jx, jy = jpip._sorted_scan_inputs(
                jnp.asarray(digits[w].astype(np.uint32)),
                jnp.asarray(np.ascontiguousarray(words[:, :8].T)),
                jnp.asarray(np.ascontiguousarray(y)), LANES, steps, impl)
            jx = np.asarray(jx).reshape(8, steps, LANES)
            jy = np.asarray(jy).reshape(8, steps, LANES)
            assert np.array_equal(_u32(sorted_digits[w]), np.asarray(jd))
            for got_x, got_y in ((sgx, sgy), (px, py)):
                assert np.array_equal(_u32(got_x[w]), jx), impl
                assert np.array_equal(_u32(got_y[w]), jy), impl


def test_scan_operands_rows_are_the_packed_words():
    """scan_operands' table: one row a point, the packed x, y and (signed)
    -y words of `pack_u16_rows`, the padding rows the (0, 0) point."""
    from tpu_msm_torch.ops import field
    from tpu_msm_torch.ops.curve import AffinePoint
    from tpu_msm_torch.utils.config import MsmConfig

    rng = np.random.RandomState(SEED)
    n = 1000
    x, y = (torch.from_numpy(rng.randint(0, 1 << 16, size=(16, n))
                             .astype(np.int32)) for _ in range(2))
    sl = torch.from_numpy(rng.randint(0, 1 << 16, size=(16, n))
                          .astype(np.int32))
    sl[15] &= 0x0FFF
    for signed in (False, True):
        cfg = MsmConfig(window_bits=16, scan_lanes=LANES,
                        signed_digits=signed)
        got_cfg, got_n, digits, negm, rows = pippenger.scan_operands(
            AffinePoint(x, y), sl, cfg)
        assert (got_n, got_cfg.scan_lanes, digits.shape[1]) == (n, LANES,
                                                                LANES)
        coords = [x, y] + ([field.neg_mod(y)] if signed else [])
        want = torch.cat([pippenger.pack_u16_rows(a) for a in coords]).t()
        assert rows.shape == (LANES, 8 * len(coords)) and rows.is_contiguous()
        assert torch.equal(rows[:n], want)
        assert not rows[n:].any()
        assert (negm is not None) == signed


def test_scan_layout_checks_its_operands():
    perm = torch.stack([torch.randperm(64) for _ in range(2)]).to(
        torch.int32)
    rows = torch.zeros((64, 24), dtype=torch.int32)
    negm = torch.zeros((2, 64), dtype=torch.bool)
    bad = {"lanes": (perm, rows, negm, 5),
           "perm dtype": (perm.to(torch.int64), rows, negm, 8),
           "rows count": (perm, rows[:63], negm, 8),
           "masks need -y": (perm, rows[:, :16].contiguous(), negm, 8),
           "-y needs masks": (perm, rows, None, 8),
           "mask shape": (perm, rows, negm[:1], 8),
           "mask dtype": (perm, rows, negm.to(torch.int32), 8)}
    for args in bad.values():
        with pytest.raises(ValueError, match="scan_layout"):
            cc.scan_layout(*args)
    sgx, sgy = cc.scan_layout(perm, rows[:, :16].contiguous(), None, 8)
    assert sgx.shape == sgy.shape == (2, 8, 8, 8)


# --------------------------------------------------------------------------
# The kernel on the card.
# --------------------------------------------------------------------------

def _check_kernel(dev, perm, rows, negm, lanes):
    args = [a if a is None else a.to(dev) for a in (perm, rows, negm)]
    launches = cc.scan_layout.launches
    got = cc.scan_layout(*args, lanes)
    torch.cuda.synchronize()
    assert cc.scan_layout.launches == launches + 1
    want = cc.scan_layout_plain(*args, lanes)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("g,steps,signed,equal", CASES + [
    (2, 100, True, False), (16, 128, False, False)])
@pytest.mark.parametrize("lanes", [LANES, 37])
def test_scan_layout_kernel_matches_plain(cuda, g, steps, signed, equal,
                                          lanes):
    """Every tile shape: steps below, at and past a tile's 32, lanes a
    multiple of a warp's and not (37)."""
    digits, words, negm = _inputs(SEED + steps, g, steps, signed, equal,
                                  lanes)
    d, rows, m = _tensors(digits, words, negm)
    _, perm = sort.digit_sort_plain(d, sort.MAX_KEY_BITS)
    _check_kernel(cuda, perm, rows, m, lanes)


@pytest.mark.cuda
def test_scan_layout_kernel_index_outside_the_table(cuda):
    """An index outside [0, n_pad) gives the (0, 0) point: the plain
    version on the same permutation with those entries sent to a zero
    row."""
    digits, words, negm = _inputs(SEED, 2, 5, True, False)
    _, rows, m = _tensors(digits, words, negm)
    n_pad = rows.shape[0]
    perm = torch.stack([torch.randperm(n_pad) for _ in range(2)]).to(
        torch.int32)
    zero = int(np.flatnonzero(~words.any(axis=1))[0])
    bad = perm.clone()
    bad[0, 3], bad[1, 100], bad[1, 7] = -1, n_pad, (1 << 31) - 1
    fixed = bad.clone()
    fixed[(bad < 0) | (bad >= n_pad)] = zero
    got = cc.scan_layout(bad.to(cuda), rows.to(cuda), m.to(cuda), LANES // 2)
    want = cc.scan_layout_plain(fixed, rows, m, LANES // 2)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
