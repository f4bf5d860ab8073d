"""The main path's scan over the sorted points (`cuda_curve.scan_madd_sorted`,
`scan_madd_sorted_kernel` in csrc/ec_kernels.cu): on the CPU against the
JAX package, on the card the kernel against its plain version and against
the unfused pair it replaces, `scan_madd(*scan_layout(...))`. Tolerance:
none, every test compares bit for bit.

On the CPU the operator runs its plain version. Each window's result must
equal, bit for bit, the JAX package's `_sorted_scan_inputs`
(`tpu_msm/ops/pippenger.py:271-307`, under both `sort_impl` values, which
must give the same layout) followed by the Pallas scan of the main path,
`scan_madd_packed_u16_f15d`. Its per-grid-step body, `pallas_curve.
f15_scan_step`, runs eagerly over the steps here, as
tests/test_torch_kernels.py runs it: `scan_madd_packed_u16(...,
interpret=True)` compiles for over 13 minutes on a CPU host, and the
kernels are bit-identical (tests/test_pallas_kernels.py). All cases' windows
go through one eager scan of 3 steps side by side (about 15 s).

The inputs, drawn with numpy from a seed: c = 16 digits (m = 65535
unsigned, 32768 signed) with the padding sentinel m + 1 at the padded
positions, random or all equal (which tests that the sort is stable); a
point-major table of packed words [x | y | -y] of points k·G on the curve
from a pool of 64, so that lanes also add a point to itself, whose padding
rows and one real row are the (0, 0) point; negation masks where the
digits are signed. Windows G in {1, 2}, 1024 lanes, steps in {1, 3}.

Tests marked `cuda` launch the kernel at ragged shapes and with indices
outside the table, and skip without a card. jax is imported inside a
fixture only, so they also run where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_sorted_scan.py
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import cuda_curve as cc  # noqa: E402
from tpu_msm_torch.ops import field, pippenger  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

LANES = 1024
POOL = 64
SEED = 15
STEPS = 3  # the longest case's steps: the eager JAX scan's length

# (G, steps, signed digits, all digits equal): both G, both steps, both
# signs, all-equal digits under both signs.
CASES = [(1, 1, False, False), (2, 3, True, False), (2, 1, False, True),
         (1, 3, True, True)]


@functools.lru_cache(maxsize=1)
def _pool() -> np.ndarray:
    """(POOL, 24) uint32: the packed x, y and -y words of POOL points k·G
    (Montgomery form) with seeded 30-bit k."""
    rng = np.random.RandomState(SEED)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=POOL)]
    x, y = (torch.from_numpy(a.view(np.int32)) for a in native.ec_mul_batch(
        (bn254.GX, bn254.GY), interop.ints_to_limbs(ks)))
    words = torch.cat([pippenger.pack_u16_rows(a)
                       for a in (x, y, field.neg_mod(y))]).t()
    return np.ascontiguousarray(words.numpy().view(np.uint32))


def _inputs(seed, g, steps, signed, equal, lanes=LANES, m=None):
    """(digits (G, n_pad) int64, words (n_pad, 24) uint32, negm (G, n_pad)
    bool or None) for n = n_pad - n_pad // 7 real points; digits in [0, m]
    (c = 16's m by default), m + 1 at the padding."""
    rng = np.random.RandomState(seed)
    n_pad = lanes * steps
    n = n_pad - n_pad // 7
    if m is None:
        m = 32768 if signed else 65535
    digits = (np.full((g, n_pad), 7) if equal
              else rng.randint(0, m + 1, size=(g, n_pad)))
    digits[:, n:] = m + 1
    words = _pool()[rng.randint(POOL, size=n_pad)]
    words[n:] = 0
    words[rng.randint(n)] = 0  # a (0, 0) point among the real ones
    negm = None
    if signed:
        negm = rng.rand(g, n_pad) < 0.5
        negm[:, n:] = False
    return digits, words, negm


def _tensors(digits, words, negm):
    """The operator's operands: the stable sort's int64 permutation,
    (n_pad, 24 or 16) int32 rows (16 words without masks), bool masks or
    None."""
    rows = words if negm is not None else words[:, :16]
    perm = torch.sort(torch.from_numpy(digits.astype(np.int32)), dim=1,
                      stable=True)[1]
    return (perm, torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)),
            None if negm is None else torch.from_numpy(negm))


def _case_inputs(i):
    g, steps, signed, equal = CASES[i]
    return _inputs(SEED + 10 * i, g, steps, signed, equal)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def reference():
    """For each case and window: the JAX layout under each sort_impl
    ({impl: (sorted digits, x (8, steps, lanes), y)}), and the JAX scan of
    the "payload" layout, (48, steps, lanes) uint32."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_msm.ops import f15
    from tpu_msm.ops import pallas_curve as pc
    from tpu_msm.ops import pippenger as jpip

    layouts = {}
    for i, (g, steps, signed, _) in enumerate(CASES):
        digits, words, negm = _case_inputs(i)
        for w in range(g):
            y = words[:, 8:16].T
            if signed:
                y = np.where(negm[w][None, :], words[:, 16:24].T, y)
            layouts[i, w] = {}
            for impl in ("payload", "rank"):
                jd, jx, jy = jpip._sorted_scan_inputs(
                    jnp.asarray(digits[w].astype(np.uint32)),
                    jnp.asarray(np.ascontiguousarray(words[:, :8].T)),
                    jnp.asarray(np.ascontiguousarray(y)), LANES, steps,
                    impl)
                layouts[i, w][impl] = tuple(
                    np.asarray(a).reshape(-1, steps, LANES) if a.ndim > 1
                    else np.asarray(a) for a in (jd, jx, jy))
    # Every window's payload layout side by side on the lane axis, the
    # 1-step cases padded with (0, 0) steps, through one eager scan.
    keys = sorted(layouts)

    def side_by_side(k):
        return np.concatenate([np.pad(
            layouts[key]["payload"][k],
            ((0, 0), (0, STEPS - CASES[key[0]][1]), (0, 0)))
            for key in keys], axis=2)

    gx, gy = side_by_side(1), side_by_side(2)
    width = gx.shape[2]
    acc = tuple([jnp.full((width,), c, jnp.uint32) for c in rows]
                for rows in ([0] * f15.NROWS, f15.ONE_MONT_ROWS,
                             [0] * f15.NROWS))
    out = []
    with jax.disable_jit():
        for k in range(STEPS):
            acc, out48 = pc.f15_scan_step(
                acc, [jnp.asarray(gx[r, k]) for r in range(8)],
                [jnp.asarray(gy[r, k]) for r in range(8)])
            out.append(np.stack([np.asarray(r) for r in out48]))
    out = np.stack(out, axis=1)  # (48, STEPS, width)
    scans = {key: out[:, :CASES[key[0]][1], j * LANES:(j + 1) * LANES]
             for j, key in enumerate(keys)}
    return types.SimpleNamespace(layouts=layouts, scans=scans)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"G{g}-steps{s}-{'signed' if sg else 'unsigned'}"
                              + ("-equal" if eq else "")
                              for g, s, sg, eq in CASES])
def test_sorted_scan_matches_jax(reference, case):
    g, steps, _, _ = CASES[case]
    perm, rows, negm = _tensors(*_case_inputs(case))
    calls = cc.scan_madd_sorted_plain.calls
    got = cc.scan_madd_sorted(perm, rows, negm, LANES)
    assert cc.scan_madd_sorted_plain.calls == calls + 1  # the CPU's plain
    assert got.shape == (g, 48, steps, LANES) and got.dtype == torch.int32
    for w in range(g):
        lay = reference.layouts[case, w]
        for a, b in zip(lay["payload"], lay["rank"]):
            assert np.array_equal(a, b)  # both sort_impl values, one layout
        assert np.array_equal(_u32(got[w]), reference.scans[case, w])


@pytest.mark.parametrize("signed", [False, True],
                         ids=["unsigned", "signed"])
def test_window_heavy_takes_the_sorted_scan(monkeypatch, signed):
    """`_window_heavy` launches scan_madd_sorted once a group and neither
    scan_layout nor scan_madd; its group outputs are those of the pair on
    the same permutation."""
    cfg = MsmConfig(window_bits=8, scan_lanes=LANES, signed_digits=signed)
    m = cfg.buckets_per_window()
    digits, words, negm = _inputs(SEED + 1, 2, 2, signed, False, m=m)
    n = digits.shape[1] - digits.shape[1] // 7

    def refuse(*args):
        raise AssertionError("the main path launched the unfused pair")

    monkeypatch.setattr(pippenger, "scan_layout", refuse)
    monkeypatch.setattr(cc, "scan_madd", refuse)
    d = torch.from_numpy(digits.astype(np.int32))
    perm, rows, mask = _tensors(digits, words, negm)
    calls = cc.scan_madd_sorted_plain.calls
    totals, loc48, lq, is_zero = pippenger._window_heavy(d, mask, rows, n,
                                                         cfg)
    assert cc.scan_madd_sorted_plain.calls == calls + 1
    ys = cc.scan_madd_plain(*cc.scan_layout_plain(perm, rows, mask, LANES))
    assert torch.equal(totals, ys[:, :, -1])
    flat = ys.reshape(2, 48, -1)
    steps = digits.shape[1] // LANES
    starts = torch.searchsorted(torch.sort(d, dim=1).values,
                                torch.arange(1, m + 1, dtype=d.dtype)
                                .repeat(2, 1), side="left")
    queries = torch.cat([starts, torch.full((2, 1), n)], dim=1)
    pos = queries.clamp(min=1) - 1
    assert torch.equal(lq, (pos // steps).to(lq.dtype))
    assert torch.equal(is_zero, queries == 0)
    cols = (pos % steps) * LANES + pos // steps
    assert torch.equal(loc48, torch.gather(
        flat, 2, cols[:, None].expand(2, 48, m + 1)))


def test_group_bytes_count_the_permutation_and_the_output():
    """A window of a group holds its sorted digit (4 bytes a point), the
    int64 permutation the scan reads (8) and the scan's 48 rows (192): no
    layout."""
    assert pippenger.GROUP_BYTES_PER_POINT == 4 + 8 + 4 * 48


def test_scan_madd_sorted_checks_its_operands():
    perm = torch.stack([torch.randperm(64) for _ in range(2)])
    rows = torch.zeros((64, 24), dtype=torch.int32)
    negm = torch.zeros((2, 64), dtype=torch.bool)
    bad = {"lanes": (perm, rows, negm, 5),
           "perm dtype": (perm.to(torch.int32), rows, negm, 8),
           "rows count": (perm, rows[:63], negm, 8),
           "masks need -y": (perm, rows[:, :16].contiguous(), negm, 8),
           "-y needs masks": (perm, rows, None, 8),
           "mask shape": (perm, rows, negm[:1], 8),
           "mask dtype": (perm, rows, negm.to(torch.int32), 8)}
    for args in bad.values():
        with pytest.raises(ValueError, match="scan_madd_sorted"):
            cc.scan_madd_sorted(*args)
    out = cc.scan_madd_sorted(perm, rows[:, :16].contiguous(), None, 8)
    assert out.shape == (2, 48, 8, 8) and not out[:, 16:32].eq(0).all()


# --------------------------------------------------------------------------
# The kernel on the card.
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(dev, perm, rows, negm, lanes):
    args = [a if a is None else a.to(dev) for a in (perm, rows, negm)]
    launches = cc.scan_madd_sorted.launches
    got = cc.scan_madd_sorted(*args, lanes)
    torch.cuda.synchronize()
    assert cc.scan_madd_sorted.launches == launches + 1
    want = cc.scan_madd_sorted_plain(*args, lanes)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("steps", [1, 3, 33])
@pytest.mark.parametrize("lanes", [1024, 4096, 1000])
def test_scan_madd_sorted_kernel_matches_plain(cuda, lanes, steps, signed):
    """Steps below, at and past the ring's depth; lanes a multiple of a
    block's 128 and not (1000: a ragged last block)."""
    digits, words, negm = _inputs(SEED + steps, 2, steps, signed, False,
                                  lanes)
    _check_kernel(cuda, *_tensors(digits, words, negm), lanes)


@pytest.mark.cuda
def test_scan_madd_sorted_kernel_all_equal_digits(cuda):
    digits, words, negm = _inputs(SEED, 3, 5, True, True, 256)
    _check_kernel(cuda, *_tensors(digits, words, negm), 256)


@pytest.mark.cuda
def test_scan_madd_sorted_kernel_index_outside_the_table(cuda):
    """An index outside [0, n_pad) is the (0, 0) point: the plain version on
    the same permutation with those entries sent to a zero row."""
    digits, words, negm = _inputs(SEED, 2, 5, True, False)
    _, rows, m = _tensors(digits, words, negm)
    n_pad = rows.shape[0]
    perm = torch.stack([torch.randperm(n_pad) for _ in range(2)])
    zero = int(np.flatnonzero(~words.any(axis=1))[0])
    bad = perm.clone()
    bad[0, 3], bad[1, 100], bad[1, 7] = -1, n_pad, 1 << 40
    fixed = bad.clone()
    fixed[(bad < 0) | (bad >= n_pad)] = zero
    got = cc.scan_madd_sorted(bad.to(cuda), rows.to(cuda), m.to(cuda),
                              LANES // 2)
    want = cc.scan_madd_sorted_plain(fixed, rows, m, LANES // 2)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_scan_madd_sorted_kernel_is_the_unfused_pair(cuda, signed):
    """Bit for bit scan_madd(*scan_layout(...)), the two kernels it
    replaces on the main path, at a shape past the plain version's reach:
    3 windows x 64 steps x 8192 lanes."""
    digits, words, negm = _inputs(SEED + 2, 3, 64, signed, False, 8192)
    args = [a if a is None else a.to(cuda) for a in _tensors(digits, words,
                                                              negm)]
    got = cc.scan_madd_sorted(*args, 8192)
    want = cc.scan_madd(*cc.scan_layout(*args, 8192))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
