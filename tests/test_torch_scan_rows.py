"""scan_madd_rows as a reduce-then-scan over K chunks of the step axis.

On the CPU, `cuda_curve.scan_madd_rows_plain` at K chunks (the kernel's
three phases in torch ops) is held against the JAX package's scan, the
Pallas body of `scan_madd_packed` (`_scan_madd_kernel`: one
`_proj_madd_rows` a grid step from (0 : 1 : 0)) evaluated eagerly, by
projective equality, on seeded points with edge lanes at the chunk
boundaries; chunk 0 against K = 1 bit for bit; and the rule that picks K,
`cuda_curve.scan_rows_chunks`. (`scan_madd_packed(..., interpret=True)`
itself compiles for over 15 minutes on a CPU host; its body, stepped
eagerly, computes the same rows in about 35 s here.) The `cuda` case holds
the kernel against the plain version at the same K, bit for bit, and skips
without a card:
    python -m pytest --noconftest -m cuda tests/test_torch_scan_rows.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import cuda_curve, curve  # noqa: E402
from tpu_msm_torch.ops.curve import ProjPoint  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402

STEPS, LANES = 7, 256
# K = 2: chunks [0, 4), [4, 7); K = 3: [0, 3), [3, 6), [6, 7); K = 7: one
# step each. 2 and 3 do not divide 7.
CHUNKS = (1, 2, 3, STEPS)


def _point(s: int):
    """s·G for a signed small s (0 = infinity, None)."""
    if s == 0:
        return None
    x, y = oracle.ec_mul(oracle.GEN, abs(s))
    return (x, y) if s > 0 else (x, bn254.P - y)


def _edge_scalars():
    """(STEPS, LANES) signed scalars of the points, seeded: random lanes
    with infinities, and per edge kind a band of 16 lanes (each its own
    random scalars), at the boundaries of K = 2 and 3 (steps 3, 4, 6)."""
    rng = np.random.RandomState(31)
    s = rng.randint(1, 1 << 12, size=(STEPS, LANES)).astype(np.int64)
    s[rng.rand(STEPS, LANES) < 0.05] = 0
    kinds = {}
    lo = 0

    def take(kind):
        nonlocal lo
        kinds[kind] = slice(lo, lo + 16)
        lo += 16
        return kinds[kind]

    # An infinity at the first step of every chunk of K = 2 and 3.
    s[[0, 3, 4, 6], take("inf_first")] = 0
    # A chunk whose total is infinity: P then -P inside K = 3's chunk 1 and
    # K = 2's chunk 1 (steps 3 .. 6).
    b = take("zero_total")
    s[4, b], s[5, b], s[6, b] = -s[3, b], 0, 0
    # The prefix equals -(next point): the running sum cancels at a
    # boundary (K = 3 at step 3, and K = 2 at step 4 on another band).
    b = take("cancel_3")
    s[3, b] = -s[:3, b].sum(axis=0)
    b = take("cancel_4")
    s[4, b] = -s[:4, b].sum(axis=0)
    # The prefix equals the next point: the add doubles at a boundary.
    b = take("double_3")
    s[3, b] = s[:3, b].sum(axis=0)
    b = take("double_4")
    s[4, b] = s[:4, b].sum(axis=0)
    # K = 3's phase 2: chunk 1's total equals chunk 0's (the running sum
    # of the totals doubles), or its negation (it cancels).
    b = take("total_double")
    s[3:6, b] = s[0:3, b]
    b = take("total_cancel")
    s[3:6, b] = -s[0:3, b]
    return s, kinds


@pytest.fixture(scope="module")
def case():
    """The inputs as (16, STEPS, LANES) int32 tensors, their scalars, and
    the JAX package's scan of them: three (16, STEPS, LANES) int32."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpu_msm.ops import pallas_curve as pc

    s, kinds = _edge_scalars()
    cache = {}
    xy = []
    for k in range(STEPS):
        pts = [cache.setdefault(int(v), _point(int(v))) for v in s[k]]
        xy.append(interop.affine_points_to_limbs(pts))
    gx = np.stack([a[0] for a in xy], axis=1).astype(np.uint32)
    gy = np.stack([a[1] for a in xy], axis=1).astype(np.uint32)
    one = interop.ints_to_limbs([bn254.R_MOD_P] * LANES)
    acc = ([jnp.zeros(LANES, jnp.uint32)] * 16,
           [jnp.asarray(r) for r in one], [jnp.zeros(LANES, jnp.uint32)] * 16)
    want = []
    with jax.disable_jit():
        for k in range(STEPS):
            acc = pc._proj_madd_rows(*acc, [jnp.asarray(r) for r in gx[:, k]],
                                     [jnp.asarray(r) for r in gy[:, k]])
            want.append([np.stack([np.asarray(r) for r in c]) for c in acc])
    want = tuple(_t(np.stack([w[c] for w in want], axis=1)) for c in range(3))
    return {"gx": _t(gx), "gy": _t(gy), "scalars": s, "kinds": kinds,
            "want": want}


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


def _proj_eq(a, b):
    return curve.proj_eq(ProjPoint(*a), ProjPoint(*b))


def test_edge_lanes_hit_their_cases(case):
    """The JAX scan's sums are infinity exactly where the scalars' running
    sums are 0: on the cancelling and zero-total bands among them."""
    run = np.cumsum(case["scalars"], axis=0)
    inf = (case["want"][2] == 0).all(dim=0).numpy()
    np.testing.assert_array_equal(inf, run == 0)
    kinds = case["kinds"]
    assert (run[3, kinds["cancel_3"]] == 0).all()
    assert (run[4, kinds["cancel_4"]] == 0).all()
    assert (run[5, kinds["total_cancel"]] == 0).all()
    tot = case["scalars"][3:6, kinds["zero_total"]].sum(axis=0)
    assert (tot == 0).all()


@pytest.mark.parametrize("chunks", CHUNKS)
def test_plain_matches_jax_scan(case, chunks):
    """Every running sum at K chunks is the JAX scan's point, the edge
    lanes included."""
    got = cuda_curve.scan_madd_rows_plain(case["gx"], case["gy"], chunks)
    assert all(g.shape == (16, STEPS, LANES) and g.dtype == torch.int32
               for g in got)
    assert bool(_proj_eq(got, case["want"]).all())


@pytest.mark.parametrize("chunks", CHUNKS)
def test_plain_matches_oracle(case, chunks):
    """The affine sums at K chunks equal the oracle's k·G for each running
    scalar sum k."""
    got = cuda_curve.scan_madd_rows_plain(case["gx"], case["gy"], chunks)
    run = np.cumsum(case["scalars"], axis=0)
    for k in (0, 3, 4, STEPS - 1):
        pts = interop.proj_limbs_to_affine_points(
            *(interop.tensor_to_limbs(c[:, k]) for c in got))
        assert pts == [_point(int(v)) for v in run[k]]


@pytest.mark.parametrize("chunks", CHUNKS)
def test_chunk_zero_is_the_serial_scan(case, chunks):
    """Chunk 0 of K chunks is K = 1's bits; at K = 1 every step is the JAX
    scan's bits."""
    k, length = cuda_curve.scan_rows_chunking(STEPS, chunks)
    assert k == chunks  # each of CHUNKS leaves no chunk empty at 7 steps
    serial = cuda_curve.scan_madd_rows_plain(case["gx"], case["gy"])
    got = cuda_curve.scan_madd_rows_plain(case["gx"], case["gy"], chunks)
    for g, s, w in zip(got, serial, case["want"]):
        assert torch.equal(g[:, :length], s[:, :length])
        assert torch.equal(s, w)
    # From K = 3 on, phase 2's adds give later chunks other coordinates.
    assert (k > 2) == any(not torch.equal(g, s) for g, s in zip(got, serial))


def test_wrapper_on_cpu_takes_the_callers_chunks(case):
    """On the CPU the wrapper is the plain version at the K given, and at
    K = 1 when none is."""
    gx, gy = case["gx"], case["gy"]
    calls = cuda_curve.scan_madd_rows_plain.calls
    for chunks in (None, 3):
        got = cuda_curve.scan_madd_rows(gx, gy, chunks=chunks)
        want = cuda_curve.scan_madd_rows_plain(gx, gy, chunks or 1)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_curve.scan_madd_rows_plain.calls == calls + 4


@pytest.mark.parametrize("steps,chunks,want", [
    (7, 1, (1, 7)), (7, 2, (2, 4)), (7, 3, (3, 3)), (7, 7, (7, 1)),
    (7, 100, (7, 1)), (256, 17, (16, 16)), (256, 16, (16, 16)),
    (10, 4, (4, 3)), (9, 4, (3, 3)), (1, 5, (1, 1))])
def test_chunking_drops_empty_chunks(steps, chunks, want):
    """(K, length): chunks of ceil(steps / chunks) steps, none empty, only
    the last shorter."""
    k, length = cuda_curve.scan_rows_chunking(steps, chunks)
    assert (k, length) == want
    assert (k - 1) * length < steps <= k * length


def test_chunking_rejects_nothing_to_split():
    for steps, chunks in ((0, 1), (5, 0), (5, -1)):
        with pytest.raises(ValueError):
            cuda_curve.scan_rows_chunking(steps, chunks)


@pytest.mark.parametrize("steps,lanes,sms,want", [
    (256, 4096, 132, 16),     # chip_smoke.py: 17 chunks fill, 16 steps each
    (3, 1024, 132, 3),        # the CLI's kernel check: capped at the steps
    (256, 1024, 132, 32),     # 66 fill; phase 2's chain caps it at 32
    (256, 67584, 132, 1),     # 4 blocks of 128 on each of 132 SMs: full
    (256, 1 << 20, 132, 1),
    (1, 300, 132, 1),
    (64, 8192, 132, 8)])
def test_rule_at_known_shapes(steps, lanes, sms, want):
    assert cuda_curve.scan_rows_chunks(steps, lanes, sms) == want


def test_rule_fills_the_card_within_the_steps():
    """1 <= K <= steps with no chunk empty; K = 1 where the lanes fill the
    card; else the least K whose threads fill it (as equal chunks), unless
    phase 2's chain would outweigh the shorter chunks (K^2 above
    SCAN_ROWS_BALANCE x steps)."""
    for sms in (1, 8, 132):
        fill = cuda_curve.SCAN_ROWS_BLOCKS_PER_SM * 128 * sms
        for steps in (1, 2, 3, 7, 16, 100, 256, 1000):
            for lanes in (1, 100, 1000, 4096, fill - 1, fill, 3 * fill):
                k = cuda_curve.scan_rows_chunks(steps, lanes, sms)
                assert 1 <= k <= steps
                assert cuda_curve.scan_rows_chunking(steps, k)[0] == k
                most = min(steps, math.isqrt(
                    cuda_curve.SCAN_ROWS_BALANCE * steps))
                least = -(-fill // lanes)
                if lanes >= fill:
                    assert k == 1
                else:
                    assert k == cuda_curve.scan_rows_chunking(
                        steps, min(least, most))[0]


@pytest.mark.cuda
def test_kernel_matches_plain_at_each_chunking():
    """The kernel at K against the plain version at the same K, bit for
    bit, on a ragged shape (300 lanes, 23 steps: no K below divides it),
    with the edge kinds at K = 3's first boundary; the rule's K as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(32)
    steps, lanes = 23, 300
    s = rng.randint(1, 1 << 12, size=(steps, lanes)).astype(np.int64)
    s[rng.rand(steps, lanes) < 0.05] = 0
    s[8, :20] = 0                              # infinity at a chunk's start
    s[9, 20:40] = -s[8, 20:40]                 # a chunk's total cancels
    s[8, 40:60] = -s[:8, 40:60].sum(axis=0)    # the running sum cancels
    s[8, 60:80] = s[:8, 60:80].sum(axis=0)     # the add doubles
    cache = {}
    xy = [interop.affine_points_to_limbs(
        [cache.setdefault(int(v), _point(int(v))) for v in row]) for row in s]
    gx = _t(np.stack([a[0] for a in xy], axis=1), dev)
    gy = _t(np.stack([a[1] for a in xy], axis=1), dev)
    serial = cuda_curve.scan_madd_rows_plain(gx, gy)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = cuda_curve.scan_rows_chunks(steps, lanes, sms)
    for chunks in (1, 2, 3, 8, steps, rule):
        before = cuda_curve.scan_madd_rows.launches
        got = cuda_curve.scan_madd_rows(gx, gy, chunks=chunks)
        want = cuda_curve.scan_madd_rows_plain(gx, gy, chunks)
        torch.cuda.synchronize()
        assert cuda_curve.scan_madd_rows.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), chunks
        assert bool(_proj_eq(got, serial).all()), chunks
    got = cuda_curve.scan_madd_rows(gx, gy)
    want = cuda_curve.scan_madd_rows_plain(gx, gy, rule)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
