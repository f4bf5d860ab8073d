"""The port's chunked MSM (tpu_msm_torch.ops.streaming) and the route to it
from `msm`, on the CPU, against the JAX package's `ops/streaming.py` on its
CPU backend, the oracle and the native engine.

* `msm_streamed` at n = 100 in chunks of 2^5 (four chunks, the last one
  padded) with c = 8 and 8 lanes: the inputs and configuration of
  tests/test_dispatch.py's streaming test, in the JAX package's `MsmConfig`
  defaults; the affine result equals the JAX `msm_streamed`'s and the
  oracle's.
* `accumulate` against the JAX `_accumulate` on seeded window sums, with
  infinities, doublings and cancellations.
* The residency settings: bit-identical projective results (on the CPU
  both slice the input where it lies; the `cuda` cases hold the pinned
  staging against the resident slices), and the default's rule for cards
  of three sizes.
* `msm` above STREAM_THRESHOLD routes through `msm_streamed` with the
  chunk log the threshold gives (the counterpart of
  tests/test_dispatch.py's routing test).

The tolerance everywhere is exact equality of affine points (of raw
projective limbs between the two residency modes). The `cuda` cases run
the same on the card; jax is imported inside fixtures only, so they also
run where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_streaming.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_msm_torch  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import curve, field, streaming  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

# MsmConfig(window_bits=8, scan_lanes=8) of the JAX package, its defaults
# written out where the port's differ.
C8 = MsmConfig(window_bits=8, scan_lanes=8, reduce_fanout=4096,
               signed_digits=False, segment_starts="bincount")
# Scalars below 2^16 in two c = 8 windows: the cases that test the chunks'
# plumbing rather than the window arithmetic (which C8 covers), each a few
# seconds of plain EC ops on the CPU.
SMALL = MsmConfig(window_bits=8, scan_lanes=8, scalar_bits=16,
                  signed_digits=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of narrow plain EC ops; beside other test workers torch's
    intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, seed, scalar_bits=None):
    """n seeded points k·G (k < 2^22, as test_dispatch.py's
    `_array_inputs`) and scalars mod r, or below 2^scalar_bits; returns
    (points, scalars, px, py, sl)."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 22, size=n)]
    pts = [oracle.ec_mul(oracle.GEN, k) for k in ks]
    if scalar_bits is None:
        sc = [int.from_bytes(rng.bytes(32), "little") % bn254.FR
              for _ in range(n)]
    else:
        sc = [int(s) for s in rng.randint(0, 1 << scalar_bits, size=n)]
    px, py = interop.affine_points_to_limbs(pts)
    return pts, sc, px, py, interop.ints_to_limbs(sc)


def _affine(res):
    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


@pytest.fixture(scope="module")
def case():
    return _inputs(100, 91)


def test_msm_streamed_matches_jax(case):
    """Four chunks of 32, the last padded with 28 infinities."""
    from tpu_msm.ops import streaming as jstreaming
    from tpu_msm.utils.config import MsmConfig as JaxMsmConfig

    pts, sc, px, py, sl = case
    jres = jstreaming.msm_streamed(px, py, sl,
                                   cfg=JaxMsmConfig(window_bits=8,
                                                    scan_lanes=8),
                                   chunk_log=5)
    [want] = interop.proj_limbs_to_affine_points(
        *(np.asarray(a) for a in jres))
    res = streaming.msm_streamed(px, py, sl, C8, chunk_log=5, device="cpu")
    assert res.x.shape == (16, 1)
    assert _affine(res) == want == oracle.msm(sc, pts)


def test_accumulate_matches_jax():
    """(32, 16, 1) seeded window sums in random projective scales; window
    0 of acc is infinity, ws equals acc at window 1 (a doubling), -acc at
    window 2 (a cancellation), and is infinity at window 3."""
    import jax
    import jax.numpy as jnp

    from tpu_msm.ops import streaming as jstreaming
    from tpu_msm.ops.curve import ProjPoint as JaxProjPoint

    rng = np.random.RandomState(92)
    w = 32
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=2 * w)]
    pts = [oracle.ec_mul(oracle.GEN, k) for k in ks]
    pts[w + 1] = pts[1]
    pts[w + 2] = oracle.ec_neg(pts[2])
    px, py = interop.affine_points_to_limbs(pts)
    lam = interop.fp_ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(32), "little") % (bn254.P - 1) + 1
         for _ in range(2 * w)])
    proj = curve.affine_to_proj(AffinePoint(*(torch.from_numpy(
        a.view(np.int32)) for a in (px, py))))
    lam_t = torch.from_numpy(lam.view(np.int32))
    scaled = ProjPoint(*(field.mont_mul(a, lam_t) for a in proj))
    scaled = curve.select_point(
        torch.isin(torch.arange(2 * w), torch.tensor([0, w + 3])),
        curve.proj_infinity((2 * w,), "cpu"), scaled)

    def windows(lo):  # (16, 2W) -> (W, 16, 1)
        return ProjPoint(*(a[:, lo:lo + w].t().reshape(w, 16, 1).contiguous()
                           for a in scaled))

    acc, ws = windows(0), windows(w)
    got = streaming.accumulate(acc, ws)
    assert got.x.shape == (w, 16, 1)
    jgot = jax.jit(jstreaming._accumulate)(
        *(JaxProjPoint(*(jnp.asarray(interop.tensor_to_limbs(a))
                         for a in p)) for p in (acc, ws)))
    rows = [interop.tensor_to_limbs(a.reshape(w, 16).t()) for a in got]
    jrows = [np.asarray(a).reshape(w, 16).T for a in jgot]
    want = [oracle.ec_add(pts[i], pts[w + i]) for i in range(w)]
    want[0] = pts[w]
    want[3] = pts[3]
    assert interop.proj_limbs_to_affine_points(*rows) == \
        interop.proj_limbs_to_affine_points(*jrows) == want
    assert want[2] is None


def test_resident_and_host_streamed_bit_identical():
    """100 points in chunks of 2^5 on the CPU, where both residency
    settings slice the input where it lies (the pinned staging buffers run
    on the card alone: `test_msm_streamed_on_the_card` and chip_smoke.py
    phase 11 hold them): resident=True and resident=False on numpy, and
    CPU tensors with resident=False and unset, give identical projective
    limbs, equal to the oracle and the native engine."""
    pts, sc, px, py, sl = _inputs(100, 93, scalar_bits=16)
    runs = [streaming.msm_streamed(px, py, sl, SMALL, chunk_log=5,
                                   resident=r, device="cpu")
            for r in (True, False)]
    tensors = interop.limbs_to_device(px, py, sl, "cpu")
    runs += [streaming.msm_streamed(*tensors, SMALL, chunk_log=5, resident=r,
                                    device="cpu") for r in (False, None)]
    for res in runs[1:]:
        for a, b in zip(res, runs[0]):
            assert torch.equal(a, b)
    assert _affine(runs[0]) == oracle.msm(sc, pts) == native.msm(px, py, sl)


def test_resident_by_default_on_cpu():
    assert streaming.resident_by_default(1 << 30, 1 << 22, "cpu")


@pytest.mark.parametrize("total,log_n,log_chunk,resident", [
    (80 * 10**9, 23, 22, True), (80 * 10**9, 24, 22, True),
    (80 * 10**9, 25, 22, False), (80 * 10**9, 27, 22, False),
    (80 * 10**9, 27, 25, True), (80 * 10**9, 29, 27, False),
    (16 * 10**9, 24, 22, True), (4 * 10**9, 24, 22, False)])
def test_resident_by_default_on_a_card(monkeypatch, total, log_n, log_chunk,
                                       resident):
    """The rule's arithmetic for cards of 80, 16 and 4 GB: at most
    RESIDENT_MAX_CHUNKS chunks, and the inputs, the group budget (1/8) and
    a chunk's working set within 7/8 of the memory. 2^24 points in chunks
    of 2^22 stay resident on 80 and 16 GB, not on 4; 2^25 and up are
    host-streamed; 2^27 in chunks of 2^25 (24 GiB) fits 80 GB, 2^29 in
    chunks of 2^27 does not."""
    class Props:
        total_memory = total

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    n, chunk = 1 << log_n, 1 << log_chunk
    assert streaming.resident_by_default(n, chunk, "cuda") is resident
    need = (n * streaming.INPUT_BYTES_PER_POINT + total // 8
            + chunk * streaming.CHUNK_BYTES_PER_POINT)
    assert (n <= streaming.RESIDENT_MAX_CHUNKS * chunk
            and need <= (1 - streaming.FREE_SHARE) * total) is resident


@pytest.mark.parametrize("n,chunk_logs", [(100, [6]), (64, [])])
def test_msm_routes_above_stream_threshold(monkeypatch, n, chunk_logs):
    """STREAM_THRESHOLD = 64: 100 points go to msm_streamed in chunks of
    2^6, 64 do not; both equal the oracle."""
    pts, sc, px, py, sl = _inputs(n, 94, scalar_bits=16)
    monkeypatch.setattr(tpu_msm_torch, "STREAM_THRESHOLD", 64)
    calls = []
    orig = streaming.msm_streamed

    def spy(*a, **kw):
        calls.append(kw.get("chunk_log"))
        return orig(*a, **kw)

    monkeypatch.setattr(streaming, "msm_streamed", spy)
    got = tpu_msm_torch.msm((px, py), sl, SMALL, device="cpu")
    assert calls == chunk_logs
    assert got == oracle.msm(sc, pts)


def _card_inputs(seed, n):
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    sl = interop.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % bn254.FR
         for _ in range(n)])
    return px, py, sl


@pytest.mark.cuda
def test_msm_streamed_on_the_card(cuda):
    """Full scalars, chunks of 2^10, the card's selected configuration:
    host-streamed (pinned staging) and resident bit-identical, from tensors
    on the card too, and equal to the unstreamed pipeline and the native
    engine."""
    n = (1 << 12) + 37
    px, py, sl = _card_inputs(95, n)
    want = native.msm(px, py, sl)
    runs = [streaming.msm_streamed(px, py, sl, chunk_log=10, resident=r,
                                   device=cuda) for r in (True, False)]
    dev = interop.limbs_to_device(px, py, sl, cuda)
    runs.append(streaming.msm_streamed(*dev, chunk_log=10, device=cuda))
    for res in runs[1:]:
        for a, b in zip(res, runs[0]):
            assert torch.equal(a, b)
    assert _affine(runs[0]) == want
    assert _affine(tpu_msm_torch.msm_device(
        *dev, tpu_msm_torch.select_config(n, cuda))) == want


@pytest.mark.cuda
@pytest.mark.parametrize("where,resident,route", [
    ("cuda", None, "_resident_chunks"), ("cuda", False, "_host_chunks"),
    ("cpu", False, "_host_chunks"), ("cpu", True, "_resident_chunks"),
    ("numpy", False, "_host_chunks")])
def test_residency_on_the_card(cuda, monkeypatch, where, resident, route):
    """Tensors on the card are resident unless resident=False is asked for;
    an explicit resident=False host-streams card tensors, CPU tensors and
    numpy alike; each result equals the native engine."""
    px, py, sl = _card_inputs(97, (1 << 11) + 3)
    if where == "numpy":
        args = (px, py, sl)
    else:
        args = interop.limbs_to_device(px, py, sl, where)
    taken = []
    for name in ("_resident_chunks", "_host_chunks"):
        orig = getattr(streaming, name)
        monkeypatch.setattr(streaming, name, lambda *a, _n=name, _f=orig:
                            taken.append(_n) or _f(*a))
    res = streaming.msm_streamed(*args, chunk_log=10, resident=resident,
                                 device=cuda)
    assert taken == [route]
    assert _affine(res) == native.msm(px, py, sl)


@pytest.mark.cuda
def test_msm_routes_above_stream_threshold_on_the_card(cuda, monkeypatch):
    """STREAM_THRESHOLD = 2^10 on the card: msm_best on 2^12 + 5 points
    goes to msm_streamed with chunk log 10, whose five chunks run
    window_sums each (the per-window route: 512 lanes at 2^10), then one
    horner launch."""
    from tpu_msm_torch.ops import cuda_curve, pippenger

    n = (1 << 12) + 5
    px, py, sl = _card_inputs(96, n)
    monkeypatch.setattr(tpu_msm_torch, "STREAM_THRESHOLD", 1 << 10)
    monkeypatch.setattr(tpu_msm_torch, "CPU_THRESHOLD", 0)
    calls = []
    orig = streaming.msm_streamed

    def spy(*a, **kw):
        calls.append(kw.get("chunk_log"))
        return orig(*a, **kw)

    monkeypatch.setattr(streaming, "msm_streamed", spy)
    chunks = []
    sums = pippenger.window_sums

    def chunk_spy(points, *a, **kw):
        chunks.append(points.x.shape[1])
        return sums(points, *a, **kw)

    monkeypatch.setattr(pippenger, "window_sums", chunk_spy)
    cuda_curve.horner.launches = 0
    cuda_curve.pmadd.launches = 0
    assert tpu_msm_torch.msm_best(sl, (px, py), device=cuda) == \
        native.msm(px, py, sl)
    assert calls == [10]
    assert chunks == [1 << 10] * 5
    assert cuda_curve.pmadd.launches >= 5
    assert cuda_curve.horner.launches == 1


def test_tiled_expected_matches_native():
    """The independent reference of the 2^24 smoke phase
    (`benches/dispatch_benchmark.tiled_expected`: the MSM folded onto its
    512 base points) against the native engine on all 4096 points."""
    from tpu_msm_torch.benches import dispatch_benchmark as db

    px, py, sl, base = db.tiled_inputs(4096)
    assert int(sl[15].max()) <= db.TOP_LIMB_MASK
    assert db.tiled_expected(base, sl) == native.msm(px, py, sl)
