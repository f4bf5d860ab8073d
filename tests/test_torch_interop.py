"""The port's host interop (tpu_msm_torch.utils.interop) and its entry points'
limb inputs, on the CPU.

* Each wire-format function against its JAX counterpart
  (`tpu_msm/utils/interop.py:69-184`) on the same seeded inputs: pure
  numpy and Python ints, so the comparison is exact.
* The wire cases of tests/vectors/bn254_golden.json, as
  tests/test_golden_vectors.py runs them. The fixture comes from a second,
  independent implementation (tests/vectors/independent_bn254.py).
* `msm(..., device="cpu")` on the fixture's MSM cases of at most 64 points
  with the JAX device test's configuration (c = 8, 8 lanes; the JAX
  `MsmConfig` defaults for the rest), each equal to the fixture's result;
  the larger cases run on the card (`cuda`).
* Limb tensors through `msm` and `msm_best`: they stay tensors, and on the
  card they stay there (`cuda`).

jax and the JAX package are imported inside fixtures only, so the `cuda`
cases also run where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_interop.py
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_msm_torch  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "vectors"
                     / "bn254_golden.json").read_text())

# tests/test_golden_vectors.py's configurations, with the JAX MsmConfig
# defaults the port's MsmConfig does not share (unsigned digits, fanout
# 4096, "bincount" segment starts) written out.
JAX_DEFAULTS = dict(reduce_fanout=4096, signed_digits=False,
                    segment_starts="bincount")
C8 = MsmConfig(window_bits=8, scan_lanes=8, **JAX_DEFAULTS)
GOLDEN_CONFIGS = {
    "random_n16": C8, "random_n64": C8, "zeros_n64": C8,
    "identity_pts_n64": C8, "max_scalar_n64": C8, "dup_points_n64": C8,
    "random_n256": C8,
    "random_n64_c16": MsmConfig(window_bits=16, scan_lanes=8, **JAX_DEFAULTS),
    "random_n1024": MsmConfig(window_bits=8, scan_lanes=64,
                              **dict(JAX_DEFAULTS, signed_digits=True)),
}
# The cases the JAX package's device test runs (n <= 64, c = 8).
CPU_CASES = ["random_n16", "random_n64", "zeros_n64", "identity_pts_n64",
             "max_scalar_n64", "dup_points_n64"]


def _case(name):
    [c] = [c for c in GOLDEN["msm_cases"] if c["name"] == name]
    scalars = [int(s, 16) for s in c["scalars"]]
    points = [None if p is None else (int(p[0], 16), int(p[1], 16))
              for p in c["points"]]
    result = (None if c["result"] is None
              else (int(c["result"][0], 16), int(c["result"][1], 16)))
    return scalars, points, result


@pytest.fixture(scope="module")
def jinterop():
    from tpu_msm.utils import interop as jinterop

    return jinterop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The MSM cases run thousands of narrow plain EC ops; beside other
    test workers torch's intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seeded():
    """Seeded field ints below P (with 0, 1, P - 1), 256-bit limb arrays,
    and affine points with infinities."""
    rng = np.random.RandomState(71)
    ints = [int.from_bytes(rng.bytes(32), "little") % bn254.P
            for _ in range(40)]
    ints[:3] = [0, 1, bn254.P - 1]
    limbs = rng.randint(0, 1 << 16, size=(16, 40)).astype(np.uint32)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=12)]
    points = [oracle.ec_mul(oracle.GEN, k) for k in ks]
    points[3] = points[7] = None
    return ints, limbs, points


# --------------------------------------------------------------------------
# Wire formats against the JAX package.
# --------------------------------------------------------------------------

def test_mont_conversions_match_jax(jinterop, seeded):
    ints, _, _ = seeded
    got = interop.fp_ints_to_mont_limbs(ints)
    np.testing.assert_array_equal(got, jinterop.fp_ints_to_mont_limbs(ints))
    assert got.dtype == np.uint32
    assert interop.mont_limbs_to_fp_ints(got) == \
        jinterop.mont_limbs_to_fp_ints(got) == ints


@pytest.mark.parametrize("mont", [True, False])
def test_affine_points_mont_flag_matches_jax(jinterop, seeded, mont):
    _, _, points = seeded
    got = interop.affine_points_to_limbs(points, mont=mont)
    want = jinterop.affine_points_to_limbs(points, mont=mont)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert interop.limbs_to_affine_points(*got, mont=mont) == \
        jinterop.limbs_to_affine_points(*want, mont=mont) == points


def test_jac_and_proj_readback_match_jax(jinterop, seeded):
    """(X, Y, Z) limbs with Z random, and 0 on two columns: the Jacobian
    and projective readbacks give the JAX package's points."""
    ints, _, _ = seeded
    xyz = [interop.fp_ints_to_mont_limbs(ints[k:k + 12]) for k in (0, 12, 24)]
    xyz[2][:, [3, 5]] = 0
    for fn in ("jac_limbs_to_affine_points", "proj_limbs_to_affine_points"):
        got = getattr(interop, fn)(*xyz)
        assert got == getattr(jinterop, fn)(*xyz)
        assert got[3] is None and got[5] is None
    # A point read back through both: (X, Y, Z) = (x z^2, y z^3, z) in
    # Jacobian and (x z, y z, z) in projective coordinates.
    _, _, points = seeded
    x, y = points[0]
    z = ints[5]
    jac = [interop.fp_ints_to_mont_limbs([v])
           for v in (x * z * z % bn254.P, y * pow(z, 3, bn254.P), z)]
    proj = [interop.fp_ints_to_mont_limbs([v])
            for v in (x * z % bn254.P, y * z % bn254.P, z)]
    assert interop.jac_limbs_to_affine_points(*jac) == [(x, y)]
    assert interop.proj_limbs_to_affine_points(*proj) == [(x, y)]


def test_ark_u32_limbs_match_jax(jinterop, seeded):
    _, limbs, _ = seeded
    ark = interop.to_ark_u32_limbs(limbs)
    np.testing.assert_array_equal(ark, jinterop.to_ark_u32_limbs(limbs))
    assert ark.shape == (40, 8) and ark.dtype == np.uint32
    back = interop.from_ark_u32_limbs(ark)
    np.testing.assert_array_equal(back, jinterop.from_ark_u32_limbs(ark))
    np.testing.assert_array_equal(back, limbs)
    # Big-endian words: column 0 holds the top 32 bits.
    assert int(ark[0, 0]) == interop.limbs_to_ints(limbs[:, :1])[0] >> 224


def test_h2c_bytes_match_jax(jinterop, seeded):
    _, limbs, _ = seeded
    data = interop.to_h2c_bytes(limbs)
    np.testing.assert_array_equal(data, jinterop.to_h2c_bytes(limbs))
    assert data.shape == (40, 32) and data.dtype == np.uint8
    assert bytes(data[1]) == interop.limbs_to_ints(
        limbs[:, 1:2])[0].to_bytes(32, "little")
    back = interop.from_h2c_bytes(data)
    np.testing.assert_array_equal(back, jinterop.from_h2c_bytes(data))
    np.testing.assert_array_equal(back, limbs)


# --------------------------------------------------------------------------
# Wire formats against the golden fixture (tests/test_golden_vectors.py).
# --------------------------------------------------------------------------

def test_curve_constants_match_published():
    assert bn254.P == int(GOLDEN["p"], 16)
    assert bn254.FR == int(GOLDEN["r"], 16)
    assert (bn254.GX, bn254.GY) == tuple(int(v, 16)
                                         for v in GOLDEN["generator"])
    assert oracle.ec_mul(oracle.GEN, 2) == tuple(
        int(v, 16) for v in GOLDEN["g2_published"])


def test_ark_fq_wire_format():
    vals = [int(e["value"], 16) for e in GOLDEN["fq_wire"]]
    exp = np.array([e["ark_u32"] for e in GOLDEN["fq_wire"]], dtype=np.uint32)
    got = interop.to_ark_u32_limbs(interop.fp_ints_to_mont_limbs(vals))
    np.testing.assert_array_equal(got, exp)
    assert interop.mont_limbs_to_fp_ints(
        interop.from_ark_u32_limbs(exp)) == vals


def test_ark_fr_wire_format():
    vals = [int(e["value"], 16) for e in GOLDEN["fr_wire"]]
    exp = np.array([e["ark_u32"] for e in GOLDEN["fr_wire"]], dtype=np.uint32)
    got = interop.to_ark_u32_limbs(interop.ints_to_limbs(vals))
    np.testing.assert_array_equal(got, exp)


def test_h2c_byte_formats():
    fr_vals = [int(e["value"], 16) for e in GOLDEN["fr_wire"]]
    exp_fr = np.stack([np.frombuffer(bytes.fromhex(e["h2c_bytes"]),
                                     dtype=np.uint8)
                       for e in GOLDEN["fr_wire"]])
    got_fr = interop.to_h2c_bytes(interop.ints_to_limbs(fr_vals))
    np.testing.assert_array_equal(got_fr, exp_fr)
    assert interop.limbs_to_ints(interop.from_h2c_bytes(exp_fr)) == fr_vals

    fq_vals = [int(e["value"], 16) for e in GOLDEN["fq_wire"]]
    exp_fq = np.stack([np.frombuffer(bytes.fromhex(e["h2c_raw_bytes"]),
                                     dtype=np.uint8)
                       for e in GOLDEN["fq_wire"]])
    got_fq = interop.to_h2c_bytes(interop.fp_ints_to_mont_limbs(fq_vals))
    np.testing.assert_array_equal(got_fq, exp_fq)


def test_point_wire_format():
    """Affine points -> the reference's 24-limb (x, y, z = 1) Montgomery
    form (ToLimbs<24>, limbs_conversion.rs:123-139, 314-327)."""
    one = interop.fp_ints_to_mont_limbs([1])
    for entry in GOLDEN["point_wire"]:
        pt = (int(entry["x"], 16), int(entry["y"], 16))
        px, py = interop.affine_points_to_limbs([pt])
        got = np.concatenate([interop.to_ark_u32_limbs(a)[0]
                              for a in (px, py, one)])
        assert got.tolist() == entry["ark_u32_24"]


# --------------------------------------------------------------------------
# MSM against the golden fixture.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CPU_CASES)
def test_msm_matches_golden_on_cpu(name):
    scalars, points, result = _case(name)
    assert tpu_msm_torch.msm(points, scalars, GOLDEN_CONFIGS[name],
                             device="cpu") == result


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GOLDEN_CONFIGS))
def test_msm_matches_golden_on_the_card(cuda, name):
    scalars, points, result = _case(name)
    assert tpu_msm_torch.msm(points, scalars, GOLDEN_CONFIGS[name],
                             device=cuda) == result


# --------------------------------------------------------------------------
# Limb tensors through the entry points.
# --------------------------------------------------------------------------

def _limb_inputs(n, seed, zero_every=None):
    """n seeded points, scalars below 2^16 (two c = 8 windows), as numpy
    limb arrays; every `zero_every`-th scalar 0."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    sc = [int(s) for s in rng.randint(0, 1 << 16, size=n)]
    if zero_every:
        sc[::zero_every] = [0] * len(sc[::zero_every])
    return px, py, interop.ints_to_limbs(sc)


SMALL = MsmConfig(window_bits=8, scan_lanes=8, scalar_bits=16,
                  signed_digits=False)


def test_limb_tensor_on_its_device_is_not_copied():
    px, _, _ = _limb_inputs(8, 81)
    t = torch.from_numpy(px.view(np.int32))
    assert interop.limb_tensor(t, "cpu") is t
    with pytest.raises(ValueError, match="int32"):
        interop.limb_tensor(t.to(torch.int64), "cpu")
    with pytest.raises(ValueError, match=r"\(16, N\)"):
        interop.limb_tensor(t[:8], "cpu")


def test_msm_takes_limb_tensors():
    px, py, sl = _limb_inputs(40, 82)
    tensors = interop.limbs_to_device(px, py, sl, "cpu")
    want = native.msm(px, py, sl)
    assert tpu_msm_torch.msm(tensors[:2], tensors[2], SMALL,
                             device="cpu") == want


@pytest.mark.parametrize("zero_every", [None, 2])
def test_msm_best_keeps_limb_tensors(monkeypatch, zero_every):
    """msm_best hands the device route tensors (filtered where half the
    scalars are zero), and the native route numpy arrays."""
    px, py, sl = _limb_inputs(40, 83, zero_every)
    tensors = interop.limbs_to_device(px, py, sl, "cpu")
    want = native.msm(px, py, sl)
    assert tpu_msm_torch.msm_best(tensors[2], tensors[:2],
                                  device="cpu") == want  # native route
    seen = []
    msm = tpu_msm_torch.msm

    def spy(points, scalars, cfg=None, device=None):
        seen.append((points, scalars))
        return msm(points, scalars, SMALL, device)

    monkeypatch.setattr(tpu_msm_torch, "msm", spy)
    monkeypatch.setattr(tpu_msm_torch, "CPU_THRESHOLD", 0)
    assert tpu_msm_torch.msm_best(tensors[2], tensors[:2],
                                  device="cpu") == want
    [((gx, gy), gs)] = seen
    kept = 40 if zero_every is None else 20
    for t in (gx, gy, gs):
        assert isinstance(t, torch.Tensor) and t.shape == (16, kept)


@pytest.mark.cuda
def test_msm_and_msm_best_take_limb_tensors_on_the_card(cuda, monkeypatch):
    """(16, N) int32 tensors on the card through msm and msm_best, full
    scalars, the selected configuration; with half the scalars zero
    msm_best filters on the card."""
    rng = np.random.RandomState(84)
    n = 1 << 12
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch((bn254.GX, bn254.GY),
                                 interop.ints_to_limbs(ks))
    sl = interop.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % bn254.FR
         for _ in range(n)])
    monkeypatch.setattr(tpu_msm_torch, "CPU_THRESHOLD", 0)
    for zeros in (False, True):
        if zeros:
            sl[:, ::2] = 0
        want = native.msm(px, py, sl)
        dpx, dpy, dsl = interop.limbs_to_device(px, py, sl, cuda)
        assert tpu_msm_torch.msm((dpx, dpy), dsl, device=cuda) == want
        assert tpu_msm_torch.msm_best(dsl, (dpx, dpy), device=cuda) == want
