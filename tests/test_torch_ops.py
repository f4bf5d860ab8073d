"""The rest of the port's plain ops and constants against the JAX package,
Python ints and the pure-Python oracle: `models/bn254.py`'s constants and
limb helpers, `ops/u256.py`'s products and shifts, `ops/field.py`'s
reduction, conversions, powers and inverses, `ops/curve.py`'s scalar
multiplication, conversions and predicates, and the native engine's
Jacobian result (`bindings/native.msm_jacobian_limbs`).

The u256 and field functions with a cheap JAX graph are held against the
JAX functions on the same limbs, evaluated eagerly under jax.disable_jit()
as tests/test_torch_field_curve.py does. The JAX versions of the powers,
inverses and curve ops unroll hundreds of products (minutes to compile on
the CPU; their own tests are `device`-marked), so those are held against
Python ints and the oracle instead.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_msm.bindings import native as jnative  # noqa: E402
from tpu_msm.models import bn254 as jbn254  # noqa: E402
from tpu_msm.ops import field as jfield  # noqa: E402
from tpu_msm.ops import u256 as ju256  # noqa: E402
from tpu_msm.utils import oracle  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import curve, field, u256  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint, JacPoint, ProjPoint  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402

P, R = bn254.P, bn254.R
R_INV = pow(R, -1, P)
EDGE = [0, 1, P - 1, R - 1]


def _t(a):
    """uint32 limbs -> int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _ints(t):
    return interop.limbs_to_ints(interop.tensor_to_limbs(t))


def _limbs(values, n=bn254.LIMBS):
    return np.stack([bn254.int_to_limbs(v, n) for v in values], axis=1)


def _jax(fn, *args):
    """A JAX function, eagerly, on uint32 limb arrays -> numpy."""
    with jax.disable_jit():
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def _rand(rng, n, below=R):
    return [int.from_bytes(rng.bytes(32), "little") % below for _ in range(n)]


# --------------------------------------------------------------------------
# models/bn254.py
# --------------------------------------------------------------------------

CONSTANTS = [
    "LIMB_BITS", "LIMBS", "LIMB_MASK", "TOTAL_BITS", "R", "P", "FR",
    "A_CURVE", "B_CURVE", "GX", "GY", "R_MOD_P", "R2_MOD_P", "R3_MOD_P",
    "P_INV_NEG", "R_MOD_FR", "R2_MOD_FR", "FR_INV_NEG", "GX_MONT", "GY_MONT",
    "B_MONT", "THREE_B_MONT", "SCALAR_BITS", "MODULUS_BITS", "SQRT_EXP",
    "P_LIMBS", "R_MOD_P_LIMBS", "R2_MOD_P_LIMBS", "P_INV_NEG_LIMBS",
    "FR_LIMBS", "R_MOD_FR_LIMBS", "R2_MOD_FR_LIMBS", "FR_INV_NEG_LIMBS",
    "GX_MONT_LIMBS", "GY_MONT_LIMBS", "B_MONT_LIMBS"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches_jax(name):
    got, want = getattr(bn254, name), getattr(jbn254, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("n", [16, 8, 32])
def test_int_to_limbs_and_back_match_jax(n):
    rng = np.random.RandomState(60 + n)
    for x in [0, 1, (1 << (16 * n)) - 1] + _rand(rng, 8, 1 << (16 * n)):
        got = bn254.int_to_limbs(x, n)
        np.testing.assert_array_equal(got, jbn254.int_to_limbs(x, n))
        assert got.dtype == np.uint32
        assert bn254.limbs_to_int(got) == jbn254.limbs_to_int(got) == x
    for bad in (-1, 1 << (16 * n)):
        with pytest.raises(ValueError):
            bn254.int_to_limbs(bad, n)


# --------------------------------------------------------------------------
# ops/u256.py
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """A few dozen (a, b) pairs of 256-bit values with the edges on both
    sides, as uint32 limbs and as tensors."""
    rng = np.random.RandomState(61)
    xs = EDGE + EDGE[::-1] + _rand(rng, 28)
    ys = EDGE[::-1] + EDGE + _rand(rng, 28)
    a, b = _limbs(xs), _limbs(ys)
    return xs, ys, a, b


def test_zeros_and_from_const_match_jax():
    got = u256.zeros((3, 2))
    assert got.shape == (16, 3, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ju256.zeros((3, 2))))
    for ndim in (1, 2):
        got = u256.from_const(bn254.P_LIMBS, ndim)
        want = np.asarray(ju256.from_const(jbn254.P_LIMBS, ndim))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("name", ["mul_full", "mul_lo"])
def test_products_match_jax_and_ints(pairs, name):
    xs, ys, a, b = pairs
    got = getattr(u256, name)(_t(a), _t(b))
    want = _jax(getattr(ju256, name), a, b)
    np.testing.assert_array_equal(interop.tensor_to_limbs(got), want)
    mod = 1 << (256 if name == "mul_lo" else 512)
    assert _ints(got) == [x * y % mod for x, y in zip(xs, ys)]


@pytest.mark.parametrize("k", [0, 1, 7, 15, 16, 17, 31, 32, 100, 255])
def test_shifts_match_jax_and_ints(pairs, k):
    xs, _, a, _ = pairs
    for name, ref in (("shl", lambda x: (x << k) % R), ("shr",
                                                          lambda x: x >> k)):
        got = getattr(u256, name)(_t(a), k)
        with jax.disable_jit():
            want = np.asarray(getattr(ju256, name)(jnp.asarray(a), k))
        np.testing.assert_array_equal(interop.tensor_to_limbs(got), want)
        assert _ints(got) == [ref(x) for x in xs]


# --------------------------------------------------------------------------
# ops/field.py against the JAX functions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def elems():
    """Field elements (< P) with the edges, and 256-bit values."""
    rng = np.random.RandomState(62)
    fs = [0, 1, P - 1, R % P] + _rand(rng, 28, P)
    gs = [P - 1, 0, 1, 2] + _rand(rng, 28, P)
    return fs, gs, EDGE + _rand(rng, 28)


def test_p_limbs_and_const_mont_match_jax():
    like = torch.zeros((16, 5), dtype=torch.int32)
    np.testing.assert_array_equal(
        field.p_limbs(like).numpy(),
        np.asarray(jfield.p_limbs(jnp.zeros((16, 5), jnp.uint32)))
        .astype(np.int32))
    got = field.const_mont(bn254.GX_MONT, "cpu")
    assert got.shape == (16, 1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfield.const_mont(jbn254.GX_MONT))
        .astype(np.int32))


def test_redc_matches_jax_and_ints(elems):
    """t below P·2^256: the 256-bit values in the low half, field elements
    in the high half, and the largest t, P·2^256 - 1."""
    fs, _, ws = elems
    ts = [lo + (hi << 256) for lo, hi in zip(ws, fs)] + [P * R - 1]
    t = _limbs(ts, 32)
    got = field.redc(_t(t))
    np.testing.assert_array_equal(interop.tensor_to_limbs(got),
                                  _jax(jfield.redc, t))
    assert _ints(got) == [x * R_INV % P for x in ts]


@pytest.mark.parametrize("name,ref", [
    ("to_mont", lambda x: x * R % P),
    ("from_mont", lambda x: x * R_INV % P),
    ("mont_sqr", lambda x: x * x * R_INV % P),
])
def test_unary_matches_jax_and_ints(elems, name, ref):
    """to_mont and from_mont take any 256-bit value; mont_sqr a field
    element."""
    fs, _, ws = elems
    xs = fs if name == "mont_sqr" else ws
    a = _limbs(xs)
    got = getattr(field, name)(_t(a))
    np.testing.assert_array_equal(interop.tensor_to_limbs(got),
                                  _jax(getattr(jfield, name), a))
    assert _ints(got) == [ref(x) for x in xs]


def test_mont_mul_many_matches_jax(elems):
    fs, gs, _ = elems
    a, b = _limbs(fs), _limbs(gs)
    got = field.mont_mul_many([(_t(a), _t(b)), (_t(b), _t(b)),
                               (_t(a), _t(a))])
    with jax.disable_jit():
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        want = jfield.mont_mul_many([(ja, jb), (jb, jb), (ja, ja)])
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.tensor_to_limbs(g),
                                      np.asarray(w))
    assert _ints(got[0]) == [x * y * R_INV % P for x, y in zip(fs, gs)]


# --------------------------------------------------------------------------
# ops/field.py: powers and inverses against Python ints
# --------------------------------------------------------------------------

def _mont(values):
    return _t(_limbs([v * R % P for v in values]))


def _plain(t):
    return [v * R_INV % P for v in _ints(t)]


@pytest.mark.parametrize("e", [0, 1, 2, 3, 65537, P - 2])
def test_pow_fixed(e):
    xs = [0, 1, 2, P - 1, 12345] + _rand(np.random.RandomState(63), 3, P)
    got = _plain(field.pow_fixed(_mont(xs), e))
    assert got == [pow(x, e, P) if (x or e) else 1 for x in xs]


def test_inv_mont_and_zero():
    xs = [0, 1, 2, P - 1] + _rand(np.random.RandomState(64), 4, P)
    got = _plain(field.inv_mont(_mont(xs)))
    assert got == [pow(x, -1, P) if x else 0 for x in xs]


@pytest.mark.parametrize("n,zeros", [(1, []), (16, [3]), (17, [0, 9, 16]),
                                     (40, [5, 6])])
def test_batch_inv_mont(n, zeros):
    xs = _rand(np.random.RandomState(65 + n), n, P)
    for i in zeros:
        xs[i] = 0
    got = _plain(field.batch_inv_mont(_mont(xs)))
    assert got == [pow(x, -1, P) if x else 0 for x in xs]


def test_batch_inv_mont_over_a_second_batch_axis():
    xs = _rand(np.random.RandomState(66), 12, P)
    xs[4] = 0
    got = field.batch_inv_mont(_mont(xs).reshape(16, 4, 3))
    assert _plain(got.reshape(16, 12)) == [pow(x, -1, P) if x else 0
                                           for x in xs]


def test_sqrt_mont():
    """Squares give a root; a non-residue (-1, as P = 3 mod 4) gives a
    candidate whose square is not it."""
    rng = np.random.RandomState(67)
    roots = [0, 1, 2] + _rand(rng, 5, P)
    squares = [r * r % P for r in roots]
    got = _plain(field.sqrt_mont(_mont(squares + [P - 1])))
    for s, g in zip(squares, got):
        assert g * g % P == s and g == oracle.fp_sqrt(s)
    assert got[-1] * got[-1] % P != P - 1
    assert oracle.fp_sqrt(P - 1) is None


# --------------------------------------------------------------------------
# ops/curve.py against the oracle
# --------------------------------------------------------------------------

def _points(rng, n):
    return [oracle.ec_mul(oracle.GEN, int(k))
            for k in rng.randint(1, 1 << 30, size=n)]


def _jac(points, zs):
    """Jacobian (x·z^2, y·z^3, z) of affine points (None: (1, 1, 0)),
    Montgomery limb tensors."""
    cols = []
    for pt, z in zip(points, zs):
        if pt is None:
            cols.append((1, 1, 0))
        else:
            cols.append((pt[0] * z * z % P, pt[1] * z ** 3 % P, z))
    return JacPoint(*(_mont(list(c)) for c in zip(*cols)))


def _proj(points, zs):
    cols = [(0, 1, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z)
            for pt, z in zip(points, zs)]
    return ProjPoint(*(_mont(list(c)) for c in zip(*cols)))


def _affine(pt: AffinePoint):
    return interop.limbs_to_affine_points(interop.tensor_to_limbs(pt.x),
                                          interop.tensor_to_limbs(pt.y))


@pytest.mark.parametrize("n", [5, 16, 17])
def test_jac_and_proj_to_affine(n):
    """Batches at and above the batch-inverse rule (16), with infinity."""
    rng = np.random.RandomState(70 + n)
    pts = _points(rng, n)
    pts[1] = None
    zs = _rand(rng, n, P - 1)
    zs = [z + 1 for z in zs]
    assert _affine(curve.jac_to_affine(_jac(pts, zs))) == pts
    assert _affine(curve.proj_to_affine(_proj(pts, zs))) == pts


def test_scalar_mul():
    """Per lane, at the full 256 bits and at 20 bits; scalars 0, 1, r - 1,
    r, 2^256 - 1 and random, on points and infinity."""
    rng = np.random.RandomState(71)
    ks = [0, 1, bn254.FR - 1, bn254.FR, R - 1] + _rand(rng, 3)
    pts = _points(rng, len(ks))
    pts[2] = None
    base = _jac(pts, [1] * len(ks))
    got = _affine(curve.jac_to_affine(curve.scalar_mul(base, _t(_limbs(ks)))))
    assert got == [oracle.ec_mul(p, k) if p else None
                   for p, k in zip(pts, ks)]
    small = [int(k) for k in rng.randint(0, 1 << 20, size=4)]
    got = curve.scalar_mul(_jac(pts[:4], [1] * 4), _t(_limbs(small)),
                           num_bits=20)
    assert _affine(curve.jac_to_affine(got)) == [
        oracle.ec_mul(p, k) if p else None for p, k in zip(pts, small)]


@pytest.mark.parametrize("c", [1, 2, 8, 16])
def test_mul_all_ones(c):
    rng = np.random.RandomState(72 + c)
    pts = _points(rng, 3) + [None]
    got = curve.mul_all_ones(_jac(pts, [3, 5, 7, 1]), c)
    assert _affine(curve.jac_to_affine(got)) == [
        oracle.ec_mul(p, (1 << c) - 1) if p else None for p in pts]


def test_affine_on_curve_and_generator():
    g = curve.generator((3,), "cpu")
    assert g.x.shape == (16, 3) and g.x.dtype == torch.int32
    assert _affine(g) == [oracle.GEN] * 3
    assert curve.generator((), "cpu").x.shape == (16,)
    rng = np.random.RandomState(73)
    pts = _points(rng, 4)
    px, py = interop.affine_points_to_limbs(pts + [None])
    x, y = _t(px), _t(py)
    assert curve.affine_on_curve(AffinePoint(x, y)).tolist() == [True] * 5
    y_off = field.add_mod(y, field.one_like(y))
    assert curve.affine_on_curve(AffinePoint(x, y_off)).tolist()[:4] == [
        oracle.is_on_curve((p[0], (p[1] + 1) % P)) for p in pts]
    assert not any(curve.affine_on_curve(AffinePoint(x, y_off)).tolist()[:4])


# --------------------------------------------------------------------------
# bindings/native.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 300])
def test_msm_jacobian_limbs_matches_jax_binding(n):
    rng = np.random.RandomState(74 + n)
    px, py = interop.affine_points_to_limbs(_points(rng, n))
    sl = _limbs(_rand(rng, n, bn254.FR))
    got = native.msm_jacobian_limbs(px, py, sl)
    want = jnative.msm_jacobian_limbs(px, py, sl)
    assert got.shape == (48,) and got.dtype == np.uint32
    assert got.tobytes() == want.tobytes()
    [pt] = interop.jac_limbs_to_affine_points(
        got[:16, None], got[16:32, None], got[32:, None])
    assert pt == native.msm(px, py, sl)
