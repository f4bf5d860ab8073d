"""The port's plain field and curve ops (tpu_msm_torch.ops.field / curve)
against the pure-Python oracle and the JAX package's kernel row functions.

The RCB formulas run on canonical field values, so the same formula
sequence must give BIT-IDENTICAL projective coordinates in the port's plain
torch field and in the JAX u16 row core (`pallas_curve._proj_add_rows` /
`_proj_madd_rows`, evaluated eagerly under jax.disable_jit() as
tests/test_kernel_rows_eager.py does). 256 lanes with infinities, equal
points (doubling) and inverse points (cancellation).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_msm.ops import pallas_curve as pc  # noqa: E402
from tpu_msm.utils import oracle  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import curve, field  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402

P, R = bn254.P, bn254.R
R_INV = pow(R, -1, P)
LANES = 256


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _ints(t):
    return interop.limbs_to_ints(interop.tensor_to_limbs(t))


# --------------------------------------------------------------------------
# Field ops against Python ints.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def operands():
    rng = np.random.RandomState(31)
    edge = [0, 1, 2, P - 1, P - 2, (1 << 253), R % P, (P - 1) // 2]
    a = edge + edge[::-1] + [int.from_bytes(rng.bytes(32), "little") % P
                             for _ in range(200)]
    b = edge[::-1] + edge + [int.from_bytes(rng.bytes(32), "little") % P
                             for _ in range(200)]
    return a, b


@pytest.mark.parametrize("name,fn,ref", [
    ("mont_mul", field.mont_mul, lambda x, y: x * y * R_INV % P),
    ("add_mod", field.add_mod, lambda x, y: (x + y) % P),
    ("sub_mod", field.sub_mod, lambda x, y: (x - y) % P),
    ("neg_mod", lambda x, y: field.neg_mod(x), lambda x, y: (-x) % P),
    ("double_mod", lambda x, y: field.double_mod(x), lambda x, y: 2 * x % P),
    ("mul9", lambda x, y: field.mul9(x), lambda x, y: 9 * x % P),
])
def test_field_op_matches_oracle_ints(operands, name, fn, ref):
    a, b = operands
    for dtype in (torch.int32, torch.int64):
        got = fn(_t(interop.ints_to_limbs(a)).to(dtype),
                 _t(interop.ints_to_limbs(b)).to(dtype))
        assert got.dtype == dtype
        assert _ints(got.to(torch.int32)) == [ref(x, y) for x, y in zip(a, b)], name


def test_mont_mul_broadcasts_and_roundtrips(operands):
    """x·R (Montgomery form) times 1 returns x; a (16, 1) constant operand
    broadcasts over the batch."""
    a, _ = operands
    xm = _t(interop.ints_to_limbs([x * R % P for x in a]))
    one = _t(interop.ints_to_limbs([1]))
    assert _ints(field.mont_mul(xm, one)) == a
    assert _ints(field.one_mont((3,), "cpu")) == [R % P] * 3


# --------------------------------------------------------------------------
# Curve ops against the JAX row functions (bit-exact) and the oracle.
# --------------------------------------------------------------------------

def _points(rng, n):
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    return interop.limbs_to_affine_points(px, py)


@pytest.fixture(scope="module")
def edge_batch():
    """P projective with a random scale per lane; Q affine. Q == P on lanes
    [64, 128), Q == -P on [128, 192); infinities scattered in both."""
    rng = np.random.RandomState(32)
    p, q = _points(rng, LANES), _points(rng, LANES)
    for i in range(64, 128):
        q[i] = p[i]
    for i in range(128, 192):
        q[i] = (p[i][0], P - p[i][1])
    for i in range(0, LANES, 29):
        p[i] = None
        q[(i + 11) % LANES] = None
    xs, ys, zs = [], [], []
    for pt in p:
        lam = int(rng.randint(1, 1 << 62)) * R % P
        x, y, z = (0, lam, 0) if pt is None else (
            pt[0] * lam % P, pt[1] * lam % P, lam)
        xs.append(x)
        ys.append(y)
        zs.append(z)
    p3 = tuple(interop.ints_to_limbs(v) for v in (xs, ys, zs))
    q2 = interop.affine_points_to_limbs(q)
    return p, q, p3, q2


def _jax_rows(a):
    return [jnp.asarray(a[i]) for i in range(16)]


def _check_bits(got: ProjPoint, want_rows):
    for g, w in zip(got, want_rows):
        np.testing.assert_array_equal(
            interop.tensor_to_limbs(g), np.stack([np.asarray(r) for r in w]))


def _affine(pt: ProjPoint):
    return interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in pt))


def test_proj_add_matches_pallas_rows(edge_batch):
    p, q, p3, q2 = edge_batch
    qproj = curve.affine_to_proj(AffinePoint(_t(q2[0]), _t(q2[1])))
    got = curve.proj_add(ProjPoint(*(_t(a) for a in p3)), qproj)
    with jax.disable_jit():
        want = pc._proj_add_rows(*(_jax_rows(a) for a in p3),
                                 *(_jax_rows(interop.tensor_to_limbs(a))
                                   for a in qproj))
    _check_bits(got, want)
    assert _affine(got) == [oracle.ec_add(a, b) for a, b in zip(p, q)]


def test_proj_madd_matches_pallas_rows(edge_batch):
    p, q, p3, q2 = edge_batch
    got = curve.proj_madd(ProjPoint(*(_t(a) for a in p3)),
                          AffinePoint(_t(q2[0]), _t(q2[1])))
    with jax.disable_jit():
        want = pc._proj_madd_rows(*(_jax_rows(a) for a in p3),
                                  _jax_rows(q2[0]), _jax_rows(q2[1]))
    _check_bits(got, want)
    assert _affine(got) == [oracle.ec_add(a, b) for a, b in zip(p, q)]


def test_proj_double_neg_and_eq(edge_batch):
    p, _, p3, _ = edge_batch
    pp = ProjPoint(*(_t(a) for a in p3))
    dbl = curve.proj_double(pp)
    assert _affine(dbl) == [oracle.ec_add(a, a) for a in p]
    # P + (-P) is infinity on every lane; -(-P) == P projectively.
    assert bool(curve.proj_is_infinity(curve.proj_add(pp, curve.proj_neg(pp))).all())
    assert bool(curve.proj_eq(curve.proj_neg(curve.proj_neg(pp)), pp).all())
    finite = torch.tensor([pt is not None for pt in p])
    assert not bool(curve.proj_eq(dbl, pp)[finite].any())  # 2P != P


def test_select_and_affine_to_proj_sentinel():
    x, y = interop.affine_points_to_limbs([None, oracle.GEN])
    pt = curve.affine_to_proj(AffinePoint(_t(x), _t(y)))
    inf = curve.proj_infinity((2,), "cpu")
    assert bool(curve.proj_eq(pt, inf)[0]) and not bool(curve.proj_eq(pt, inf)[1])
    sel = curve.select_point(torch.tensor([False, True]), inf, pt)
    assert _affine(sel) == [None, None]


# --------------------------------------------------------------------------
# Jacobian ops against the JAX package's curve.py (bit-exact) and the
# Jacobian kernels' plain versions against them (by jac_eq).
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jac_case(edge_batch):
    """P and Q of the edge batch as Jacobian points, (xλ², yλ³, λ) with a
    random λ per lane (infinity (λ², λ³, 0)), Q also affine; the JAX ops'
    results on them."""
    from tpu_msm.ops import curve as jc

    p, q, _, q2 = edge_batch
    rng = np.random.RandomState(33)

    def jac(pts):
        xs, ys, zs = [], [], []
        for pt in pts:
            lam = int(rng.randint(1, 1 << 62))
            x, y = (1, 1) if pt is None else pt
            xs.append(x * lam ** 2 * R % P)
            ys.append(y * lam ** 3 * R % P)
            zs.append(0 if pt is None else lam * R % P)
        return tuple(interop.ints_to_limbs(v) for v in (xs, ys, zs))

    pj, qj = jac(p), jac(q)
    jp = jc.JacPoint(*(jnp.asarray(a) for a in pj))
    jq = jc.JacPoint(*(jnp.asarray(a) for a in qj))
    jq_aff = jc.AffinePoint(jnp.asarray(q2[0]), jnp.asarray(q2[1]))
    want = {
        "jac_add_affine": jc.jac_add_affine(jp, jq_aff),
        "jac_add": jc.jac_add(jp, jq),
        "jac_double": jc.jac_double(jp),
        "jac_neg": jc.jac_neg(jp),
        "affine_to_jac": jc.affine_to_jac(jq_aff),
        "jac_infinity": jc.jac_infinity((3,)),
    }
    want = {k: [np.array(a) for a in v] for k, v in want.items()}
    return p, q, pj, qj, q2, want


def _jac(a3):
    return curve.JacPoint(*(_t(a) for a in a3))


def _jac_affine(pt):
    """Jacobian Montgomery tensors -> oracle points: (X/Z², Y/Z³)."""
    out = []
    for x, y, z in zip(*(_ints(a) for a in pt)):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z * R_INV % P, P - 2, P)
        out.append((x * R_INV * zi * zi % P, y * R_INV * zi ** 3 % P))
    return out


def test_jacobian_ops_match_jax(jac_case):
    p, q, pj, qj, q2, want = jac_case
    qa = AffinePoint(_t(q2[0]), _t(q2[1]))
    got = {
        "jac_add_affine": curve.jac_add_affine(_jac(pj), qa),
        "jac_add": curve.jac_add(_jac(pj), _jac(qj)),
        "jac_double": curve.jac_double(_jac(pj)),
        "jac_neg": curve.jac_neg(_jac(pj)),
        "affine_to_jac": curve.affine_to_jac(qa),
        "jac_infinity": curve.jac_infinity((3,), "cpu"),
    }
    for name, pt in got.items():
        for g, w in zip(pt, want[name]):
            np.testing.assert_array_equal(interop.tensor_to_limbs(g), w,
                                          err_msg=name)
    # And the points are the oracle's.
    want_sums = [oracle.ec_add(a, b) for a, b in zip(p, q)]
    assert _jac_affine(got["jac_add"]) == want_sums
    assert _jac_affine(got["jac_add_affine"]) == want_sums
    assert _jac_affine(got["jac_double"]) == [oracle.ec_add(a, a) for a in p]


def test_jacobian_plain_kernels_agree_with_jax_by_jac_eq(jac_case):
    """jac_madd_plain / jac_add_plain (the Pallas row sequence) and the JAX
    curve-level adders give the same points, by jac_eq in both packages."""
    from tpu_msm.ops import curve as jc
    from tpu_msm_torch.ops import cuda_curve

    _, _, pj, qj, q2, want = jac_case
    got = {"jac_add_affine": cuda_curve.jac_madd_plain(
               *(_t(a) for a in (*pj, *q2))),
           "jac_add": cuda_curve.jac_add_plain(*(_t(a) for a in (*pj, *qj)))}
    for name, pt in got.items():
        ref = curve.JacPoint(*(_t(a) for a in want[name]))
        assert bool(curve.jac_eq(curve.JacPoint(*pt), ref).all()), name
        jeq = jax.jit(jc.jac_eq)(
            jc.JacPoint(*(jnp.asarray(interop.tensor_to_limbs(a)) for a in pt)),
            jc.JacPoint(*(jnp.asarray(a) for a in want[name])))
        assert bool(np.asarray(jeq).all()), name


def test_jac_eq_and_infinity():
    """jac_eq tells equal points under different scales apart from others;
    infinity only equals infinity."""
    x, y = interop.affine_points_to_limbs([oracle.GEN, oracle.GEN, None])
    a = curve.affine_to_jac(AffinePoint(_t(x), _t(y)))
    two = interop.ints_to_limbs([2 * R % P] * 3)
    four, eight = (interop.ints_to_limbs([k * R % P] * 3) for k in (4, 8))
    scaled = curve.JacPoint(field.mont_mul(a.x, _t(four)),
                            field.mont_mul(a.y, _t(eight)),
                            field.mont_mul(a.z, _t(two)))
    assert curve.jac_eq(a, scaled).tolist() == [True, True, True]
    dbl = curve.jac_double(a)
    assert curve.jac_eq(a, dbl).tolist() == [False, False, True]
    assert curve.jac_is_infinity(curve.jac_add(a, curve.jac_neg(a))).all()
