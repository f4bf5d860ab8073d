"""The port's sharded MSM (tpu_msm_torch.parallel.sharded) on the CPU.

D shards on `devices=["cpu"] * D`, each running the plain kernel versions,
against the port's single-device `msm_projective` (proj_eq), the oracle
(affine), and the JAX package: its `_tree_reduce_last` bit for bit on the
same (16, W, D) points, and its `msm_sharded` on a 2-device virtual CPU
mesh (the configuration of tests/test_sharded.py: c = 8, 8 scan lanes, 16
points). Scalars are short (scalar_bits 8 or 16): the plain EC ops cost
about 20 ms a call on a CPU whatever their width, so the window count sets the
time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_msm.ops import curve as jcurve  # noqa: E402
from tpu_msm.parallel import sharded as jsharded  # noqa: E402
from tpu_msm_torch.bindings import native  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import pippenger  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint, ProjPoint, proj_eq  # noqa: E402
from tpu_msm_torch.parallel import collectives, sharded  # noqa: E402
from tpu_msm_torch.utils import interop, oracle  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402

P, R = bn254.P, bn254.R


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _inputs(seed, n, bits):
    """n points k·G (k random), scalars below 2^bits; one point is the
    (0, 0) infinity and one scalar 0."""
    rng = np.random.RandomState(seed)
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=n)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    px[:, 3] = py[:, 3] = 0
    scalars = [int(s) for s in rng.randint(0, 1 << bits, size=n)]
    scalars[5] = 0
    points = interop.limbs_to_affine_points(px, py)
    return px, py, interop.ints_to_limbs(scalars), oracle.msm(scalars, points)


def _affine(res):
    [pt] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    return pt


# --------------------------------------------------------------------------
# The fixed balanced tree, bit for bit against the JAX package's.
# --------------------------------------------------------------------------

def _proj_columns(rng, w, d):
    """(16, W, D) Montgomery projective points, a random scale each, with
    an infinity, a column equal to the next (a doubling) and a column the
    negative of the first (a cancellation)."""
    ks = [int(k) for k in rng.randint(1, 1 << 30, size=w * d)]
    px, py = native.ec_mul_batch(oracle.GEN, interop.ints_to_limbs(ks))
    pts = interop.limbs_to_affine_points(px, py)
    grid = [pts[i * d:(i + 1) * d] for i in range(w)]  # [window][column]
    grid[0][0] = None
    if d > 1:
        grid[1][1] = grid[1][0]
        grid[2][d - 1] = (grid[2][0][0], P - grid[2][0][1])
    cols = {c: [] for c in "xyz"}
    for row in grid:
        for pt in row:
            lam = int(rng.randint(1, 1 << 62)) * R % P
            x, y, z = (0, lam, 0) if pt is None else (
                pt[0] * lam % P, pt[1] * lam % P, lam)
            for c, v in zip("xyz", (x, y, z)):
                cols[c].append(v)
    limbs = [interop.ints_to_limbs(cols[c]).reshape(16, w, d) for c in "xyz"]
    return limbs, grid


@pytest.mark.parametrize("d", [2, 3, 5])
def test_tree_reduce_last_matches_jax(d):
    limbs, grid = _proj_columns(np.random.RandomState(40 + d), 4, d)
    got = sharded._tree_reduce_last(ProjPoint(*(_t(a) for a in limbs)))
    want = jsharded._tree_reduce_last(
        jcurve.ProjPoint(*(jnp.asarray(a) for a in limbs)))
    assert got.x.shape == (16, 4, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.tensor_to_limbs(g),
                                      np.asarray(w))
    flat = [interop.tensor_to_limbs(a.reshape(16, 4)) for a in got]
    sums = []
    for row in grid:
        acc = None
        for pt in row:
            acc = oracle.ec_add(acc, pt)
        sums.append(acc)
    assert interop.proj_limbs_to_affine_points(*flat) == sums


# --------------------------------------------------------------------------
# msm_sharded on D CPU shards.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,signed", [(2, True), (3, False), (4, True),
                                      (4, False)])
def test_msm_sharded_matches_single_device_and_oracle(d, signed):
    px, py, sl, want = _inputs(10 + d, 12 * d, 8)
    cfg = MsmConfig(window_bits=4, scan_lanes=8, scalar_bits=8,
                    signed_digits=signed)
    dev = torch.device("cpu")
    ref = pippenger.msm_projective(
        AffinePoint(_t(px), _t(py)), _t(sl), cfg)
    results = {}
    for collective in sharded.COLLECTIVES:
        res = sharded.msm_sharded((px, py), sl, devices=[dev] * d, cfg=cfg,
                                  collective=collective)
        assert res.x.shape == (16, 1) and res.x.device == dev
        assert bool(proj_eq(res, ref).all()), collective
        assert _affine(res) == want, collective
        results[collective] = res
    if d < 4:  # one association for D <= 3: the same bytes either way
        for a, b in zip(*results.values()):
            assert torch.equal(a, b)


def test_msm_sharded_pads_to_a_multiple_of_the_shards():
    """13 points on 4 shards: padded with three zero scalars on (0, 0)."""
    px, py, sl, want = _inputs(7, 13, 8)
    cfg = MsmConfig(window_bits=4, scan_lanes=8, scalar_bits=8)
    res = sharded.msm_sharded((_t(px), _t(py)), _t(sl), devices=["cpu"] * 4,
                              cfg=cfg)
    assert _affine(res) == want


@pytest.fixture
def _no_persistent_cache():
    """As tests/test_sharded.py: XLA:CPU's compile cache crashes when it
    serializes multi-device shard_map executables, so compile fresh."""
    from jax._src import compilation_cache as cc

    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


def test_msm_sharded_matches_jax_package(_no_persistent_cache):
    """D = 2 against `tpu_msm.parallel.sharded.msm_sharded` on a 2-device
    virtual CPU mesh, c = 8, 8 scan lanes, 16 points, 16-bit scalars."""
    from tpu_msm.ops.curve import AffinePoint as JAffine

    devs = jax.devices("cpu")
    if len(devs) < 2:
        pytest.skip("needs 2 virtual CPU devices")
    px, py, sl, want = _inputs(3, 16, 16)
    cfg = MsmConfig(window_bits=8, scan_lanes=8, scalar_bits=16)
    got = sharded.msm_sharded((px, py), sl, devices=["cpu", "cpu"], cfg=cfg)

    from tpu_msm.utils.config import MsmConfig as JConfig

    jcfg = JConfig(window_bits=8, scan_lanes=8, scalar_bits=16)
    with jax.default_device(devs[0]):
        ref = jsharded.msm_sharded(
            JAffine(jnp.asarray(px), jnp.asarray(py)), jnp.asarray(sl),
            mesh=jsharded.default_mesh(devs[:2]), cfg=jcfg)
        ref = [np.asarray(a) for a in ref]
    [jax_pt] = interop.proj_limbs_to_affine_points(*ref)
    assert _affine(got) == jax_pt == want


# --------------------------------------------------------------------------
# Arguments.
# --------------------------------------------------------------------------

def test_ec_all_reduce_needs_limbs_first_arrays():
    """(W, 16, 1) window sums with W != 16 are refused before any message
    is sent (no process group is needed to see it)."""
    wsums = ProjPoint(*(torch.zeros((4, 16, 1), dtype=torch.int32)
                        for _ in range(3)))
    with pytest.raises(ValueError, match="limbs-first"):
        collectives.ec_all_reduce(wsums)
    with pytest.raises(ValueError, match="window"):
        collectives.ec_all_gather_tree(sharded._transpose(wsums))


def test_binomial_levels_are_the_jax_rounds():
    """The (receiver, sender) pairs of each round, as the JAX collective's
    ppermute pairs (s - stride <- s for s = stride, 3·stride, ...)."""
    for d in range(1, 10):
        want, stride = [], 1
        while stride < d:
            want.append([(s - stride, s)
                         for s in range(stride, d, 2 * stride)])
            stride *= 2
        assert sharded.binomial_levels(d) == want


def test_shard_tensors_and_arguments():
    a = np.arange(16 * 12, dtype=np.uint32).reshape(16, 12)
    [shards] = sharded.shard_tensors(["cpu"] * 3, a)
    assert [s.shape for s in shards] == [(16, 4)] * 3
    np.testing.assert_array_equal(
        np.concatenate([interop.tensor_to_limbs(s) for s in shards], axis=1),
        a)
    with pytest.raises(ValueError, match="multiple"):
        sharded.shard_tensors(["cpu"] * 5, a)
    with pytest.raises(ValueError, match="collective"):
        sharded.make_sharded_msm(["cpu"], MsmConfig(), collective="psum")
    with pytest.raises(ValueError, match="empty"):
        sharded.make_sharded_msm([], MsmConfig())


def test_default_devices_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        sharded.default_devices()
    px, py, sl, _ = _inputs(1, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sharded.msm_sharded((px, py), sl)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sharded.msm_sharded((px, py), sl, devices=["cuda:0"])
