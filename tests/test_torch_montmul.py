"""The chained Montgomery-multiply microbench (`montmul_chain`) on the CPU
(plain version) against the JAX package's kernel body and Python ints, and
its CUDA kernel against the plain version on the card.

The Pallas kernel of `benches/montmul_benchmark.py` does not finish in
interpret mode at any useful size, so its body is run eagerly here, as
tests/test_kernel_rows_eager.py runs row functions: `pallas_curve.mont_mul`
under `jax.disable_jit()`, chained with the same limb rotations and XOR
fold (`montmul_benchmark.py:64-74`), at 128 lanes and at most 8 products.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import cuda_curve, field  # noqa: E402
from tpu_msm_torch.utils import interop  # noqa: E402

P, R = bn254.P, bn254.R
LANES = 128


def _inputs(lanes=LANES, seed=11):
    """The microbench's inputs: RandomState(11), values below P."""
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(lanes)]
    return interop.ints_to_limbs(vals)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _jax_body(x, chain, steps, ilp):
    """The TPU kernel's u16 body, eagerly: acc starts as x, then `steps`
    grid steps of `chain` products per chain."""
    import jax
    import jax.numpy as jnp

    from tpu_msm.ops import pallas_curve as pc

    with jax.disable_jit():
        xin = [jnp.asarray(x[i]) for i in range(16)]
        acc = list(xin)
        for _ in range(steps):
            if ilp > 1:
                chains = [acc[k:] + acc[:k] for k in range(ilp)]
                for _ in range(chain):
                    chains = [pc.mont_mul(c, xin) for c in chains]
                folded = chains[0]
                for c in chains[1:]:
                    folded = [a ^ b for a, b in zip(folded, c)]
                acc = [a & np.uint32(0xFFFF) for a in folded]
            else:
                for _ in range(chain):
                    acc = pc.mont_mul(acc, xin)
        return np.stack([np.asarray(a) for a in acc])


@pytest.mark.parametrize("chain,steps,ilp", [(3, 2, 1), (2, 2, 2)])
def test_plain_matches_jax_body(chain, steps, ilp):
    x = _inputs()
    want = _jax_body(x, chain, steps, ilp)
    got = cuda_curve.montmul_chain_plain(_t(x), _t(x), chain, steps, ilp)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_plain_matches_python_ints():
    x = _inputs(64, seed=12)
    a = _inputs(64, seed=13)
    chain, steps = 5, 3
    got = cuda_curve.montmul_chain_plain(_t(a), _t(x), chain, steps)
    r_inv = pow(R, -1, P)
    k = chain * steps
    want = [ai * pow(xi * r_inv, k, P) % P
            for ai, xi in zip(interop.limbs_to_ints(a),
                              interop.limbs_to_ints(x))]
    assert interop.limbs_to_ints(got.numpy().view(np.uint32)) == want


def test_mont_mul_is_canonical_for_a_above_p():
    """The XOR fold feeds the core accumulators >= P; a·b·2^-256 mod P
    still comes out canonical for a < 2^256 and b < P."""
    rng = np.random.RandomState(14)
    a = [P + int.from_bytes(rng.bytes(32), "little") % (R - P)
         for _ in range(63)] + [R - 1]
    b = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(63)] \
        + [P - 1]
    got = field.mont_mul(_t(interop.ints_to_limbs(a)),
                         _t(interop.ints_to_limbs(b)))
    r_inv = pow(R, -1, P)
    assert interop.limbs_to_ints(got.numpy().view(np.uint32)) == \
        [ai * bi * r_inv % P for ai, bi in zip(a, b)]


def test_rotation_is_on_u16_limbs():
    """Chain k starts from limb (i + k) mod 16 at limb i, which for odd k
    is no rotation of the u32 words."""
    a = _t(interop.ints_to_limbs([sum(i << (16 * i) for i in range(16))]))
    one = _t(interop.ints_to_limbs([R % P]))  # Montgomery one: x·1 = x
    got = cuda_curve.montmul_chain_plain(a, one, 0, 1, ilp=2)
    rolled = [(i + 1) % 16 for i in range(16)]
    assert got[:, 0].tolist() == [i ^ r for i, r in zip(range(16), rolled)]


def test_wrapper_runs_plain_on_cpu_and_checks_arguments():
    x = _t(_inputs(8))
    before = (cuda_curve.montmul_chain_plain.calls,
              cuda_curve.montmul_chain.launches)
    cuda_curve.montmul_chain(x, x, 1, 1)
    assert (cuda_curve.montmul_chain_plain.calls,
            cuda_curve.montmul_chain.launches) == (before[0] + 1, before[1])
    for bad in (dict(ilp=0), dict(ilp=9), dict(chain=-1)):
        kw = {"chain": 1, "steps": 1, "ilp": 1, **bad}
        with pytest.raises(ValueError):
            cuda_curve.montmul_chain(x, x, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ilp", range(1, 9))
def test_montmul_kernel_matches_plain(cuda, ilp):
    """Bit for bit at every ilp, with starting accumulators >= P (as the XOR
    fold makes them), 0, P - 1 and 2^256 - 1 among the lanes."""
    x = _t(_inputs(1000)).to(cuda)
    a = x.clone()
    a[15, :100] = 0xFFFF  # a >= P on the first 100 lanes
    for lanes, v in ((slice(100, 110), 0), (slice(110, 120), P - 1),
                     (slice(120, 130), R - 1)):
        a[:, lanes] = _t(interop.ints_to_limbs([v]))[:, :1].to(cuda)
    got = cuda_curve.montmul_chain(a, x, 3, 2, ilp)
    want = cuda_curve.montmul_chain_plain(a, x, 3, 2, ilp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
