"""The sort stage's digit sort (`ops/sort.py`, csrc/radix_sort.cu): on the CPU
its plain version against the JAX package's sort, on the card the kernel
against its plain version.

On the CPU, `digit_sort_plain` (torch.sort(stable=True), indices cast to
int32) and the wrapper `digit_sort` must equal
`jax.lax.sort_key_val(digits, arange(n))`, the JAX pipeline's sort
(`tpu_msm/ops/pippenger.py:291`, `:514`), window by window, exactly: the
sorted digits and the int32 permutation. The digits are drawn with numpy
from a seed: c = 16 unsigned (17 bits with the sentinel m + 1 = 65536 on
the padding), c = 16 signed (16 bits: at most 32769), c = 8 (9 bits, one
pass), and all equal (which tests stability); windows G in {1, 3}.

Tests marked `cuda` run the kernel against its plain version, bit for bit
(a stable sort's permutation is unique): G in {1, 3, 16}, key_bits in
{9, 16, 17, 18}, n not a multiple of the kernel's 4096-key tile, all keys
equal, all keys the sentinel, with and without the sorted keys. They skip
without a card. jax is imported inside a fixture only, so they also run
where jax is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_digit_sort.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.ops import sort  # noqa: E402

SEED = 17


@pytest.fixture(scope="module")
def jax_sort():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    def sort_key_val(digits):
        idx0 = jnp.arange(digits.shape[0], dtype=jnp.int32)
        keys, idx = jax.lax.sort_key_val(jnp.asarray(digits), idx0)
        return np.asarray(keys), np.asarray(idx)

    return sort_key_val


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _digits(seed, g, n, m, pad=0, equal=False):
    """(G, n) int64 digits in [0, m] (all 7 where `equal`), the sentinel
    m + 1 on the last `pad` positions, as `pippenger._digits` pads them."""
    rng = np.random.RandomState(seed)
    digits = (np.full((g, n), 7) if equal
              else rng.randint(0, m + 1, size=(g, n)))
    if pad:
        digits[:, n - pad:] = m + 1
    return digits


# (name, G, n, m, pad, equal): m is the window's bucket count, so the keys
# take sort.key_bits(m) bits.
CPU_CASES = [
    ("unsigned c=16, sentinel", 3, 5000, 65535, 700, False),
    ("signed c=16", 1, 4096, 32768, 0, False),
    ("c=8", 3, 3000, 255, 100, False),
    ("all equal", 3, 2048, 65535, 0, True),
    ("signed c=16, sentinel", 3, 4100, 32768, 4, False),
]


@pytest.mark.parametrize("name,g,n,m,pad,equal", CPU_CASES,
                         ids=[c[0] for c in CPU_CASES])
def test_plain_matches_jax(jax_sort, name, g, n, m, pad, equal):
    digits = _digits(SEED + n, g, n, m, pad, equal)
    bits = sort.key_bits(m)
    assert bits == {65535: 17, 32768: 16, 255: 9}[m]
    d = torch.from_numpy(digits.astype(np.int32))
    calls = sort.digit_sort_plain.calls
    keys, perm = sort.digit_sort_plain(d, bits, want_keys=True)
    wkeys, wperm = sort.digit_sort(d, bits, want_keys=True)
    assert sort.digit_sort_plain.calls == calls + 2  # the CPU runs the plain
    assert perm.dtype == wperm.dtype == torch.int32
    assert keys.shape == perm.shape == (g, n)
    for w in range(g):
        jk, ji = jax_sort(digits[w].astype(np.uint32))
        assert np.array_equal(keys[w].numpy().astype(np.uint32), jk)
        assert np.array_equal(perm[w].numpy(), ji)
    assert torch.equal(wkeys, keys) and torch.equal(wperm, perm)


def test_one_row_and_no_keys():
    """A (n,) row sorts as a (1, n) group; without want_keys the sorted
    keys are None."""
    d = torch.from_numpy(_digits(SEED, 1, 777, 255, 7)[0].astype(np.int32))
    keys, perm = sort.digit_sort(d, 9)
    assert keys is None and perm.shape == (777,)
    want = torch.sort(d, stable=True)[1].to(torch.int32)
    assert torch.equal(perm, want)
    keys, perm = sort.digit_sort(d, 9, want_keys=True)
    assert torch.equal(keys, d[want.long()])


def test_key_bits():
    """Every window width's digits and sentinel fit the sort's 18 bits."""
    assert sort.key_bits((1 << 17) - 1) == sort.MAX_KEY_BITS == 18
    assert sort.key_bits(1) == 2


def test_digit_sort_checks_its_operands():
    d = torch.zeros((2, 8), dtype=torch.int32)
    for args in ((d.to(torch.int64), 9), (d[None], 9), (d, 0), (d, 19)):
        with pytest.raises(ValueError, match="digit_sort"):
            sort.digit_sort(*args)


def test_group_bytes_count_the_sort_scratch():
    """Between its passes the sort keeps two int32 a key, freed before the
    scan's 48 output rows exist: the group's peak counts the larger."""
    from tpu_msm_torch.ops import pippenger

    assert sort.SCRATCH_BYTES_PER_KEY == 8
    assert pippenger.GROUP_BYTES_PER_POINT == 4 + 4 + 4 * 48


# --------------------------------------------------------------------------
# The kernel on the card.
# --------------------------------------------------------------------------

def _check_kernel(dev, digits, bits, want_keys):
    d = torch.from_numpy(digits.astype(np.int32)).to(dev)
    launches = sort.digit_sort.launches
    keys, perm = sort.digit_sort(d, bits, want_keys=want_keys)
    torch.cuda.synchronize()
    assert sort.digit_sort.launches == launches + 1
    wkeys, wperm = sort.digit_sort_plain(d, bits, want_keys=want_keys)
    assert perm.dtype == torch.int32 and torch.equal(perm, wperm)
    if want_keys:
        assert torch.equal(keys, wkeys)
    else:
        assert keys is None


# (G, n, bits, pad, equal): n a multiple of the 4096-key tile and not.
CUDA_CASES = [(1, 4096, 9, 0, False), (3, 5000, 16, 100, False),
              (16, 8192, 17, 0, False), (3, 4097, 17, 1, False),
              (1, 1 << 16, 18, 999, False), (3, 12345, 17, 0, True),
              (16, 1000, 9, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,bits,pad,equal", CUDA_CASES)
@pytest.mark.parametrize("want_keys", [False, True])
def test_digit_sort_kernel_matches_plain(cuda, g, n, bits, pad, equal,
                                         want_keys):
    m = (1 << bits) - 2  # the sentinel m + 1 takes the top key
    _check_kernel(cuda, _digits(SEED + g + n, g, n, m, pad, equal), bits,
                  want_keys)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [9, 17])
def test_digit_sort_kernel_all_sentinel(cuda, bits):
    m = (1 << bits) - 2
    digits = np.full((3, 9000), m + 1)
    _check_kernel(cuda, digits, bits, True)


@pytest.mark.cuda
def test_digit_sort_kernel_repeats_bit_for_bit(cuda):
    """The same bits on every run: no atomic decides a position."""
    d = torch.from_numpy(_digits(SEED, 16, 1 << 16, 65535, 321).astype(
        np.int32)).to(cuda)
    first = sort.digit_sort(d, 17, want_keys=True)
    for _ in range(3):
        again = sort.digit_sort(d, 17, want_keys=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
