"""The point-major table of packed words (`cuda_curve.pack_rows`,
csrc/layout.cu) that the fused route's scan reads.

On the CPU, `pack_rows_plain` against the packing worked out in numpy
(word j of a coordinate is limb 2j in its low half and limb 2j + 1 in its
high half, as a u32 bit pattern) and against `pippenger.pack_u16_rows`,
with limbs drawn from a seed and columns of all-0 and all-0xFFFF limbs
(a word with its sign bit set); the wrapper's dispatch and checks.

Tests marked `cuda` launch the kernel at the shapes the main path gives it
and at ragged ones, bit for bit against the plain version, and hold
`msm_device` to the benchmark's reference (`msmbench/reference.py`); they
skip without a card:
    python -m pytest --noconftest -m cuda tests/test_torch_pack_rows.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.ops import cuda_curve as cc  # noqa: E402
from tpu_msm_torch.ops import pippenger  # noqa: E402

SEED = 21


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coords(k, n, seed=SEED):
    """k (16, n) int32 arrays of u16 limbs; column 1 all 0, column 2 all
    0xFFFF."""
    rng = np.random.RandomState(seed + k + n)
    limbs = rng.randint(0, 1 << 16, size=(k, 16, n)).astype(np.int32)
    limbs[:, :, 1 % n] = 0
    limbs[:, :, 2 % n] = 0xFFFF
    return [torch.from_numpy(a) for a in limbs]


def _numpy_table(coords, n_pad):
    """The table worked out in numpy, as u32 words viewed as int32."""
    n = coords[0].shape[1]
    table = np.zeros((n_pad, 8 * len(coords)), dtype=np.uint32)
    for c, a in enumerate(coords):
        u = a.numpy().astype(np.uint32)
        table[:n, 8 * c:8 * c + 8] = (u[0::2] | (u[1::2] << 16)).T
    return table.view(np.int32)


def _args(coords, n_pad):
    return (coords[0], coords[1], coords[2] if len(coords) == 3 else None,
            n_pad)


@pytest.mark.parametrize("k", [2, 3])
def test_pack_rows_plain_is_the_packed_words(k):
    """rows[:n] = cat(pack_u16_rows(a) for a in coords).t(), rows[n:] = 0,
    at n = 1000 padded to 1024; the 0xFFFF column's words are -1."""
    coords = _coords(k, 1000)
    rows = cc.pack_rows_plain(*_args(coords, 1024))
    assert rows.shape == (1024, 8 * k) and rows.dtype == torch.int32
    assert rows.is_contiguous()
    want = torch.cat([pippenger.pack_u16_rows(a) for a in coords]).t()
    assert torch.equal(rows[:1000], want)
    assert not rows[1000:].any()
    assert np.array_equal(rows.numpy(), _numpy_table(coords, 1024))
    assert not rows[1].any() and (rows[2] == -1).all()


def test_pack_rows_on_the_cpu_runs_the_plain_version_once():
    coords = _coords(2, 40)
    calls, launches = cc.pack_rows_plain.calls, cc.pack_rows.launches
    rows = cc.pack_rows(*_args(coords, 64))
    assert cc.pack_rows_plain.calls == calls + 1
    assert cc.pack_rows.launches == launches
    assert np.array_equal(rows.numpy(), _numpy_table(coords, 64))


def test_pack_rows_takes_strided_coordinates():
    """Coordinates that are column slices of wider arrays, as a shard's
    are, give the table of their contiguous copies."""
    wide = _coords(3, 96)
    coords = [a[:, 10:60] for a in wide]
    assert not coords[0].is_contiguous()
    rows = cc.pack_rows(*_args(coords, 64))
    assert torch.equal(rows, cc.pack_rows_plain(
        *_args([a.contiguous() for a in coords], 64)))


def test_pack_rows_checks_its_operands():
    x, y, z = _coords(3, 20)
    bad = {"rows": (x[:15], y, None, 32),
           "shapes differ": (x, y[:, :10], None, 32),
           "y_neg shape": (x, y, z[:, :10], 32),
           "dtype": (x.to(torch.int64), y, None, 32),
           "y_neg dtype": (x, y, z.to(torch.int64), 32),
           "n_pad below n": (x, y, None, 19)}
    for args in bad.values():
        with pytest.raises(ValueError, match="pack_rows"):
            cc.pack_rows(*args)


# --------------------------------------------------------------------------
# The kernel on the card.
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k,n,n_pad", [
    (2, 1 << 20, 1 << 20),           # the 2^20 call's table
    (2, 1 << 22, 1 << 22),           # a streamed 2^24 call's chunk
    (3, 4096 + 37, 5120),            # signed digits, padded to 1024 lanes
    (2, 777, 900),                   # a ragged last tile of points
    (3, 1, 1)])
def test_pack_rows_kernel_matches_plain(cuda, k, n, n_pad):
    coords = _coords(k, n)
    dev_args = _args([a.to(cuda) for a in coords], n_pad)
    launches = cc.pack_rows.launches
    got = cc.pack_rows(*dev_args)
    torch.cuda.synchronize()
    assert cc.pack_rows.launches == launches + 1
    want = cc.pack_rows_plain(*dev_args)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [12, 16])
def test_msm_device_matches_the_reference(cuda, log_n):
    """msm_device on the benchmark's uniform traffic, against the sum that
    the reference works out from the bases' discrete logs."""
    import tpu_msm_torch
    from msmbench import reference
    from msmbench.traffic import Mix, Workload
    from tpu_msm_torch.utils import interop

    n = 1 << log_n
    work = Workload(Mix(scalar_sets=1, distinct_bases=4096,
                        top_limb_below=12388), n, (1 << 40) + log_n, cuda)
    px, py = work.bases()
    s = work.scalars(0)
    launches = cc.pack_rows.launches
    res = tpu_msm_torch.msm_device(px, py, s,
                                   tpu_msm_torch.select_config(n, cuda))
    assert cc.pack_rows.launches == launches + 1
    [got] = interop.proj_limbs_to_affine_points(
        *(interop.tensor_to_limbs(a) for a in res))
    want = reference.expected(*reference.limb_sums(s, work.index()),
                              work.step_log)
    assert got == want
