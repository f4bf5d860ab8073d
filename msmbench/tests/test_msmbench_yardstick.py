"""The yardstick: the reference, the traffic and the rooflines' counts,
against hand counts and direct sums at small sizes."""

import random

import pytest
import torch

from msmbench import reference, roofline
from msmbench.traffic import Mix, Workload

MIX = Mix.from_dict({"scalar_sets": 2, "distinct_bases": 16,
                     "top_limb_below": 12388})


def scalar_ints(limbs):
    return [sum(int(limbs[l, i]) << (16 * l) for l in range(16))
            for i in range(limbs.shape[1])]


def test_curve_arithmetic_against_known_values():
    two_g = reference.ec_add(reference.G, reference.G)
    assert reference.on_curve(two_g)
    assert reference.ec_mul(reference.G, 2) == two_g
    assert reference.ec_mul(reference.G, 3) == reference.ec_add(two_g, reference.G)
    assert reference.ec_mul(reference.G, reference.R) is None
    neg = (reference.G[0], reference.P - reference.G[1])
    assert reference.ec_add(reference.G, neg) is None


def test_montgomery_limbs_round_trip():
    values = [0, 1, reference.P - 1, 12345678901234567890]
    limbs = reference.to_mont_limbs(values)
    assert limbs.shape == (16, 4) and limbs.flags.c_contiguous
    assert [reference.from_mont_limbs(limbs[:, i]) for i in range(4)] == values


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_reference_msm_against_the_direct_sum(seed):
    """The discrete-log sum equals sum_i s_i·P_i taken point by point."""
    work = Workload(MIX, 12, seed, "cpu")
    px, py = work.bases()
    pts = [(reference.from_mont_limbs(px[:, i].tolist()),
            reference.from_mont_limbs(py[:, i].tolist())) for i in range(12)]
    index = work.index()
    for k in range(MIX.scalar_sets):
        s = work.scalars(k)
        direct = None
        for si, p in zip(scalar_ints(s), pts):
            direct = reference.ec_add(direct, reference.ec_mul(p, si))
        sums = reference.limb_sums(s, index)
        assert reference.expected(*sums, work.step_log) == direct
        low = [si % (1 << 240) for si in scalar_ints(s)]
        control = None
        for si, p in zip(low, pts):
            control = reference.ec_add(control, reference.ec_mul(p, si))
        assert reference.expected(*sums, work.step_log, limbs=15) == control
        assert control != direct


def test_traffic_is_determined_by_the_seed():
    a, b = Workload(MIX, 64, 2**40 + 1, "cpu"), Workload(MIX, 64, 2**40 + 1, "cpu")
    c = Workload(MIX, 64, 2**40 + 2, "cpu")
    for x, y in zip(a.bases(), b.bases()):
        assert torch.equal(x, y)
    assert torch.equal(a.scalars(1), b.scalars(1))
    assert not torch.equal(a.scalars(1), c.scalars(1))
    assert not torch.equal(a.scalars(0), a.scalars(1))
    assert a.step_log != c.step_log


def test_scalars_lie_below_r_and_the_bases_on_the_curve():
    work = Workload(MIX, 256, 3, "cpu")
    s = work.scalars(0)
    assert s.dtype == torch.int32 and s.shape == (16, 256)
    assert all(0 <= v < reference.R for v in scalar_ints(s))
    assert int(s.min()) >= 0 and int(s.max()) < 1 << 16
    walk = work.walk()
    assert len(set(walk)) == 16 and all(map(reference.on_curve, walk))
    with pytest.raises(ValueError):  # a top limb of 0x3065 reaches past r
        Mix.from_dict({"scalar_sets": 1, "distinct_bases": 16,
                       "top_limb_below": 12389})


def test_the_index_has_no_period():
    """No shift p < n/2 maps the tiled table onto itself, so an offset bug
    in a gather reads other points."""
    idx = Workload(Mix.from_dict({"scalar_sets": 1, "distinct_bases": 4096,
                                  "top_limb_below": 12388}),
                   1 << 14, 11, "cpu").index()
    n = idx.numel()
    assert int(idx.min()) >= 0 and int(idx.max()) < 4096
    for p in range(1, n // 2):
        assert not torch.equal(idx[p:], idx[:-p]), p


def test_product_and_addition_counts():
    # 8 rows of the 8-word CIOS product: 8 a·b[i] and 8 m·p word products,
    # two halves each, and the low product m = t0·p'.
    assert roofline.MULS_PER_PRODUCT == 8 * (8 * 2 + 8 * 2 + 1) == 264
    assert roofline.windows(254, 16) == 16 and roofline.windows(254, 13) == 20
    assert roofline.mul_rate() == 132 * 64 * 1.98e9


@pytest.mark.parametrize("c", [16, 13, 8, 5])
def test_nonzero_digits_against_a_hand_count(c):
    rng = random.Random(c)
    ints = [rng.randrange(reference.R) for _ in range(50)] + [0, 1, 1 << 253]
    limbs = torch.tensor([[(v >> (16 * l)) & 0xFFFF for v in ints]
                          for l in range(16)], dtype=torch.int32)
    want = sum(1 for v in ints for w in range(roofline.windows(254, c))
               if (v >> (w * c)) & ((1 << c) - 1))
    assert roofline.nonzero_digits(limbs, c, 254) == want


def test_least_times_by_hand():
    n, d = 1 << 10, 16 << 10
    ops = d * 11 * 264 / (132 * 64 * 1.98e9)
    moved = (n * 96 + 16 * 65535 * 96) / 3.35e12
    assert roofline.accumulation_s(d, n, 254, 16) == pytest.approx(max(ops, moved))
    assert roofline.sort_s(n, 254, 16) == pytest.approx(16 * n * 8 / 3.35e12)
