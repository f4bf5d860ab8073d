"""The port's roofline and benchmark entry points on the CPU: the
mont-mul count of the pipeline against a tally of what the pipeline runs,
the H100 model, and the refusal of every measurement without a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_msm_torch.benches import ab_benchmark, montmul_benchmark  # noqa: E402
from tpu_msm_torch.bindings import benchmarks  # noqa: E402
from tpu_msm_torch.models import bn254  # noqa: E402
from tpu_msm_torch.ops import cuda_curve, field, pippenger  # noqa: E402
from tpu_msm_torch.ops.curve import AffinePoint  # noqa: E402
from tpu_msm_torch.utils import interop, profiling  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig  # noqa: E402


@pytest.fixture
def tally(monkeypatch):
    """Counts the Montgomery products of every EC call by its width:
    11 a mixed add (scan, pmadd), 12 an add (padd, fold_add), 1 a constant
    product; the calls return zeros of the right shape, since only the
    widths matter here."""
    count = [0]

    def plain(muls, out):
        def fn(*ops):
            count[0] += muls(*ops)
            return out(*ops)
        return fn

    def three(*ops):
        return tuple(torch.zeros_like(ops[0]) for _ in range(3))

    # The scan takes (8, steps, lanes) or (G, 8, steps, lanes).
    monkeypatch.setattr(cuda_curve, "scan_madd_plain", plain(
        lambda gx, gy: 11 * gx.numel() // 8,
        lambda gx, gy: torch.zeros(gx.shape[:-3] + (48,) + gx.shape[-2:],
                                   dtype=torch.int32)))
    monkeypatch.setattr(cuda_curve, "pmadd_plain", plain(
        lambda *o: 11 * o[0].shape[1], three))
    monkeypatch.setattr(cuda_curve, "padd_plain", plain(
        lambda *o: 12 * o[0].shape[1], three))
    monkeypatch.setattr(cuda_curve, "fold_add_plain", plain(
        lambda bx, by, bz: 12 * bx.shape[1] * bx.shape[2],
        lambda bx, by, bz: tuple(torch.zeros_like(bx[:, 0])
                                 for _ in range(3))))
    monkeypatch.setattr(field, "mont_mul_const", plain(
        lambda a, c: a.shape[1], lambda a, c: torch.zeros_like(a)))
    return count


@pytest.mark.parametrize("route", ["per_window", "fused"])
@pytest.mark.parametrize("knobs", [
    dict(window_bits=8, signed_digits=True),
    dict(window_bits=8, signed_digits=True, glv=True),
    dict(window_bits=8, signed_digits=False, reduce_fanout=32),
    dict(window_bits=16, signed_digits=True, glv=True, reduce_fanout=4096),
], ids=["c8", "c8_glv", "c8_unsigned_fold", "c16_glv"])
def test_pipeline_mont_muls_matches_tally(tally, monkeypatch, route, knobs):
    monkeypatch.setattr(pippenger, "fused_route",
                        lambda lanes: route == "fused")
    n = 40  # no multiple of the 16 lanes
    rng = np.random.RandomState(71)
    sl = interop.ints_to_limbs([int.from_bytes(rng.bytes(32), "little")
                                % bn254.FR for _ in range(n)])
    zeros = torch.zeros((16, n), dtype=torch.int32)
    cfg = MsmConfig(scan_lanes=16, **{"reduce_fanout": 64, **knobs})
    sl = torch.from_numpy(sl.view(np.int32))
    pippenger.msm_projective(AffinePoint(zeros, zeros), sl, cfg)
    assert tally[0] == profiling.pipeline_mont_muls(n, cfg)


def test_model_constants():
    assert profiling.CIOS_MULS_PER_MONT_MUL == 264
    assert profiling.IMAD_PER_CLOCK_PER_SM == 64


def test_model_bound_at_132_sms_and_1980_mhz(monkeypatch):
    monkeypatch.setattr(profiling, "sm_count", lambda device=None: 132)
    monkeypatch.setattr(profiling, "sm_clock_hz", lambda: 1980e6)
    assert profiling.mont_mul_bound_per_s() == pytest.approx(
        64 * 132 * 1980e6 / 264)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: profiling.roofline(10),
    lambda: profiling.profile_stages(10),
    lambda: profiling.time_fn(lambda: None),
    lambda: profiling.sm_clock_hz(),
    lambda: benchmarks.benchmark_gpu_msm_best(10),
    lambda: montmul_benchmark.run(lanes=128, chain=1, steps=1, iters=1),
    lambda: ab_benchmark.run(["."], log_n=4, turns=1, calls=1),
], ids=["roofline", "profile_stages", "time_fn", "sm_clock",
        "benchmark_gpu_msm_best", "montmul_benchmark", "ab_benchmark"])
def test_measurements_refuse_without_a_card(no_card, call):
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


def test_ab_turns_alternate_which_tree_goes_first():
    assert ab_benchmark.turn_order(["old", "new"], 3) == [
        "old", "new", "new", "old", "old", "new"]


def test_model_counts_two_slots_a_wide_product():
    """264 = two issue slots for each of the 128 wide products, one for
    each of the 8 low ones."""
    assert profiling.WIDE_IMAD_SLOTS == 2
    assert profiling.CIOS_MULS_PER_MONT_MUL == 2 * 128 + 8


@pytest.mark.parametrize("op,kind", [
    ("IMAD.WIDE.U32", "wide"), ("IMAD.WIDE.U32.X", "wide"),
    ("IMAD.WIDE", "wide"), ("IMAD.HI.U32", "hi"), ("IMAD", "narrow"),
    ("IMAD.SHL.U32", "narrow"), ("IMUL", "narrow"), ("IMAD.X", "x"),
    ("IMAD.MOV.U32", "mov"), ("IADD3.X", None), ("LOP3.LUT", None)])
def test_sass_kinds(op, kind):
    assert montmul_benchmark.imad_kind(op) == kind


def test_pipe_rates_count_each_slot_model():
    """A rate of one product an SM clock asks one product's instructions
    over 32 lanes: wide and hi count once or twice."""
    sass = {"per_product_kinds": {"wide": 16, "hi": 4, "narrow": 8, "x": 2,
                                  "mov": 2},
            "per_product_all": {"IMAD.WIDE.U32": 16, "IADD3.X": 32}}
    out = montmul_benchmark.pipe_rates(132 * 2e9, sass, 132, 2e9)
    assert out["products_per_sm_clock"] == pytest.approx(1.0)
    assert out["imad_slots_if_wide_is_1"] == pytest.approx(32 / 32)
    assert out["imad_slots_if_wide_is_2"] == pytest.approx(52 / 32)
    assert out["issue"] == pytest.approx(48 / 32)
    assert out["imad_ceiling"] == 2.0


def test_trace_refuses_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA device"):
        with profiling.trace(tmp_path / "t.json"):
            pass
    assert not (tmp_path / "t.json").exists()


def test_benchmark_inputs_are_the_jax_scripts():
    x = montmul_benchmark.inputs(300, "cpu")
    assert x.shape == (16, 300)
    vals = interop.limbs_to_ints(interop.tensor_to_limbs(x))
    assert len(set(vals)) == 128 and vals[:128] == vals[128:256]
    rng = np.random.RandomState(11)
    assert vals[0] == int.from_bytes(rng.bytes(32), "little") % bn254.P


def test_benchmark_cpu_msm_best_times_the_native_engine(monkeypatch):
    seen = []
    monkeypatch.setattr("tpu_msm_torch.bindings.native.msm",
                        lambda px, py, s: seen.append(px.shape))
    assert benchmarks.benchmark_cpu_msm_best(6) >= 0
    assert seen == [(16, 64)]
