"""Where a traffic mix places its inputs between calls (`scalars_on`,
`bases_on`): the default mix draws what the generator drew before it had
the choice, an input placed on the host is a numpy copy of the card's draw
that the program is handed and the run judges, the layer below still gets
card tensors, an unknown key in a traffic file fails to load while the
words that describe a mix are dropped, and `h2d_ms` reads the copies from
host to device."""

import hashlib
import json
import time

import numpy as np
import pytest
import torch

from msmbench import control, run
from msmbench.spec import Bench
from msmbench.trace import Trace
from msmbench.traffic import DESCRIPTIVE, LIMBS, Mix, Workload

from conftest import HERE, make_root
from test_msmbench_trace import ev, record, synthetic

UNIFORM = json.loads((HERE / "traffic" / "uniform.json").read_text())
DRAWS = ((64, 2**33 + 17), (4096, 2**40 + 3))  # (n, seed)
# sha256 over DRAWS of the uniform mix's bases and scalar sets on the CPU,
# as the generator drew them before a mix could place its inputs.
BEFORE = "cb43690a395d0db3d28bcc94e91d2a3fbaf3ae8dc8303f8cbc37154e3ff63798"
PLACEMENTS = [{"scalars_on": "host"}, {"bases_on": "host"},
              {"scalars_on": "host", "bases_on": "host"}]
IDS = ["scalars", "bases", "both"]
HTOD = "Memcpy HtoD (Pageable -> Device)"


def placed_inputs(w):
    return list(w.placed_bases()) + [w.placed_scalars(k)
                                     for k in range(w.mix.scalar_sets)]


def test_the_default_mix_draws_what_it_drew_before():
    mix = Mix.from_dict(UNIFORM)
    assert (mix.scalars_on, mix.bases_on) == ("card", "card")
    h = hashlib.sha256()
    for n, seed in DRAWS:
        for t in placed_inputs(Workload(mix, n, seed, "cpu")):
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
            h.update(t.numpy().tobytes())
    assert h.hexdigest() == BEFORE


@pytest.mark.parametrize("placed", PLACEMENTS, ids=IDS)
def test_a_host_input_is_a_numpy_copy_of_the_cards_draw(placed):
    mix = Mix.from_dict({**UNIFORM, **placed})
    n, seed = DRAWS[0]
    w = Workload(mix, n, seed, "cpu")
    drawn = list(w.bases()) + [w.scalars(k) for k in range(mix.scalar_sets)]
    places = [mix.bases_on] * 2 + [mix.scalars_on] * mix.scalar_sets
    for got, want, on in zip(placed_inputs(w), drawn, places):
        if on == "host":
            assert isinstance(got, np.ndarray) and got.dtype == np.uint32
            assert got.shape == (LIMBS, n) and got.flags.c_contiguous
            assert np.array_equal(got, want.numpy().view(np.uint32))
        else:
            assert isinstance(got, torch.Tensor) and torch.equal(got, want)


def add_cell(root, name, params) -> Bench:
    """Mix `params` as traffic `name` under the tiny configuration, in a
    cell `name` that every metric listing cells lists."""
    (root / "msmbench" / "traffic" / f"{name}.json").write_text(
        json.dumps(params))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": "tiny", "traffic": name,
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root)


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("placed", PLACEMENTS, ids=IDS)
def test_a_run_hands_the_program_host_arrays_and_judges_them(tmp_path, placed,
                                                             trace):
    bench = add_cell(make_root(tmp_path), "tiny-placed", {**UNIFORM, **placed})
    cell = bench.cell("tiny-placed")
    handed, below_got = [], []

    def spy(entry, sets, bases, work):
        handed.extend([*bases, *sets])
        return entry

    def below(fn):  # the plain msm_device takes seconds on the CPU
        return lambda *args: below_got.extend(args)

    out = run.run_cell(bench, cell, 2**33 + 17, 0.3, trace, "cpu",
                       time.perf_counter(), entry_fault=spy,
                       below_fault=below if trace else None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["table_rows_wrong"]["value"] == 0
    places = [cell.mix.bases_on] * 2 + [cell.mix.scalars_on] * 5
    assert [isinstance(a, np.ndarray) for a in handed] == [
        on == "host" for on in places]
    if trace:
        assert below_got and all(isinstance(a, torch.Tensor)
                                 for a in below_got)
    else:
        assert "points_per_s.host" in out["metrics"]


@pytest.mark.parametrize("placed", PLACEMENTS, ids=IDS)
def test_the_control_reads_host_sets_and_fails(tmp_path, placed):
    bench = add_cell(make_root(tmp_path), "tiny-placed", {**UNIFORM, **placed})
    out = run.run_cell(bench, bench.cell("tiny-placed"), 7, 0.3, False, "cpu",
                       time.perf_counter(), entry_fault=control.control_entry)
    assert out["correct"] is False and out["failed"] == out["attempted"]


def test_an_unknown_key_in_a_traffic_file_fails_to_load(tmp_path):
    bench = add_cell(make_root(tmp_path), "tiny-placed",
                     {**UNIFORM, "placement": "host"})
    with pytest.raises(ValueError, match="placement"):
        bench.cell("tiny-placed")


def test_the_words_that_describe_a_mix_steer_nothing():
    bare = {k: v for k, v in UNIFORM.items() if k not in DESCRIPTIVE}
    words = {k: f"{k} in words" for k in DESCRIPTIVE}
    assert Mix.from_dict({**bare, **words}) == Mix.from_dict(bare)


@pytest.mark.parametrize("bad", [{"scalars_on": "disk"},
                                 {"bases_on": "pinned"}])
def test_a_place_other_than_card_or_host_fails(bad):
    with pytest.raises(ValueError, match=next(iter(bad))):
        Mix.from_dict({**UNIFORM, **bad})


def test_every_traffic_file_loads():
    mixes = {p.stem: Mix.from_dict(json.loads(p.read_text()))
             for p in (HERE / "traffic").glob("*.json")}
    assert {"uniform", "host"} <= set(mixes)
    assert mixes["host"] == Mix.from_dict({**UNIFORM, "scalars_on": "host"})


def test_h2d_ms_finds_nothing_without_a_trace_or_a_copy():
    bench = Bench()
    assert bench.reader("h2d_ms.host")(record(None)) is None
    # The synthetic trace copies from device to host only.
    assert bench.reader("h2d_ms.host")(record(Trace(synthetic()))) is None


def test_h2d_ms_reads_the_copies_from_host_to_device():
    events = synthetic() + [ev("gpu_memcpy", HTOD, 20, 30),
                            ev("gpu_memcpy", HTOD, 175, 10),
                            ev("gpu_memcpy", HTOD, -40, 10)]  # before the window
    rec = record(Trace(events))
    assert Bench().reader("h2d_ms.host")(rec) == pytest.approx(40e-3 / 2)
