"""Whole runs of the harness on the CPU at 64 points (the harness's look for
a card skipped): the result line, the cells, configurations, mixes and
metrics found by name, the import guard, and `correct` coming out false
under the control and under each fault a cell can have."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from msmbench import control, run
from msmbench.spec import Bench

from conftest import REPO, TINY, make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(root, trace=False, seconds=0.3, **faults):
    bench = Bench(root)
    if trace:  # the plain msm_device takes seconds on the CPU: stand in for it
        faults.setdefault("below_fault", lambda below: (lambda px, py, s: None))
    return run.run_cell(bench, bench.cell(TINY), 2**33 + 17, seconds, trace,
                        "cpu", time.perf_counter(), **faults)


def test_result_line(tiny_root):
    out = tiny_run(tiny_root)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > run.WARM_CALLS
    assert set(out["metrics"]) == {"points_per_s", "points_per_s.2p24",
                                   "msm_ms_p95", "setup_s"}
    assert (out["metrics"]["points_per_s"]
            == out["metrics"]["points_per_s.2p24"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"] == {"wrong_answers": {"value": 0, "limit": 0},
                             "table_rows_wrong": {"value": 0, "limit": 0}}
    json.dumps(out)


def test_traced_result_line(tiny_root):
    out = tiny_run(tiny_root, trace=True)
    assert out["correct"] is True
    assert out["attempted"] == run.WARM_CALLS + 3 + 2
    # No card traced: no device metric, and none made up.
    assert set(out["metrics"]) <= {"entry_ms", "entry_ms.2p24"}
    assert out["device"]["busy_s"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_cells_configurations_mixes_and_metrics_found_by_name(tmp_path):
    root = make_root(tmp_path)
    h = root / "msmbench"
    cfg = json.loads((h / "configs" / "tiny.json").read_text())
    cfg.update(name="tinier", log_size=5)
    (h / "configs" / "tinier.json").write_text(json.dumps(cfg))
    (h / "traffic" / "sparse.json").write_text(json.dumps(
        {"scalar_sets": 2, "distinct_bases": 8, "top_limb_below": 100}))
    (h / "metrics" / "calls_made.py").write_text(
        "def read(rec):\n    return len(rec.call_s) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinier", "source": "test", "reduced": [],
                            "file": "msmbench/configs/tinier.json",
                            "why": "test"})
    spec["workloads"].append({"name": "tinier-sparse", "config": "tinier",
                              "traffic": "sparse", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_made", "unit": "count",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root)
    cell = bench.cell("tinier-sparse")
    assert cell.n == 32 and cell.mix.scalar_sets == 2
    out = run.run_cell(bench, cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["calls_made"]["value"] == out["attempted"] - 2
    assert "msm_ms_p95" not in out["metrics"]  # listed for other cells only
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")


def test_a_qualified_metric_name_reads_with_its_base_reader(tmp_path):
    """`points_per_s.2p24` is `points_per_s` under a bound of its own; a
    qualified name with a file of its own takes that file."""
    root = make_root(tmp_path)
    (root / "msmbench" / "metrics" / "points_per_s.own.py").write_text(
        "def read(rec):\n    return -1.0\n")
    bench = Bench(root)
    rec = run.Record(cell=bench.cell(TINY), n=64, window_s=2.0, completed=3)
    assert bench.reader("points_per_s")(rec) == 96.0
    assert bench.reader("points_per_s.2p24")(rec) == 96.0
    assert bench.reader("points_per_s.own")(rec) == -1.0
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.2p24")


def test_import_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["tpu_msm_torch", "tpu_msm_torch_x",
                                  "tpu_msm_torch.ops.sort", "jaxtyping",
                                  "msmbench"]) == []
    assert run.forbidden_modules(["tpu_msm.utils", "os"]) == ["tpu_msm.utils"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib"]


def test_nothing_of_the_jax_side_is_loaded_by_a_run(tiny_root):
    """A whole run in a fresh process leaves no module of JAX or of the JAX
    package loaded, and no harness source imports one."""
    code = ("import json, sys, time\n"
            "from msmbench import run\n"
            "from msmbench.spec import Bench\n"
            f"bench = Bench({str(tiny_root)!r})\n"
            f"out = run.run_cell(bench, bench.cell({TINY!r}), 3, 0.2, False, "
            "'cpu', time.perf_counter())\n"
            "print(json.dumps([out['correct'], run.forbidden_modules(sys.modules)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == [True, []]
    for path in (REPO / "msmbench").rglob("*.py"):
        text = path.read_text()
        for bad in ("import jax", "from jax", "import tpu_msm\n",
                    "from tpu_msm ", "from tpu_msm.", "import tpu_msm."):
            assert bad not in text or path == Path(__file__), (path, bad)


@pytest.mark.parametrize("available, count", [(False, 0), (True, 0)])
def test_no_card_no_result(capsys, monkeypatch, available, count):
    """No CUDA card, or fewer cards than the cell asks for: a non-zero exit
    and nothing on standard output, whatever this machine holds."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    rc = run.main(["--workload", "msm-2p20-uniform", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "msmbench", tmp_path / "msmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "msmbench", "--workload", "msm-2p20-uniform",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def half_the_points(entry, sets, bases, work):
    import tpu_msm_torch

    def call(k):
        half = sets[k].shape[1] // 2
        return tpu_msm_torch.msm_best(
            sets[k][:, :half], (bases[0][:, :half], bases[1][:, :half]),
            device="cpu")
    return call


def altered_answer(entry, sets, bases, work):
    def call(k):
        x, y = entry(k)
        return x, y ^ 1
    return call


def unchanged_state(entry, sets, bases, work):
    first = {}

    def call(k):
        if "answer" not in first:
            first["answer"] = entry(k)
        return first["answer"]
    return call


def raises(entry, sets, bases, work):
    def call(k):
        raise RuntimeError("a call that fails")
    return call


@pytest.mark.parametrize("fault", [half_the_points, altered_answer,
                                   unchanged_state, raises,
                                   control.control_entry])
def test_correct_comes_out_false(tiny_root, fault):
    out = tiny_run(tiny_root, entry_fault=fault)
    assert out["correct"] is False
    assert out["failed"] == out["checks"]["wrong_answers"]["value"] > 0
    if fault in (half_the_points, altered_answer, raises, control.control_entry):
        assert out["failed"] == out["attempted"]


@pytest.mark.cuda
def test_a_small_cell_on_the_card(tmp_path, card):
    root = make_root(tmp_path, log_size=12)
    bench = Bench(root)
    for trace in (False, True):
        out = run.run_cell(bench, bench.cell(TINY), 9, 0.5, trace, card,
                           time.perf_counter())
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
        if trace:
            assert out["device"]["busy_s"] > 0
            assert {"torch_ms", "launches", "scan_roofline", "sort_roofline",
                    "idle_share"} <= set(out["metrics"])


def writes_into_its_table(entry, sets, bases, work):
    def call(k):
        bases[0][:, 0] = 0  # row 0: every run samples it
        return entry(k)
    return call


def test_a_program_that_writes_into_its_table_is_caught(tiny_root):
    out = tiny_run(tiny_root, entry_fault=writes_into_its_table)
    assert out["correct"] is False
    assert out["checks"]["table_rows_wrong"]["value"] >= 1
