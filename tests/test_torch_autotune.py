"""The port's autotune table and `select_config` on the CPU: lookup by the
nearest log size, a corrupt table, merging measurements, the committed
"cuda" rows, and the CPU's heuristic against the JAX package's."""

import json

import pytest

torch = pytest.importorskip("torch")

from tpu_msm.utils.config import select_config as jax_select_config  # noqa: E402
from tpu_msm_torch.utils import autotune  # noqa: E402
from tpu_msm_torch.utils.config import MsmConfig, select_config  # noqa: E402

ROW = {"window_bits": 16, "scan_lanes": 4096, "reduce_fanout": 2048,
       "signed_digits": True, "glv": False}


@pytest.fixture
def table(tmp_path, monkeypatch):
    """An empty table file in tmp_path in place of the committed one."""
    path = tmp_path / "tuned_configs.json"
    monkeypatch.setattr(autotune, "TABLE_PATH", path)
    return path


def _write(path, table):
    path.write_text(json.dumps(table))


def test_lookup_takes_the_nearest_log_size_within_one(table):
    rows = {"16": {"best": dict(ROW, scan_lanes=2048)},
            "18": {"best": dict(ROW, glv=True)}}
    _write(table, {"cuda": rows})
    assert autotune.lookup(1 << 16) == rows["16"]["best"]
    assert autotune.lookup(1 << 15) == rows["16"]["best"]
    assert autotune.lookup(1 << 17) in (rows["16"]["best"],
                                        rows["18"]["best"])
    assert autotune.lookup(1 << 19) == rows["18"]["best"]
    assert autotune.lookup((1 << 18) - 5) == rows["18"]["best"]  # log 18
    assert autotune.lookup(1 << 14) is None
    assert autotune.lookup(1 << 20) is None
    assert autotune.lookup(1 << 16, "cpu") is None


def test_corrupt_table_gives_empty(table, capsys):
    table.write_text('{"cuda": {"16": ')
    assert autotune.load_table() == {}
    assert "ignoring unreadable" in capsys.readouterr().err
    assert autotune.lookup(1 << 16) is None
    assert select_config(1 << 16, "cuda") == select_config(1 << 16, "cpu")


def test_missing_table_gives_empty(table):
    assert autotune.load_table() == {}


def test_merge_row_composes():
    rows = {}
    a = dict(ROW, seconds=0.3)
    b = dict(ROW, scan_lanes=8192, seconds=0.2)
    autotune._merge_row(rows, 18, a)
    autotune._merge_row(rows, 18, b)
    assert rows["18"]["best"]["scan_lanes"] == 8192
    assert len(rows["18"]["measurements"]) == 2
    # A new measurement of the same knobs replaces the old one.
    autotune._merge_row(rows, 18, dict(b, seconds=0.5))
    assert rows["18"]["best"]["scan_lanes"] == 4096
    assert [m["seconds"] for m in rows["18"]["measurements"]] == [0.3, 0.5]


def test_write_table_round_trips(table):
    autotune._write_table({"cuda": {"20": {"best": ROW}}})
    assert autotune.lookup(1 << 20) == ROW
    assert not table.with_name(table.name + ".tmp").exists()


def test_combos_pair_glv_with_signed_digits():
    combos = list(autotune.combos(autotune.DEFAULT_SPACE, 1 << 20))
    assert len(combos) == 2 * 3 * 3 * 3  # (unsigned) + (signed, glv or not)
    assert not any(c["glv"] and not c["signed_digits"] for c in combos)
    small = list(autotune.combos(autotune.DEFAULT_SPACE, 4096))
    assert {c["scan_lanes"] for c in small} == {2048}
    assert "field_impl" not in autotune.DEFAULT_SPACE


def test_select_config_reads_the_row(table):
    _write(table, {"cuda": {"16": {"best": dict(ROW, glv=True)}}})
    cfg = select_config(1 << 16, "cuda")
    assert cfg == MsmConfig(window_bits=16, scan_lanes=4096,
                            reduce_fanout=2048, signed_digits=True, glv=True)
    # Lanes clamp for small n: two points a lane at least.
    assert select_config(1 << 15, "cuda").scan_lanes == 4096
    assert select_config(3000, "cuda") == select_config(3000, "cpu")


@pytest.mark.parametrize("log_n", [3, 10, 12, 16, 17, 18, 20, 22])
def test_select_config_on_cpu_is_the_jax_heuristic(log_n):
    """No "cpu" rows: the heuristic's knobs, as the JAX package's CPU
    backend gets them (its table has only "tpu" rows)."""
    n = 1 << log_n
    got = select_config(n, "cpu")
    want = jax_select_config(n)
    assert (got.window_bits, got.scan_lanes, got.reduce_fanout,
            got.signed_digits, got.glv) == (
        want.window_bits, want.scan_lanes, want.reduce_fanout,
        want.signed_digits, want.glv)


def test_committed_table_has_cuda_rows_with_the_card():
    rows = autotune.load_table()["cuda"]
    assert {"16", "18", "20"} <= set(rows)
    for row in rows.values():
        assert row["best"] == {k: row["measurements"][0][k]
                               for k in row["best"]}
        for m in row["measurements"]:
            assert "H100" in m["card"] and " W" in m["card"]
            assert m["seconds"] > 0


def test_sweep_refuses_without_a_card(table, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        autotune.sweep([10], repeats=1, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        autotune.measure(10, ROW, repeats=1)
    assert not table.exists()
