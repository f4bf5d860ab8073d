"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
under a temporary root, with a cell small enough for the CPU."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
TINY = "tiny-uniform"


def make_root(tmp: Path, log_size: int = 6) -> Path:
    """BENCHMARK.json and msmbench's data and readers under `tmp`, plus a
    configuration of 2^log_size points and its cell `tiny-uniform`, which
    every metric lists."""
    root = tmp / "bench"
    (root / "msmbench").mkdir(parents=True)
    for sub in ("traffic", "metrics", "configs"):
        shutil.copytree(HERE / sub, root / "msmbench" / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "bn254-g1-2p20.json").read_text())
    cfg.update(name="tiny", log_size=log_size, trace_calls=3, entry_pairs=2)
    (root / "msmbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                            "file": "msmbench/configs/tiny.json", "why": "test"})
    spec["workloads"].append({"name": TINY, "config": "tiny",
                              "traffic": "uniform", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
