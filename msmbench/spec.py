"""`BENCHMARK.json` and the files it names, each found by its name:

    configuration  the `file` of its entry in `configs`
    traffic mix    msmbench/traffic/<traffic>.json
    metric         msmbench/metrics/<name>.py, whose read(record) returns
                   the metric's value, or None where it finds nothing to read;
                   a name `<base>.<qualifier>` with no file of its own is
                   read by `<base>`'s reader: the same quantity in other
                   cells, under a bound of its own

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

from msmbench.traffic import Mix

ROOT = Path(__file__).resolve().parents[1]
HARNESS = "msmbench"


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: Optional[tuple] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: Mix
    metrics: List[Metric] = field(default_factory=list)

    @property
    def n(self) -> int:
        return 1 << int(self.config["log_size"])

    def wanted(self, trace: bool) -> List[Metric]:
        """The metrics a run reports: end to end untraced, per layer
        traced."""
        return [m for m in self.metrics if m.end_to_end != trace]


class Bench:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(work)})")
        w = work[name]
        [cfg] = [c for c in self.spec["configs"] if c["name"] == w["config"]]
        config = json.loads((self.root / cfg["file"]).read_text())
        mix_file = self.root / HARNESS / "traffic" / f"{w['traffic']}.json"
        mix = Mix.from_dict(json.loads(mix_file.read_text()))
        metrics = [Metric(m["name"], m["unit"], end_to_end,
                          tuple(m["workloads"]) if "workloads" in m else None)
                   for key, end_to_end in (("end_to_end", True),
                                           ("per_layer", False))
                   for m in self.spec[key]]
        return Cell(name, int(w["chips"]), config, mix,
                    [m for m in metrics if m.applies(name)])

    def reader(self, metric: str) -> Callable:
        path = self.root / HARNESS / "metrics" / f"{metric}.py"
        if not path.exists() and "." in metric:
            return self.reader(metric.split(".", 1)[0])
        mod_name = f"{HARNESS}.metrics.{re.sub(r'[^0-9A-Za-z_]', '_', metric)}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
