"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix and its per-layer metrics' readers, each found by name.

The benchmark's folder holds one file a configuration (configs/<name>.json),
a traffic mix (traffic/<name>.json) and a per-layer metric (metrics/<name>.py,
whose read(run) returns the metric's value or None); a cell that a later
change adds needs new files and entries only.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell:
    """One workload of BENCHMARK.json with what it names, read from disk."""

    def __init__(self, name):
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        self.name = name
        self.entry = cells[name]
        self.chips = self.entry["chips"]
        config_entry = next(c for c in spec["configs"] if c["name"] == self.entry["config"])
        self.config = json.loads((ROOT / config_entry["file"]).read_text())
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"] if _covers(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _covers(m, name)]
        self.bench_dir = BENCH_DIR

    def reader(self, metric):
        """The read(run) function of a per-layer metric's file."""
        path = self.bench_dir / "metrics" / f"{metric['name']}.py"
        module_spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric['name'].replace('.', '_').replace('-', '_')}", path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        return module.read


def _covers(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]
