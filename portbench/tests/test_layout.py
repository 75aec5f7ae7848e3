"""A configuration, a traffic mix and a per-layer metric added as files in a
copy of the benchmark are found by name and run through the harness's CPU
path, with no file of the copy edited."""

import json
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT, SMALL_PROGRAM, SMALL_STEPS

METRIC = '''"""steps_seen: the step lines a proof logs, as a count."""


def read(run):
    return sum(len(r.steps) for r in run.requests) / len(run.requests)
'''


def test_added_files_make_a_cell(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*") if p.is_file()}

    config = json.loads((BENCH_DIR / "configs" / "fib-2e16.json").read_text())
    config.update(name="fib-2e8", steps=SMALL_STEPS, program=SMALL_PROGRAM)
    (copy / "portbench" / "configs" / "fib-2e8.json").write_text(json.dumps(config))
    traffic = json.loads((BENCH_DIR / "traffic" / "execute.json").read_text())
    traffic["checked_proofs"] = 1
    (copy / "portbench" / "traffic" / "execute-brief.json").write_text(json.dumps(traffic))
    (copy / "portbench" / "metrics" / "steps_seen.py").write_text(METRIC)
    spec["configs"].append({"name": "fib-2e8", "source": "test", "reduced": ["steps"],
                            "file": "portbench/configs/fib-2e8.json", "why": "test"})
    spec["workloads"].append({"name": "fib-2e8.execute-brief", "config": "fib-2e8",
                              "traffic": "execute-brief", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_seen", "unit": "lines", "better": "higher",
                              "source": "program_span", "layer": "Prover steps",
                              "moves": "proof_s", "workloads": ["fib-2e8.execute-brief"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    code = f"""
import json, sys
sys.path[:0] = [{str(copy / "portbench")!r}, {str(copy)!r}, {str(ROOT)!r}]
from harness import cli, spec
cell = spec.Cell("fib-2e8.execute-brief")
assert cell.bench_dir == spec.BENCH_DIR and str(spec.BENCH_DIR).startswith({str(copy)!r})
print(json.dumps([cli.run(cell, 12345678901, 0.1, traced, "cpu")[0] for traced in (False, True)]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"proof_s", "setup_s"}  # no card: no memory reading
    # the metrics that list their cells stay with them
    assert set(traced["metrics"]) == {"steps_seen"}
    assert traced["metrics"]["steps_seen"]["value"] == 10  # steps 0 to 9
    for path, content in before.items():
        assert path.read_bytes() == content, path
