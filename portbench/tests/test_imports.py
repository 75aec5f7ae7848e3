"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port, compared by whole top-level names."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT, SMALL_PROGRAM

FORBIDDEN = {"jax", "jaxlib", "flax", "distaff_tpu"}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

# runs the entry from the checkout's root, as far as it gets without a card,
# then the rest of a run through the harness's CPU path on a small program, and
# prints the top-level names of every module loaded
ENTRY = """
import json, runpy, sys
sys.argv = ["portbench/run.py", "--workload", {cell!r}, "--seed", "4294967311",
            "--seconds", "0.1", "--trace", {trace!r}]
try:
    runpy.run_path("portbench/run.py", run_name="__main__")
except SystemExit as e:
    code = e.code
if {full}:
    from harness import cli, spec
    cell = spec.Cell({cell!r})
    cell.config = dict(cell.config, program={program!r})
    result, _ = cli.run(cell, 4294967311, 0.1, {trace} == "1", "cpu")
    assert result["correct"], result
print(json.dumps([code, sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_entry_loads_no_jax(cell, trace):
    code, modules = _modules(ENTRY.format(cell=cell, trace=trace, full=False,
                                          program=SMALL_PROGRAM))
    assert code == 2  # no card here: the entry stops, with no result
    assert not FORBIDDEN & set(modules)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_whole_run_loads_no_jax(trace):
    code, modules = _modules(ENTRY.format(cell=CELLS[-1], trace=trace, full=True,
                                          program=SMALL_PROGRAM))
    assert "distaff_torch" in modules
    assert not FORBIDDEN & set(modules)


def test_reference_loads_nothing_of_the_port(small_proofs, tmp_path):
    source, inputs, outputs, proof, options = small_proofs["fib"]
    (tmp_path / "proof.bin").write_bytes(proof)
    code = f"""
import json, sys
sys.path.insert(0, {str(BENCH_DIR)!r})
import reference
blob = open({str(tmp_path / "proof.bin")!r}, "rb").read()
why = reference.check_proof(blob, reference.program_hash({source!r}), {inputs!r}, {outputs!r},
                            reference.ProofOptions(**{options!r}))
assert why is None, why
print(json.dumps([0, sorted({{m.split(".")[0] for m in sys.modules}})]))
"""
    _, modules = _modules(code)
    assert "reference" in modules
    assert not ({"distaff_torch", "torch"} | FORBIDDEN) & set(modules)


def test_cells_run_on_the_card(card):
    for cell in CELLS:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "4294967311",
             "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
            timeout=1200)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_run_that_loaded_jax_gives_no_result(small_cell, monkeypatch):
    import types

    from harness import cli

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    result, lines = cli.run(small_cell, 2**35 + 3, 0.1, False, "cpu")
    assert result is None
    assert lines[-1] == "the run loaded jax"
