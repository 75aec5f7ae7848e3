"""distaff_torch end to end on the CPU: the golden proof bytes pinned by
tests/test_determinism.py (the JAX package's), verification, and the
package's boundaries.  On the CPU every step runs its kernels' plain
versions, step 3's transition constraints included (K4's plain version,
stark/constraints/device_eval.transition_plain), so the golden bytes hold
that path too."""

import hashlib
import logging
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distaff_torch
from distaff_torch import assembly, ProgramInputs, ProofOptions
from distaff_torch.stark import serde

GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
REPO = Path(__file__).resolve().parent.parent


def _golden_case():
    program = assembly.compile("begin push.3 push.5 add end")
    options = ProofOptions(extension_factor=16, num_queries=10, grinding_factor=2)
    return program, ProgramInputs.none(), options


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def golden_proof():
    """The golden case proved on the CPU with the prover's DEBUG step log on;
    returns (program, inputs, outputs, proof, log lines)."""
    program, inputs, options = _golden_case()
    steps = _Lines()
    package_log = logging.getLogger("distaff_torch")
    level = package_log.level
    package_log.addHandler(steps)
    package_log.setLevel(logging.DEBUG)
    try:
        outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    finally:
        package_log.removeHandler(steps)
        package_log.setLevel(level)
    return program, inputs, outputs, proof, steps.lines


def test_golden_proof_bytes(golden_proof):
    proof = golden_proof[3]
    blob = serde.serialize(proof)
    assert len(blob) == GOLDEN_LEN
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256


def test_verify_accepts_and_rejects_tampering(golden_proof):
    program, inputs, outputs, proof, _ = golden_proof
    assert outputs == [8]
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(program.hash, inputs.get_public_inputs(), [9], proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(b"\x00" * 32, inputs.get_public_inputs(), outputs, proof)


def test_serde_roundtrip_verifies(golden_proof):
    program, inputs, outputs, proof, _ = golden_proof
    blob = serde.serialize(proof)
    again = serde.deserialize(blob)
    assert serde.serialize(again) == blob
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, again)


def test_step_log_times_every_step_and_step_three_parts(golden_proof):
    lines = golden_proof[4]
    steps = [line.split(":")[0] for line in lines if line.startswith("step ")]
    assert steps[:5] == ["step 0 execute program", "step 1 part upload",
                         "step 1 part interpolation", "step 1 part LDE", "step 1 extend trace"]
    assert steps[5:8] == ["step 2 trace tree", "step 3 part evaluator (host)",
                          "step 3 part boundary columns"]
    assert steps[8:10] == ["step 3 part transition (K4 tables and launch)",
                           "step 3 evaluate constraints"]
    assert [s.split()[1] for s in steps[10:]] == ["4", "5", "6", "7", "8", "9"]


def test_package_imports_neither_jax_nor_distaff_tpu():
    code = (
        "import pkgutil, sys, distaff_torch\n"
        "for m in pkgutil.walk_packages(distaff_torch.__path__, 'distaff_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'distaff_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_execute_needs_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program, inputs, options = _golden_case()
    with pytest.raises(RuntimeError, match="CUDA"):
        distaff_torch.execute(program, inputs, 1, options)


def test_kernel_bench_runs_on_cpu(capsys):
    from distaff_torch.tools import kernel_bench

    rows = kernel_bench.bench([7], device="cpu")
    assert [r["op"] for r in rows] == [
        "tiles.ntt", "ntt_stagewise", "mul", "power_series", "inv_batch", "exp_const",
        "blake3 32x64B", "air_transition"]
    assert all(r["ms"] > 0 for r in rows)
    assert "2^7   air_transition" in capsys.readouterr().out
