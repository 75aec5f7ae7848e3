"""distaff_torch end to end on the CPU: the golden proof bytes pinned by
tests/test_determinism.py (the JAX package's), verification, and the
package's boundaries.  On the CPU every step runs its kernels' plain
versions, step 3's transition constraints included (K4's plain version,
stark/constraints/device_eval.transition_plain), so the golden bytes hold
that path too."""

import hashlib
import logging
import re
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
    assert steps[10:12] == ["step 4 constraint polynomial", "step 5 constraint tree"]
    assert steps[12:16] == ["step 6 part coefficients (host)",
                            "step 6 part point evaluations (K8)",
                            "step 6 part composition (K7)", "step 6 DEEP composition"]
    assert steps[16:20] == ["step 7 part layer trees", "step 7 part root draws",
                            "step 7 part folds (K9)", "step 7 FRI layers"]
    assert [s.split()[1] for s in steps[20:]] == ["8", "9"]


# The golden case proved with sha3 by the JAX package: its proof's bytes
# before the options (serde.serialize_body; the reference serializes the
# options of blake3 proofs only).  Produced once, from the repository root:
#   JAX_PLATFORMS=cpu python -c "import hashlib, distaff_tpu as d; \
#     from distaff_tpu.stark import serde; \
#     p = d.assembly.compile('begin push.3 push.5 add end'); \
#     o, proof = d.execute(p, d.ProgramInputs.none(), 1, d.ProofOptions(16, 10, 2, 'sha3')); \
#     proof.options.hash_fn = 'blake3'; b = serde.serialize(proof)[:-4]; \
#     print(len(b), hashlib.sha256(b).hexdigest())"
SHA3_BODY_SHA256 = "73fd09242cd8ffc781def7cd68416ea83fd41c59d63a94c570d15a03340ba74b"
SHA3_BODY_LEN = 13794


def test_sha3_proof_gives_the_jax_packages_bytes(golden_proof):
    # the trace, constraint and FRI trees are hashed on the host with sha3
    program, inputs, options = _golden_case()
    options = ProofOptions(16, 10, 2, "sha3")
    outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    body = serde.serialize_body(proof)
    assert len(body) == SHA3_BODY_LEN
    assert hashlib.sha256(body).hexdigest() == SHA3_BODY_SHA256
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(program.hash, inputs.get_public_inputs(), [9], proof)
    # a blake3 proof's body is its serialization less the options
    blob = serde.serialize(golden_proof[3])
    assert serde.serialize_body(golden_proof[3]) == blob[:-4]


@pytest.mark.parametrize("hash_name", ["poseidon", "rescue", "gmimc"])
def test_arithmetic_hashes_raise_as_the_jax_packages_do(hash_name):
    # they take at most 64 bytes; the golden trace's rows are 17 registers
    # of 16 bytes, so both packages raise when step 2 hashes the first row
    from distaff_tpu.crypto import hashes as jax_hashes

    with pytest.raises(Exception) as jax_error:
        jax_hashes.HASH_FUNCTIONS[hash_name](bytes(17 * 16))
    program, inputs, _ = _golden_case()
    with pytest.raises(jax_error.type, match=f"^{re.escape(str(jax_error.value))}$") as error:
        distaff_torch.execute(program, inputs, 1, ProofOptions(16, 10, 2, hash_name),
                              device="cpu")
    # raised by the hash's input check, as the trace tree's leaves are hashed
    frames = [entry.name for entry in error.traceback]
    assert frames[-3:] == ["hash_leaves", hash_name, "_state_from_bytes"]
    assert "build_merkle_tree" in frames


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
