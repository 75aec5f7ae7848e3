"""distaff_torch end to end on the CPU: the golden proof bytes pinned by
tests/test_determinism.py (the JAX package's), verification, and the
package's boundaries."""

import hashlib
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


@pytest.fixture(scope="module")
def golden_proof():
    program, inputs, options = _golden_case()
    outputs, proof = distaff_torch.execute(program, inputs, 1, options, device="cpu")
    return program, inputs, outputs, proof


def test_golden_proof_bytes(golden_proof):
    *_, proof = golden_proof
    blob = serde.serialize(proof)
    assert len(blob) == GOLDEN_LEN
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256


def test_verify_accepts_and_rejects_tampering(golden_proof):
    program, inputs, outputs, proof = golden_proof
    assert outputs == [8]
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(program.hash, inputs.get_public_inputs(), [9], proof)
    with pytest.raises(ValueError):
        distaff_torch.verify(b"\x00" * 32, inputs.get_public_inputs(), outputs, proof)


def test_serde_roundtrip_verifies(golden_proof):
    program, inputs, outputs, proof = golden_proof
    blob = serde.serialize(proof)
    again = serde.deserialize(blob)
    assert serde.serialize(again) == blob
    assert distaff_torch.verify(program.hash, inputs.get_public_inputs(), outputs, again)


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
