"""distaff_torch's examples, Rescue hasher and CLI on the CPU, against the
JAX package: each example program and its inputs equal the JAX package's,
each proves through the port's plain kernel versions, the port's verifier
and the JAX package's host verifier accept it, and the CLI prints the JAX
CLI's lines.  No JAX jit compile and no JAX proof runs here."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import distaff_torch
from distaff_torch import examples, ProofOptions
from distaff_torch.stark import serde
from distaff_torch.utils import hasher
from test_torch_prove import TableLog

from distaff_tpu import examples as jax_examples
from distaff_tpu import verify as jax_verify
from distaff_tpu.math import field as jax_field
from distaff_tpu.stark import serde as jax_serde
from distaff_tpu.stark.options import ProofOptions as JaxProofOptions
from distaff_tpu.utils import hasher as jax_hasher

REPO = Path(__file__).resolve().parent.parent
OPTIONS = (16, 10, 2)                        # extension, queries, grinding
# each example at its defaults and at one other parameter
CASES = [
    ("fibonacci", ()), ("fibonacci", (50,)),
    ("collatz", ()), ("collatz", (27,)),
    ("comparison", ()), ("comparison", (12,)),
    ("conditional", ()), ("conditional", (0, 7, 9)),
    ("rangecheck", ()), ("rangecheck", (1 << 40, 32)),
    ("merkle", ()), ("merkle", (6,)),
]
# the parameters each example proves at here: the shortest trace of the
# example's depths (ctx, loop, stack), so that the plain kernel versions
# stay cheap; collatz(4) takes both branches of its loop.  The card proves
# them at their defaults (chip_smoke.py)
PROVED = {"fibonacci": (), "collatz": (4,), "comparison": (), "conditional": (),
          "rangecheck": (42, 8), "merkle": (3,)}


@pytest.mark.parametrize("name,args", CASES)
def test_example_equals_the_jax_packages(name, args):
    program, inputs, num_outputs, expected = examples.EXAMPLES[name](*args)
    j_program, j_inputs, j_num_outputs, j_expected = jax_examples.EXAMPLES[name](*args)
    assert program.hash == j_program.hash
    assert inputs.get_public_inputs() == j_inputs.get_public_inputs()
    assert inputs.get_secret_inputs() == j_inputs.get_secret_inputs()
    assert (num_outputs, expected) == (j_num_outputs, j_expected)


def test_examples_are_the_jax_packages():
    assert list(examples.EXAMPLES) == list(jax_examples.EXAMPLES)


def test_hasher_digest_equals_the_jax_packages():
    rng = np.random.default_rng(6)
    for length in range(5):
        for _ in range(3):
            values = [int.from_bytes(rng.bytes(16), "little") % jax_field.M
                      for _ in range(length)]
            assert hasher.digest(values) == jax_hasher.digest(values)


_proofs = {}


def _proved(name):
    """The example proved on the CPU (once a module run), its power tables
    logged (test_torch_prove.TableLog): (program, inputs, outputs, expected,
    proof, the log)."""
    if name not in _proofs:
        program, inputs, num_outputs, expected = examples.EXAMPLES[name](*PROVED[name])
        with pytest.MonkeyPatch.context() as monkeypatch, TableLog(monkeypatch) as log:
            outputs, proof = distaff_torch.execute(
                program, inputs, num_outputs, ProofOptions(*OPTIONS), device="cpu")
        _proofs[name] = program, inputs, outputs, expected, proof, log
    return _proofs[name]


@pytest.mark.parametrize("name", sorted(examples.EXAMPLES))
def test_example_proof_builds_only_its_planned_tables(name):
    _proved(name)[5].check()


@pytest.mark.parametrize("name", sorted(examples.EXAMPLES))
def test_example_proves_and_verifies_on_cpu(name):
    program, inputs, outputs, expected, proof, _ = _proved(name)
    assert outputs == expected
    public = inputs.get_public_inputs()
    assert distaff_torch.verify(program.hash, public, outputs, proof)
    tampered = list(outputs)
    tampered[0] = (tampered[0] + 1) % jax_field.M
    with pytest.raises(ValueError):
        distaff_torch.verify(program.hash, public, tampered, proof)


@pytest.mark.parametrize("name", sorted(examples.EXAMPLES))
def test_jax_verifier_accepts_the_ports_proof(name):
    # the JAX package's verifier is host code: it compiles nothing
    program, inputs, outputs, _, proof, _ = _proved(name)
    blob = serde.serialize(proof)
    assert jax_verify(program.hash, inputs.get_public_inputs(), outputs,
                      jax_serde.deserialize(blob))


def test_cli_prints_the_jax_clis_lines():
    run = subprocess.run(
        [sys.executable, "-m", "distaff_torch", "fibonacci", "6", *map(str, OPTIONS),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    program, _, _, expected = jax_examples.fibonacci(6)
    size = len(serde.serialize(_proved("fibonacci")[4])) // 1024
    bits = JaxProofOptions(*OPTIONS).security_level(True)
    rule = re.escape("-" * 32)
    want = [rule, rule, rf"Executed program with hash {program.hash.hex()} in \d+ ms",
            re.escape(f"Program output: {expected}"),
            re.escape(f"Execution proof size: {size} KB"),
            re.escape(f"Execution proof security: {bits} bits"), rule,
            r"Execution verified in \d+ ms"]
    lines = run.stdout.splitlines()
    assert len(lines) == len(want), run.stdout
    for line, pattern in zip(lines, want):
        assert re.fullmatch(pattern, line), (line, pattern)
    assert "step 9 proof assembly" in run.stderr


def test_cli_needs_cuda_unless_cpu_requested(monkeypatch):
    import torch
    from distaff_torch.__main__ import main, parse_args

    assert parse_args(["merkle", "5", "--device", "cpu", "32"])[1:] == (
        5, ProofOptions(32, 50, 20), "cpu")
    assert parse_args([])[3] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["fibonacci"])
