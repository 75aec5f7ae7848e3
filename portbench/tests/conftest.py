"""Shared fixtures of the benchmark's tests: the benchmark's folder and the
checkout's root on sys.path, small CPU proofs, and the card where a test
needs it (decided inside the fixture, never at import).

Run them in one process, `python -m pytest portbench/tests` from the
checkout's root (about 3 minutes on 8 cores): each CPU proof's proof of
work runs OpenMP on every core, so several workers slow one another down
many times over."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

# a small stand-in for the cells' configurations: the same program and
# options at 2^8 steps, which proves on the CPU in seconds
SMALL_STEPS = 256
SMALL_PROGRAM = f"begin repeat.{SMALL_STEPS * 3 // 64} swap dup.2 drop add end end"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def small_cell():
    """fib-2e16.execute's cell with its program cut to 2^8 steps."""
    from harness import spec

    cell = spec.Cell("fib-2e16.execute")
    cell.config = dict(cell.config, program=SMALL_PROGRAM, steps=SMALL_STEPS)
    return cell


@pytest.fixture(scope="session")
def small_proofs():
    """{case: (source, public inputs, outputs, proof bytes, options kwargs)}
    made by distaff_torch on the CPU."""
    import distaff_torch
    from distaff_torch import ProgramInputs, ProofOptions, assembly
    from distaff_torch.stark import serde

    cases = {
        "fib": (SMALL_PROGRAM, [2**100 + 3, 7], {}),
        "golden": ("begin push.3 push.5 add end", [],
                   {"extension_factor": 16, "num_queries": 10, "grinding_factor": 2}),
    }
    out = {}
    for name, (source, inputs, options) in cases.items():
        program = assembly.compile(source)
        outputs, proof = distaff_torch.execute(
            program, ProgramInputs.from_public(inputs), 1, ProofOptions(**options), device="cpu")
        out[name] = (source, inputs, [int(v) for v in outputs], serde.serialize(proof), options)
    return out
