"""distaff_torch: the Distaff zkVM STARK prover and verifier on PyTorch and CUDA.

The port of distaff_tpu (JAX on a TPU) to one NVIDIA H100.  The API mirrors
the reference crate (reference src/lib.rs):

- execute(program, inputs, num_outputs, options, device="cuda")
      -> (outputs, StarkProof)
- verify(program_hash, public_inputs, outputs, proof) -> True / raises

execute() raises AssertionError, as the JAX package does, where a
precondition fails (too many outputs, too short a run, a program hash that
does not match its trace) or the VM fails.

The VM (native C++) and the verifier run on the host; trace extension,
commitments, constraint composition and FRI folding run on the device
through the hand-written kernels in distaff_torch/csrc.  The device is the
card unless the caller passes device="cpu", which runs each kernel's plain
PyTorch version instead.  Proofs are byte-identical to distaff_tpu's.

Importing the package joins a multi-process proving job where the
environment asks for one (dist_setup.py), as distaff_tpu's import does.
"""

import logging
import time

import torch

from . import dist_setup

dist_setup.initialize_distributed()

from .config import MAX_OUTPUTS, MIN_TRACE_LENGTH
from .programs import Program, ProgramInputs, assembly
from .stark import ProofOptions, StarkProof, TraceTable
from . import stark

log = logging.getLogger(__name__)


def execute(program, inputs, num_outputs, options, device="cuda"):
    """Execute `program` and return (outputs, proof of execution), proving
    on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("execute(device='cuda'): no CUDA device is available")
    if num_outputs > MAX_OUTPUTS:
        raise AssertionError(
            f"cannot produce more than {MAX_OUTPUTS} outputs, but requested {num_outputs}")

    from . import native
    start = time.perf_counter()
    trace_registers, ctx_depth, loop_depth = native.execute_u64(program, inputs)
    trace = TraceTable(trace_registers, ctx_depth, loop_depth, options.extension_factor())
    log.debug("step 0 execute program: %.3f ms", (time.perf_counter() - start) * 1000)

    last_state = trace.get_last_state()
    outputs = last_state.user_stack[:num_outputs]
    if last_state.op_counter < MIN_TRACE_LENGTH:
        raise AssertionError(
            f"a program must consist of at least {MIN_TRACE_LENGTH} operations, "
            f"but only {last_state.op_counter} were executed")

    from .math import field
    program_hash = b"".join(field.to_bytes(v) for v in last_state.program_hash())
    if program.hash != program_hash:
        raise AssertionError(
            f"expected program hash {program.hash.hex()} does not match trace hash "
            f"{program_hash.hex()}")

    proof = stark.prove(trace, inputs.get_public_inputs(), outputs, options, device)
    return outputs, proof


def verify(program_hash, public_inputs, outputs, proof):
    """Verify a proof of execution against a 32-byte program hash."""
    return stark.verify(program_hash, public_inputs, outputs, proof)


__all__ = [
    "execute", "verify", "Program", "ProgramInputs", "assembly",
    "ProofOptions", "StarkProof",
]
