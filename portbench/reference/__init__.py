"""The benchmark's plain reference for distaff_torch's proofs.

A frozen copy of the Distaff host verifier (reference src/stark/verifier.rs,
as the JAX package and the port carry it), cut to what verification needs
and run in plain Python: BLAKE3, the Merkle openings, the AIR at the DEEP
point, the composition, FRI and the proof of work, plus the assembler and
op-sponge that give a program its hash.  Beside it, `interpreter` runs a
program's text on a plain stack to give its outputs.  Nothing here imports
the port, the JAX package or a compiled library: what it judges it reads as
bytes.
"""

from .interpreter import run as run_program
from .programs import assembly
from .stark import serde
from .stark.options import ProofOptions
from .stark.verifier import verify


def program_hash(source):
    """The 32-byte hash of the program whose assembly text is `source`."""
    return assembly.compile(source).hash


def check_proof(proof_bytes, program_hash, inputs, outputs, options):
    """None where `proof_bytes` prove that the program with `program_hash`
    gives `outputs` on the public `inputs` under `options` (a ProofOptions);
    otherwise why not, in a few words."""
    try:
        proof = serde.deserialize(bytes(proof_bytes))
        verify(program_hash, list(inputs), list(outputs), proof, options)
    except Exception as e:  # a malformed proof fails wherever it breaks
        return f"{type(e).__name__}: {e}"[:200]
    return None


__all__ = ["ProofOptions", "check_proof", "program_hash", "run_program", "verify"]
