from .options import ProofOptions
from .proof import StarkProof, DeepValues
from .trace_table import TraceTable
from .trace_state import TraceState
from .prover import prove
from .verifier import verify

__all__ = ["ProofOptions", "StarkProof", "DeepValues", "TraceTable", "TraceState", "prove", "verify"]
