"""STARK proof object (reference src/stark/proof.rs)."""

from ..math import field
from ..crypto.merkle import BatchMerkleProof
from ..crypto import hashes


class DeepValues:
    def __init__(self, trace_at_z1, trace_at_z2):
        self.trace_at_z1 = trace_at_z1
        self.trace_at_z2 = trace_at_z2


class TraceInfo:
    def __init__(self, domain_depth, ctx_depth, loop_depth, stack_depth, op_count):
        self.domain_depth = domain_depth
        self.ctx_depth = ctx_depth
        self.loop_depth = loop_depth
        self.stack_depth = stack_depth
        self.op_count = op_count


class StarkProof:
    def __init__(self, trace_root, trace_proof, trace_evaluations, constraint_root,
                 constraint_proof, deep_values, degree_proof, pow_nonce,
                 op_count, ctx_depth, loop_depth, stack_depth, options):
        self.trace_root = trace_root
        self.trace_info = TraceInfo(
            trace_proof.depth, ctx_depth, loop_depth, stack_depth, op_count)
        self.trace_nodes = trace_proof.nodes
        self.trace_evaluations = trace_evaluations
        self.constraint_root = constraint_root
        self.constraint_proof_obj = constraint_proof
        self.deep_values = deep_values
        self.degree_proof = degree_proof
        self.pow_nonce = pow_nonce
        self.options = options

    def domain_size(self):
        return 2 ** self.trace_info.domain_depth

    def trace_length(self):
        return self.domain_size() // self.options.extension_factor()

    def ctx_depth(self):
        return self.trace_info.ctx_depth

    def loop_depth(self):
        return self.trace_info.loop_depth

    def stack_depth(self):
        return self.trace_info.stack_depth

    def op_count(self):
        return self.trace_info.op_count

    def constraint_seed(self):
        return self.constraint_root

    def trace_proof(self):
        """Reconstruct the trace batch proof by re-hashing the sent rows."""
        hash_fn = hashes.HASH_FUNCTIONS[self.options.hash_fn]
        values = [
            hash_fn(field.elements_to_bytes(row)) for row in self.trace_evaluations
        ]
        return BatchMerkleProof(values, self.trace_nodes, self.trace_info.domain_depth)

    def constraint_proof(self):
        return self.constraint_proof_obj

    def get_state_at_z1(self):
        from .trace_state import TraceState
        return TraceState.from_vec(
            self.ctx_depth(), self.loop_depth(), self.stack_depth(),
            self.deep_values.trace_at_z1)

    def get_state_at_z2(self):
        from .trace_state import TraceState
        return TraceState.from_vec(
            self.ctx_depth(), self.loop_depth(), self.stack_depth(),
            self.deep_values.trace_at_z2)
