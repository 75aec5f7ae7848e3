"""Constraint evaluator: orchestrates the decoder + stack AIR and combines
evaluations into pseudo-random linear combinations
(reference src/stark/constraints/evaluator.rs).

Two evaluation modes share the same constraint code:
- scalar: single (current, next) TraceState pair at an arbitrary x
  (verifier, out-of-domain at z)
- columnar: TraceStates whose registers are numpy object-array columns over
  the whole evaluation domain at once (prover) - replacing the reference's
  per-step loop with vectorized sweeps.
"""

from ...math import field
from ...config import MAX_CONSTRAINT_DEGREE, PROGRAM_DIGEST_SIZE
from .. import utils as stark_utils
from .decoder_air import Decoder
from .stack_air import Stack

M = field.M


class Evaluator:
    def __init__(self, trace_length, extension_factor, ctx_depth, loop_depth,
                 stack_depth, trace_root, program_hash, op_count, inputs, outputs):
        self.decoder = Decoder(trace_length, extension_factor, ctx_depth, loop_depth)
        self.stack = Stack(trace_length, extension_factor, stack_depth)
        self.coefficients = stark_utils.ConstraintCoefficients(
            trace_root, ctx_depth, loop_depth, stack_depth)
        self.domain_size = trace_length * extension_factor
        self.extension_factor = extension_factor
        self.trace_length = trace_length

        t_constraint_degrees = (
            list(self.decoder.constraint_degrees) + list(self.stack.constraint_degrees)
        )
        self.t_constraint_num = len(t_constraint_degrees)
        self.t_degree_groups = group_transition_constraints(t_constraint_degrees, trace_length)

        self.ctx_depth = ctx_depth
        self.loop_depth = loop_depth
        self.stack_depth = stack_depth
        self.b_constraint_num = PROGRAM_DIGEST_SIZE + len(inputs) + len(outputs) + 1
        self.program_hash = list(program_hash)
        self.op_count = op_count
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.b_degree_adj = get_boundary_constraint_adjustment_degree(trace_length)

    @staticmethod
    def from_proof(proof, program_hash, inputs, outputs):
        phash = [
            field.from_bytes(program_hash[:16]),
            field.from_bytes(program_hash[16:]),
        ]
        return Evaluator(
            proof.trace_length(), proof.options.extension_factor(),
            proof.ctx_depth(), proof.loop_depth(), proof.stack_depth(),
            proof.trace_root, phash, proof.op_count(),
            inputs, outputs)

    def constraint_count(self):
        return self.t_constraint_num + self.b_constraint_num

    def get_x_at_last_step(self):
        root = field.get_root_of_unity(self.trace_length)
        return field.exp(root, self.trace_length - 1)

    # transition constraints ----------------------------------------------------------------------

    def evaluate_transition_at(self, current, next_state, x):
        """Scalar out-of-domain evaluation at x (verifier)."""
        evaluations = [0] * self.t_constraint_num
        d = _ResultView(evaluations, 0, self.decoder.constraint_count())
        s = _ResultView(evaluations, self.decoder.constraint_count(), self.t_constraint_num)
        self.decoder.evaluate_at(current, next_state, x, d)
        self.stack.evaluate_at(current, next_state, x, s)
        return self._combine_transition(evaluations, lambda p: field.exp(x, p))

    def _combine_transition(self, evaluations, xp_lookup):
        cc = self.coefficients.transition
        result = 0
        i = 0
        for incremental_degree, constraints in self.t_degree_groups:
            result_adj = 0
            for constraint_idx in constraints:
                evaluation = evaluations[constraint_idx]
                result = (result + evaluation * cc[i * 2]) % M
                result_adj = (result_adj + evaluation * cc[i * 2 + 1]) % M
                i += 1
            xp = xp_lookup(incremental_degree)
            result = (result + result_adj * xp) % M
        return result

    # boundary constraints ------------------------------------------------------------------------

    def evaluate_boundaries(self, current, xp):
        """Combined boundary constraints at the first/last step.

        `xp` is x^b_degree_adj (scalar or column).  Returns (i_result, f_result).
        """
        cc = self.coefficients.i_boundary
        i_result = 0
        adj = 0

        op_counter = current.op_counter
        i_result = (i_result + op_counter * cc.op_counter[0]) % M
        adj = (adj + op_counter * cc.op_counter[1]) % M

        for i, v in enumerate(current.sponge):
            i_result = (i_result + v * cc.sponge[i * 2]) % M
            adj = (adj + v * cc.sponge[i * 2 + 1]) % M

        cc_idx = 0
        for bits in (current.cf_op_bits, current.ld_op_bits, current.hd_op_bits):
            for v in bits:
                i_result = (i_result + v * cc.op_bits[cc_idx]) % M
                adj = (adj + v * cc.op_bits[cc_idx + 1]) % M
                cc_idx += 2

        for i, v in enumerate(current.ctx_stack):
            i_result = (i_result + v * cc.ctx_stack[i * 2]) % M
            adj = (adj + v * cc.ctx_stack[i * 2 + 1]) % M

        for i, v in enumerate(current.loop_stack):
            i_result = (i_result + v * cc.loop_stack[i * 2]) % M
            adj = (adj + v * cc.loop_stack[i * 2 + 1]) % M

        for i, inp in enumerate(self.inputs):
            val = (current.user_stack[i] - inp) % M
            i_result = (i_result + val * cc.user_stack[i * 2]) % M
            adj = (adj + val * cc.user_stack[i * 2 + 1]) % M

        i_result = (i_result + adj * xp) % M

        cc = self.coefficients.f_boundary
        f_result = 0
        adj = 0

        val = (current.op_counter - self.op_count) % M
        f_result = (f_result + val * cc.op_counter[0]) % M
        adj = (adj + val * cc.op_counter[1]) % M

        for i in range(len(self.program_hash)):
            val = (current.sponge[i] - self.program_hash[i]) % M
            f_result = (f_result + val * cc.sponge[i * 2]) % M
            adj = (adj + val * cc.sponge[i * 2 + 1]) % M

        cc_idx = 0
        for bits in (current.cf_op_bits, current.ld_op_bits, current.hd_op_bits):
            for v in bits:
                val = (v - 1) % M
                f_result = (f_result + val * cc.op_bits[cc_idx]) % M
                adj = (adj + val * cc.op_bits[cc_idx + 1]) % M
                cc_idx += 2

        for i, v in enumerate(current.ctx_stack):
            f_result = (f_result + v * cc.ctx_stack[i * 2]) % M
            adj = (adj + v * cc.ctx_stack[i * 2 + 1]) % M

        for i, v in enumerate(current.loop_stack):
            f_result = (f_result + v * cc.loop_stack[i * 2]) % M
            adj = (adj + v * cc.loop_stack[i * 2 + 1]) % M

        for i, out in enumerate(self.outputs):
            val = (current.user_stack[i] - out) % M
            f_result = (f_result + val * cc.user_stack[i * 2]) % M
            adj = (adj + val * cc.user_stack[i * 2 + 1]) % M

        f_result = (f_result + adj * xp) % M
        return i_result, f_result


class _ResultView:
    """Slice view with decoder_air.ResultSlice-compatible interface."""

    def __init__(self, values, start, end):
        self.values = values
        self.start = start
        self.end = end

    def __len__(self):
        return self.end - self.start

    def __getitem__(self, i):
        return self.values[self.start + i]

    def __setitem__(self, i, v):
        self.values[self.start + i] = v

    def slice(self, start, end):
        return _ResultView(self.values, self.start + start, self.start + end)


def group_transition_constraints(degrees, trace_length):
    groups = [[] for _ in range(9)]
    for i, degree in enumerate(degrees):
        groups[degree].append(i)
    target_degree = (MAX_CONSTRAINT_DEGREE - 1) * trace_length + trace_length - 1

    result = []
    for degree, constraints in enumerate(groups):
        if not constraints:
            continue
        constraint_degree = (trace_length - 1) * degree
        incremental_degree = target_degree - constraint_degree
        result.append((incremental_degree, list(constraints)))
    return result


def get_boundary_constraint_adjustment_degree(trace_length):
    target_degree = (MAX_CONSTRAINT_DEGREE - 1) * trace_length + 1
    return target_degree - (trace_length - 1)
