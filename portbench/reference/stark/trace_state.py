"""A single trace-row view with lazy op-flag computation.

Values are polymorphic: Python ints (verifier, at the DEEP point z) or numpy
object-array columns (prover, the whole evaluation domain at once) - both go
through identical `(a * b) % M` arithmetic, so the AIR is written once.

Layout and flag algebra mirror reference src/stark/trace/trace_state.rs,
including the reference's ld_op_flags[2] term using cf_op_bits[1]
(trace_state.rs:301) which must be replicated for proof compatibility.
"""

from ..math.field import M
from ..config import (
    MIN_STACK_DEPTH, MIN_CONTEXT_DEPTH, MIN_LOOP_DEPTH,
    SPONGE_WIDTH, NUM_CF_OP_BITS, NUM_LD_OP_BITS, NUM_HD_OP_BITS,
    NUM_CF_OPS, NUM_LD_OPS, NUM_HD_OPS, PROGRAM_DIGEST_SIZE,
)
from ..programs.opcodes import OpCode

NUM_OP_BITS = NUM_CF_OP_BITS + NUM_LD_OP_BITS + NUM_HD_OP_BITS
NUM_STATIC_DECODER_REGISTERS = 1 + SPONGE_WIDTH + NUM_OP_BITS


def compute_decoder_width(ctx_depth, loop_depth):
    return NUM_STATIC_DECODER_REGISTERS + ctx_depth + loop_depth


class TraceState:
    def __init__(self, ctx_depth, loop_depth, stack_depth, zero=0):
        self.ctx_depth = ctx_depth
        self.loop_depth = loop_depth
        self.stack_depth = stack_depth
        self.op_counter = zero
        self.sponge = [zero] * SPONGE_WIDTH
        self.cf_op_bits = [zero] * NUM_CF_OP_BITS
        self.ld_op_bits = [zero] * NUM_LD_OP_BITS
        self.hd_op_bits = [zero] * NUM_HD_OP_BITS
        self.ctx_stack = [zero] * max(ctx_depth, MIN_CONTEXT_DEPTH)
        self.loop_stack = [zero] * max(loop_depth, MIN_LOOP_DEPTH)
        self.user_stack = [zero] * max(stack_depth, MIN_STACK_DEPTH)
        self._flags = None

    # construction --------------------------------------------------------------------------------

    @staticmethod
    def from_vec(ctx_depth, loop_depth, stack_depth, state):
        """Build from a flat register vector (no padding registers present)."""
        s = TraceState(ctx_depth, loop_depth, stack_depth)
        s.op_counter = state[0]
        s.sponge = list(state[1:5])
        s.cf_op_bits = list(state[5:8])
        s.ld_op_bits = list(state[8:13])
        s.hd_op_bits = list(state[13:15])
        ctx_end = 15 + ctx_depth
        loop_end = ctx_end + loop_depth
        s.ctx_stack[:ctx_depth] = state[15:ctx_end]
        s.loop_stack[:loop_depth] = state[ctx_end:loop_end]
        s.user_stack[:stack_depth] = state[loop_end : loop_end + stack_depth]
        return s

    def width(self):
        return 15 + self.ctx_depth + self.loop_depth + self.stack_depth

    def to_vec(self):
        return (
            [self.op_counter] + self.sponge + self.cf_op_bits + self.ld_op_bits
            + self.hd_op_bits + self.ctx_stack[: self.ctx_depth]
            + self.loop_stack[: self.loop_depth] + self.user_stack[: self.stack_depth]
        )

    def program_hash(self):
        return self.sponge[:PROGRAM_DIGEST_SIZE]

    def op_code(self):
        result = self.ld_op_bits[0]
        result = (result + self.ld_op_bits[1] * 2) % M
        result = (result + self.ld_op_bits[2] * 4) % M
        result = (result + self.ld_op_bits[3] * 8) % M
        result = (result + self.ld_op_bits[4] * 16) % M
        result = (result + self.hd_op_bits[0] * 32) % M
        result = (result + self.hd_op_bits[1] * 64) % M
        return result

    # op flags ------------------------------------------------------------------------------------

    def _compute_flags(self):
        mul = lambda a, b: (a * b) % M
        bnot = lambda v: (1 - v) % M

        cf = [0] * NUM_CF_OPS
        b = self.cf_op_bits
        not_0, not_1 = bnot(b[0]), bnot(b[1])
        cf[0] = mul(not_0, not_1)
        cf[1] = mul(b[0], not_1)
        cf[2] = mul(not_0, b[1])
        cf[3] = mul(b[0], b[1])
        cf[4:8] = cf[0:4]
        not_2 = bnot(b[2])
        for i in range(4):
            cf[i] = mul(cf[i], not_2)
        for i in range(4, 8):
            cf[i] = mul(cf[i], b[2])

        ld = [0] * NUM_LD_OPS
        lb = self.ld_op_bits
        not_0, not_1 = bnot(lb[0]), bnot(lb[1])
        ld[0] = mul(not_0, not_1)
        ld[1] = mul(lb[0], not_1)
        # NOTE: the reference multiplies by cf_op_bits[1] here (not ld bit 1);
        # replicated verbatim for constraint compatibility (trace_state.rs:301)
        ld[2] = mul(not_0, self.cf_op_bits[1])
        ld[3] = mul(lb[0], lb[1])
        ld[4:8] = ld[0:4]
        not_2 = bnot(lb[2])
        for i in range(4):
            ld[i] = mul(ld[i], not_2)
        for i in range(4, 8):
            ld[i] = mul(ld[i], lb[2])
        ld[8:16] = ld[0:8]
        not_3 = bnot(lb[3])
        for i in range(8):
            ld[i] = mul(ld[i], not_3)
        for i in range(8, 16):
            ld[i] = mul(ld[i], lb[3])
        ld[16:32] = ld[0:16]
        not_4 = bnot(lb[4])
        for i in range(16):
            ld[i] = mul(ld[i], not_4)
        for i in range(16, 32):
            ld[i] = mul(ld[i], lb[4])

        hd = [0] * NUM_HD_OPS
        hb = self.hd_op_bits
        not_0, not_1 = bnot(hb[0]), bnot(hb[1])
        hd[0] = mul(not_0, not_1)
        hd[1] = mul(hb[0], not_1)
        hd[2] = mul(not_0, hb[1])
        hd[3] = mul(hb[0], hb[1])

        begin_flag = mul(ld[OpCode.Begin.ld_index()], hd[OpCode.Begin.hd_index()])
        noop_flag = mul(ld[OpCode.Noop.ld_index()], hd[OpCode.Noop.hd_index()])

        # degree fix-ups so PUSH/ASSERT flags don't coincide with BEGIN
        hd[0] = mul(hd[0], lb[0])
        ld[0] = mul(ld[0], hb[0])

        self._flags = (cf, ld, hd, begin_flag, noop_flag)

    def cf_op_flags(self):
        if self._flags is None:
            self._compute_flags()
        return self._flags[0]

    def ld_op_flags(self):
        if self._flags is None:
            self._compute_flags()
        return self._flags[1]

    def hd_op_flags(self):
        if self._flags is None:
            self._compute_flags()
        return self._flags[2]

    def begin_flag(self):
        if self._flags is None:
            self._compute_flags()
        return self._flags[3]

    def noop_flag(self):
        if self._flags is None:
            self._compute_flags()
        return self._flags[4]
