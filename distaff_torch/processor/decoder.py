"""Decoder trace generator: sponge, op-bit, op-counter, ctx/loop stack registers.

Builds the decoder's register traces while the executor walks the block tree
(reference src/processor/decoder/mod.rs).  Register traces grow dynamically;
alignment invariants (block boundaries on 16-step cycles, PUSH on multiples
of 8) are asserted as ops are decoded.
"""

from ..utils import sponge
from ..config import (
    MAX_CONTEXT_DEPTH, MAX_LOOP_DEPTH,
    NUM_CF_OP_BITS, NUM_LD_OP_BITS, NUM_HD_OP_BITS,
    SPONGE_WIDTH, BASE_CYCLE_LENGTH, PUSH_OP_ALIGNMENT,
)
from ..programs.opcodes import FlowOps, OpCode


class Decoder:
    def __init__(self, init_trace_length):
        n = init_trace_length
        self.step = 0
        self.op_counter = [0] * n
        self.sponge_trace = [[0] * n for _ in range(SPONGE_WIDTH)]
        self.sponge = [0] * SPONGE_WIDTH
        self.cf_op_bits = [[0] * n for _ in range(NUM_CF_OP_BITS)]
        self.ld_op_bits = [[0] * n for _ in range(NUM_LD_OP_BITS)]
        self.hd_op_bits = [[0] * n for _ in range(NUM_HD_OP_BITS)]
        self.ctx_stack = [[0] * n]
        self.ctx_depth = 1
        self.loop_stack = []
        self.loop_depth = 0

    def trace_length(self):
        return len(self.op_counter)

    def max_ctx_stack_depth(self):
        # the outer-most context doesn't count: it is always 0
        return len(self.ctx_stack) - 1

    def max_loop_stack_depth(self):
        return len(self.loop_stack)

    def into_register_traces(self):
        registers = [self.op_counter]
        registers.extend(self.sponge_trace)
        registers.extend(self.cf_op_bits)
        registers.extend(self.ld_op_bits)
        registers.extend(self.hd_op_bits)
        registers.extend(self.ctx_stack[:-1])  # drop the always-zero outermost context
        registers.extend(self.loop_stack)
        return registers

    # operation decoders --------------------------------------------------------------------------

    def start_block(self):
        assert self.step % BASE_CYCLE_LENGTH == BASE_CYCLE_LENGTH - 1, (
            f"cannot start context block at step {self.step}: bad alignment"
        )
        self._advance_step(False)
        self._save_context()
        self._copy_loop_stack()
        self._set_op_bits(FlowOps.Begin, OpCode.Noop)
        self._set_sponge([0, 0, 0, 0])

    def end_block(self, sibling_hash, true_branch):
        assert self.step % BASE_CYCLE_LENGTH == 0, (
            f"cannot exit context block at step {self.step}: bad alignment"
        )
        self._advance_step(False)
        context_hash = self._pop_context()
        self._copy_loop_stack()
        block_hash = self.sponge[0]
        if true_branch:
            self._set_op_bits(FlowOps.Tend, OpCode.Noop)
            self._set_sponge([context_hash, block_hash, sibling_hash, 0])
        else:
            self._set_op_bits(FlowOps.Fend, OpCode.Noop)
            self._set_sponge([context_hash, sibling_hash, block_hash, 0])

    def start_loop(self, loop_image):
        assert self.step % BASE_CYCLE_LENGTH == BASE_CYCLE_LENGTH - 1, (
            f"cannot start a loop at step {self.step}: bad alignment"
        )
        self._advance_step(False)
        self._save_context()
        self._save_loop_image(loop_image)
        self._set_op_bits(FlowOps.Loop, OpCode.Noop)
        self._set_sponge([0, 0, 0, 0])

    def wrap_loop(self):
        assert self.step % BASE_CYCLE_LENGTH == BASE_CYCLE_LENGTH - 1, (
            f"cannot wrap a loop at step {self.step}: bad alignment"
        )
        self._advance_step(False)
        self._copy_context_stack()
        assert self.sponge[0] == self._peek_loop_image(), (
            f"cannot wrap a loop at step {self.step}: iteration hash does not match loop image"
        )
        self._set_op_bits(FlowOps.Wrap, OpCode.Noop)
        self._set_sponge([0, 0, 0, 0])

    def break_loop(self):
        assert self.step % BASE_CYCLE_LENGTH == BASE_CYCLE_LENGTH - 1, (
            f"cannot break a loop at step {self.step}: bad alignment"
        )
        self._advance_step(False)
        self._copy_context_stack()
        assert self.sponge[0] == self._pop_loop_image(), (
            f"cannot break a loop at step {self.step}: iteration hash does not match loop image"
        )
        self._set_op_bits(FlowOps.Break, OpCode.Noop)
        self._set_sponge(list(self.sponge))

    def decode_op(self, op_code, op_value):
        if op_value != 0:
            assert op_code == OpCode.Push, (
                f"invalid {op_code!r} at step {self.step}: op_value is non-zero"
            )
            assert self.step % PUSH_OP_ALIGNMENT == 0, (
                f"invalid PUSH operation alignment at step {self.step}"
            )
        self._advance_step(True)
        self._copy_context_stack()
        self._copy_loop_stack()
        self._set_op_bits(FlowOps.Hacc, op_code)
        self._apply_hacc_round(op_code, op_value)

    def finalize_trace(self):
        last_op_count = self.op_counter[self.step]
        _fill_register(self.op_counter, self.step + 1, last_op_count)
        for register in self.cf_op_bits:
            _fill_register(register, self.step, 1)
        for register in self.ld_op_bits:
            _fill_register(register, self.step, 1)
        for register in self.hd_op_bits:
            _fill_register(register, self.step, 1)
        for register in self.sponge_trace:
            _fill_register(register, self.step + 1, register[self.step])
        for register in self.ctx_stack:
            _fill_register(register, self.step + 1, register[self.step])
        for register in self.loop_stack:
            _fill_register(register, self.step + 1, register[self.step])
        self.step = self.trace_length() - 1

    # helpers -------------------------------------------------------------------------------------

    def _advance_step(self, is_user_op):
        self.step += 1
        if self.step >= self.trace_length():
            new_length = self.trace_length() * 2
            for register in (
                [self.op_counter] + self.sponge_trace + self.cf_op_bits
                + self.ld_op_bits + self.hd_op_bits + self.ctx_stack + self.loop_stack
            ):
                register.extend([0] * (new_length - len(register)))
        if is_user_op:
            self.op_counter[self.step] = self.op_counter[self.step - 1] + 1
        else:
            self.op_counter[self.step] = self.op_counter[self.step - 1]

    def _set_op_bits(self, flow_op, user_op):
        # op bits are always populated for the previous step
        step = self.step - 1
        f = int(flow_op)
        for i in range(NUM_CF_OP_BITS):
            self.cf_op_bits[i][step] = (f >> i) & 1
        u = int(user_op)
        for i in range(NUM_LD_OP_BITS):
            self.ld_op_bits[i][step] = (u >> i) & 1
        for i in range(NUM_HD_OP_BITS):
            self.hd_op_bits[i][step] = (u >> (i + NUM_LD_OP_BITS)) & 1

    def _save_context(self):
        self.ctx_depth += 1
        assert self.ctx_depth <= MAX_CONTEXT_DEPTH, f"context stack overflow at step {self.step}"
        if self.ctx_depth > len(self.ctx_stack):
            self.ctx_stack.append([0] * self.trace_length())
        for i in range(len(self.ctx_stack) - 1, 0, -1):
            self.ctx_stack[i][self.step] = self.ctx_stack[i - 1][self.step - 1]
        self.ctx_stack[0][self.step] = self.sponge[0]

    def _pop_context(self):
        assert self.ctx_depth > 0, f"context stack underflow at step {self.step}"
        for i in range(1, len(self.ctx_stack)):
            self.ctx_stack[i - 1][self.step] = self.ctx_stack[i][self.step - 1]
        self.ctx_depth -= 1
        return self.ctx_stack[0][self.step - 1]

    def _copy_context_stack(self):
        for register in self.ctx_stack:
            register[self.step] = register[self.step - 1]

    def _save_loop_image(self, loop_image):
        self.loop_depth += 1
        assert self.loop_depth <= MAX_LOOP_DEPTH, f"loop stack overflow at step {self.step}"
        if self.loop_depth > len(self.loop_stack):
            self.loop_stack.append([0] * self.trace_length())
        for i in range(len(self.loop_stack) - 1, 0, -1):
            self.loop_stack[i][self.step] = self.loop_stack[i - 1][self.step - 1]
        self.loop_stack[0][self.step] = loop_image

    def _peek_loop_image(self):
        assert self.loop_depth > 0, f"loop stack underflow at step {self.step}"
        for register in self.loop_stack:
            register[self.step] = register[self.step - 1]
        return self.loop_stack[0][self.step]

    def _pop_loop_image(self):
        assert self.loop_depth > 0, f"loop stack underflow at step {self.step}"
        for i in range(1, len(self.loop_stack)):
            self.loop_stack[i - 1][self.step] = self.loop_stack[i][self.step - 1]
        self.loop_depth -= 1
        return self.loop_stack[0][self.step - 1]

    def _copy_loop_stack(self):
        for register in self.loop_stack:
            register[self.step] = register[self.step - 1]

    def _set_sponge(self, state):
        self.sponge = list(state)
        for i in range(SPONGE_WIDTH):
            self.sponge_trace[i][self.step] = state[i]

    def _apply_hacc_round(self, op_code, op_value):
        sponge.apply_round(self.sponge, int(op_code), op_value, self.step - 1)
        for i in range(SPONGE_WIDTH):
            self.sponge_trace[i][self.step] = self.sponge[i]


def _fill_register(register, from_idx, value):
    register[from_idx:] = [value] * (len(register) - from_idx)
