"""The VM in pure Python: walks the program block tree, producing register
traces (reference src/processor/mod.rs).

The port's counterpart of distaff_tpu/processor/, kept for the same use: a
VM that needs no compiler.  `execute` gives what the JAX function gives
(register lists of Python ints, the context and loop depths); `execute_u64`
gives the (R, n, 2) uint64 words of `native.execute_u64`, the layout that
stark.TraceTable takes, so that

    trace = TraceTable(*processor.execute_u64(program, inputs), extension)
    proof = stark.prove(trace, public_inputs, outputs, options, device)

proves what distaff_torch.execute proves after its native VM step: the
counterpart of distaff_tpu.execute's branch without the native library.
distaff_torch.execute itself always runs the native VM, which is over ten
times faster and raises where it fails to build (native.py).
"""

import numpy as np

from ..config import MIN_TRACE_LENGTH, HACC_NUM_ROUNDS
from ..programs import Span, Group, Switch, Loop
from ..programs.opcodes import OpCode, OpHint
from .decoder import Decoder
from .stack import Stack


def execute(program, inputs):
    """Execute `program` with `inputs` -> (register_traces, ctx_depth, loop_depth).

    Register traces are lists of Python ints, one list per register, padded to
    a power-of-2 length; layout: decoder registers then user-stack registers.
    """
    decoder = Decoder(MIN_TRACE_LENGTH)
    stack = Stack(inputs, MIN_TRACE_LENGTH)

    _execute_blocks(program.root.body, decoder, stack)
    _close_block(decoder, stack, 0, True)

    decoder.finalize_trace()
    stack.finalize_trace()

    context_depth = decoder.max_ctx_stack_depth()
    loop_depth = decoder.max_loop_stack_depth()

    register_traces = decoder.into_register_traces()
    register_traces.extend(stack.into_register_traces())
    return register_traces, context_depth, loop_depth


def execute_u64(program, inputs):
    """`execute` with the registers as native.execute_u64 returns them: an
    (R, n, 2) uint64 array of each value's little-endian 64-bit halves, then
    the context and loop depths."""
    registers, ctx_depth, loop_depth = execute(program, inputs)
    words = b"".join(v.to_bytes(16, "little") for register in registers for v in register)
    trace = np.frombuffer(words, dtype="<u8").astype(np.uint64)
    return trace.reshape(len(registers), len(registers[0]), 2), ctx_depth, loop_depth


def _execute_blocks(blocks, decoder, stack):
    first = blocks[0]
    assert isinstance(first, Span), "first block in a sequence must be a Span block"
    _execute_span(first, decoder, stack, True)

    for block in blocks[1:]:
        if isinstance(block, Span):
            _execute_span(block, decoder, stack, False)
        elif isinstance(block, Group):
            _start_block(decoder, stack)
            _execute_blocks(block.body, decoder, stack)
            _close_block(decoder, stack, 0, True)
        elif isinstance(block, Switch):
            _start_block(decoder, stack)
            condition = stack.get_stack_top()
            if condition == 0:
                _execute_blocks(block.f_branch, decoder, stack)
                _close_block(decoder, stack, block.true_branch_hash(), False)
            elif condition == 1:
                _execute_blocks(block.t_branch, decoder, stack)
                _close_block(decoder, stack, block.false_branch_hash(), True)
            else:
                raise AssertionError(
                    f"cannot select a branch based on a non-binary condition {condition}"
                )
        elif isinstance(block, Loop):
            condition = stack.get_stack_top()
            if condition == 0:
                _start_block(decoder, stack)
                _execute_blocks(block.skip, decoder, stack)
                _close_block(decoder, stack, block.body_hash(), False)
            elif condition == 1:
                _execute_loop(block, decoder, stack)
            else:
                raise AssertionError(
                    f"cannot enter loop based on a non-binary condition {condition}"
                )


def _execute_span(block, decoder, stack, is_first):
    # non-first spans get a NOOP pre-pad so instructions start on a multiple of 16
    if not is_first:
        decoder.decode_op(OpCode.Noop, 0)
        stack.execute(OpCode.Noop, OpHint.none())
    for i in range(block.length()):
        op_code, op_hint = block.get_op(i)
        decoder.decode_op(op_code, op_hint.op_value())
        stack.execute(op_code, op_hint)


def _start_block(decoder, stack):
    decoder.start_block()
    stack.execute(OpCode.Noop, OpHint.none())


def _close_block(decoder, stack, sibling_hash, is_true_branch):
    # pad with a NOOP to align, end the block, then 14 hacc NOOP rounds to
    # merge the block hash into the program hash (16 steps total)
    decoder.decode_op(OpCode.Noop, 0)
    stack.execute(OpCode.Noop, OpHint.none())
    decoder.end_block(sibling_hash, is_true_branch)
    stack.execute(OpCode.Noop, OpHint.none())
    for _ in range(HACC_NUM_ROUNDS):
        decoder.decode_op(OpCode.Noop, 0)
        stack.execute(OpCode.Noop, OpHint.none())


def _execute_loop(block, decoder, stack):
    decoder.start_loop(block.image())
    stack.execute(OpCode.Noop, OpHint.none())

    while True:
        _execute_blocks(block.body, decoder, stack)
        condition = stack.get_stack_top()
        if condition == 0:
            decoder.break_loop()
            stack.execute(OpCode.Noop, OpHint.none())
            break
        elif condition == 1:
            decoder.wrap_loop()
            stack.execute(OpCode.Noop, OpHint.none())
        else:
            raise AssertionError(
                f"cannot exit loop based on a non-binary condition {condition}"
            )

    skip = block.skip[0]
    _execute_span(skip, decoder, stack, True)
    _close_block(decoder, stack, block.skip_hash(), True)
