"""distaff_torch's pure-Python VM (distaff_torch/processor/) on the CPU:
register lists and depths against the JAX package's processor on the
programs of tests/test_processor.py and the six examples, its (R, n, 2)
words against the port's native VM, each opcode's step against the JAX
Stack from seeded states, and the golden case proved from its trace.
Exact equality throughout."""

import hashlib

import numpy as np
import pytest

from distaff_torch import assembly, examples, native, processor, ProgramInputs
from distaff_torch import stark
from distaff_torch.config import MAX_STACK_DEPTH, MIN_STACK_DEPTH
from distaff_torch.math import field
from distaff_torch.processor.stack import Stack
from distaff_torch.programs.opcodes import OpCode, OpHint
from distaff_torch.stark import TraceTable, serde
from test_torch_prove import GOLDEN_LEN, GOLDEN_SHA256, _golden_case

from distaff_tpu import examples as jax_examples
from distaff_tpu import processor as jax_processor
from distaff_tpu.processor.stack import Stack as JaxStack
from distaff_tpu.programs import ProgramInputs as JaxProgramInputs
from distaff_tpu.programs import assembly as jax_assembly
from distaff_tpu.programs.opcodes import OpCode as JaxOpCode
from distaff_tpu.programs.opcodes import OpHint as JaxOpHint

M = field.M
# tests/test_processor.py's programs and inputs (public, secret A, secret B)
PROGRAMS = [
    ("begin add push.5 mul push.7 end", ([1, 2], [], [])),
    ("begin add block push.5 mul push.7 end end", ([1, 2], [], [])),
    ("begin read if.true add push.3 else push.7 add push.8 end mul end", ([5, 3], [1], [])),
    ("begin read if.true add push.3 else push.7 add push.8 end mul end", ([5, 3], [0], [])),
    ("begin mul read while.true dup mul read end end", ([5, 3], [0], [])),
    ("begin mul read while.true dup mul read end end", ([5, 3], [1, 0], [])),
    ("begin mul read while.true dup mul read end end", ([5, 3], [1, 1, 1, 1, 1, 0], [])),
    ("begin push.5 push.3 gt.8 end", ([], [], [])),
    ("begin push.5 push.3 lt.8 end", ([], [], [])),
    ("begin push.3 push.5 hash.2 end", ([], [], [])),
]


@pytest.mark.parametrize("source,inputs", PROGRAMS)
def test_execute_matches_jax_processor(source, inputs):
    got = processor.execute(assembly.compile(source), ProgramInputs(*inputs))
    want = jax_processor.execute(jax_assembly.compile(source), JaxProgramInputs(*inputs))
    assert got == want


@pytest.mark.parametrize("name", list(examples.EXAMPLES))
def test_examples_match_jax_processor_and_native_vm(name):
    program, inputs, _, _ = examples.EXAMPLES[name]()
    jax_program, jax_inputs, _, _ = jax_examples.EXAMPLES[name]()
    registers, ctx, loop = processor.execute(program, inputs)
    assert (registers, ctx, loop) == jax_processor.execute(jax_program, jax_inputs)
    words, ctx_u64, loop_u64 = processor.execute_u64(program, inputs)
    native_words, native_ctx, native_loop = native.execute_u64(program, inputs)
    assert (ctx_u64, loop_u64) == (native_ctx, native_loop) == (ctx, loop)
    assert words.dtype == native_words.dtype == np.uint64
    assert np.array_equal(words, native_words)


@pytest.mark.parametrize("source,inputs", PROGRAMS[:4] + PROGRAMS[6:])
def test_execute_u64_matches_native_vm(source, inputs):
    program = assembly.compile(source)
    words, ctx, loop = processor.execute_u64(program, ProgramInputs(*inputs))
    native_words, native_ctx, native_loop = native.execute_u64(program, ProgramInputs(*inputs))
    assert (ctx, loop) == (native_ctx, native_loop)
    assert np.array_equal(words, native_words)


def test_golden_case_proved_from_the_processor_trace():
    """The processor's trace through TraceTable and stark.prove on the CPU
    gives the golden bytes (tests/test_determinism.py)."""
    program, inputs, options = _golden_case()
    trace = TraceTable(*processor.execute_u64(program, inputs), options.extension_factor())
    outputs = trace.get_last_state().user_stack[:1]
    proof = stark.prove(trace, inputs.get_public_inputs(), outputs, options, "cpu")
    blob = serde.serialize(proof)
    assert len(blob) == GOLDEN_LEN
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256


# ------------------------------------------------------------------------------------------------
# every opcode from seeded states
# ------------------------------------------------------------------------------------------------

def _state(op, depth, rng):
    """(public inputs, secret tapes A and B, pushes, {register: value}
    fix-ups at the step before op, hint as (kind, value)) for one
    execution of op from a random stack of `depth` values (top first) that
    meets op's preconditions."""
    def elem():
        return int.from_bytes(rng.bytes(16), "little") % M

    values = [elem() for _ in range(depth)]
    bits = [int(b) for b in rng.integers(0, 2, 8)]
    tape_a, tape_b = [elem() for _ in range(4)], [elem() for _ in range(4)]
    fix, hint = {}, ("none", 0)
    binary = int(rng.integers(0, 2))
    if op == OpCode.Assert:
        fix = {0: 1}
    elif op == OpCode.AssertEq:
        fix = {1: values[0]}
    elif op == OpCode.Push:
        hint = ("push", elem())
    elif op == OpCode.Choose:
        fix = {2: binary}
    elif op in (OpCode.Choose2, OpCode.CSwap2):
        fix = {4: binary}
    elif op == OpCode.Not:
        fix = {0: binary}
    elif op in (OpCode.And, OpCode.Or):
        fix = {0: binary, 1: int(rng.integers(0, 2))}
    elif op == OpCode.Eq:
        if binary:
            fix = {2: values[1]}
        else:
            fix = {0: field.inv(field.sub(values[1], values[2]))}
    elif op == OpCode.Cmp:
        power = 1 << int(rng.integers(0, 100))
        fix = {0: power, 4: 0, 5: int(rng.integers(0, 2))}
        tape_a, tape_b = bits[:4], bits[4:]
        if binary:
            hint = ("cmp_start", 8)
    elif op == OpCode.BinAcc:
        fix = {2: 1 << int(rng.integers(0, 100))}
        tape_a = bits
        if binary:
            hint = ("rc_start", 8)
    elif op == OpCode.Read and binary:
        hint = ("eq_start", 0)
    elif op == OpCode.Read2 and binary:
        hint = ("pmpath_start", 4)
        fix = {2: int(rng.integers(0, 8))}
    # values are the stack top first: the bottom 8 the public inputs, the rest pushed
    return values[-8:], tape_a, tape_b, values[-9::-1], fix, hint


PORT = (Stack, OpCode, OpHint, ProgramInputs)
JAX = (JaxStack, JaxOpCode, JaxOpHint, JaxProgramInputs)


def _run(package, op, public, tape_a, tape_b, pushes, fix, hint):
    """A package's Stack from the state of _state, after op."""
    stack_cls, op_cls, hint_cls, inputs_cls = package
    stack = stack_cls(inputs_cls(public, tape_a, tape_b), 16)
    for v in pushes:
        stack.execute(op_cls.Push, hint_cls("push", v))
    for register, value in fix.items():
        stack.registers[register][stack.step] = value
    stack.execute(op_cls(int(op)), hint_cls.none() if hint[0] == "none" else hint_cls(*hint))
    return stack


@pytest.mark.parametrize("op", list(OpCode), ids=lambda op: op.mnemonic())
def test_every_opcode_matches_jax_stack(op):
    """Each opcode from seeded states of depths MIN_STACK_DEPTH to 12 (10 up
    for CMP, whose first step reads register 9), the JAX package's Stack the
    oracle: registers, tapes and depths equal after the step, both hint
    kinds where the opcode takes one."""
    for seed in range(6):
        rng = np.random.default_rng(1000 * int(op) + seed)
        depth = MIN_STACK_DEPTH + 2 * int(rng.integers(1 if op == OpCode.Cmp else 0, 3))
        state = _state(op, depth, rng)
        got, want = _run(PORT, op, *state), _run(JAX, op, *state)
        assert got.registers == want.registers, (op, seed)
        assert (got.tape_a, got.tape_b) == (want.tape_a, want.tape_b)
        assert (got.depth, got.max_depth, got.step) == (want.depth, want.max_depth, want.step)
        assert got.depth <= MAX_STACK_DEPTH
