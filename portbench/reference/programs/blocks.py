"""Program block IR: Span, Group, Switch, Loop (reference src/programs/blocks/mod.rs).

A program is a tree of blocks; Span blocks hold straight-line instruction
sequences of length 16k-1, control blocks nest sequences that always start
with a Span.  Hashing rules live in distaff_torch.programs.hashing.
"""

from ..config import BASE_CYCLE_LENGTH
from .opcodes import OpCode, OpHint
from . import hashing


BLOCK_SUFFIX = [OpCode.Noop]
BLOCK_SUFFIX_OFFSET = BASE_CYCLE_LENGTH - 1

LOOP_SKIP_BLOCK = [OpCode.Not, OpCode.Assert] + [OpCode.Noop] * 13
LOOP_BLOCK_SUFFIX = [OpCode.Not, OpCode.Assert] + [OpCode.Noop] * 14


class Span:
    def __init__(self, instructions, hints=None):
        hints = dict(hints or {})
        alignment = len(instructions) % BASE_CYCLE_LENGTH
        assert alignment == BASE_CYCLE_LENGTH - 1, (
            f"invalid number of instructions: expected one less than a multiple of "
            f"{BASE_CYCLE_LENGTH}, but was {len(instructions)}"
        )
        for i, op in enumerate(instructions):
            if op == OpCode.Push:
                assert i % 8 == 0, f"PUSH is not allowed on step {i}, must be on a multiple of 8"
                hint = hints.get(i)
                assert hint is not None and hint.kind == "push", (
                    f"invalid PUSH operation on step {i}: operation value is missing"
                )
        for step in hints:
            assert step < len(instructions), "hint out of bounds"
        self.op_codes = list(instructions)
        self.op_hints = hints

    def length(self):
        return len(self.op_codes)

    def starts_with(self, instructions):
        return self.op_codes[: len(instructions)] == list(instructions)

    def get_op(self, step):
        return self.op_codes[step], self.get_hint(step)

    def get_hint(self, step):
        return self.op_hints.get(step, OpHint.none())

    def hash(self, state):
        """Fold every instruction of this span into the 4-wide sponge."""
        values = []
        for i, op in enumerate(self.op_codes):
            if op == OpCode.Push:
                hint = self.get_hint(i)
                assert hint.kind == "push", "value for PUSH operation is missing"
                values.append(hint.value)
            else:
                values.append(0)

        state = list(state)
        for step, (op, value) in enumerate(zip(self.op_codes, values)):
            hashing.hash_op(state, int(op), value, step)
        return state

    @staticmethod
    def merge(span1, span2):
        """Concatenate two spans with a NOOP separator (for repeat unrolling)."""
        ops = span1.op_codes + [OpCode.Noop] + span2.op_codes
        offset = span1.length() + 1
        hints = dict(span1.op_hints)
        for step, hint in span2.op_hints.items():
            hints[step + offset] = hint
        return Span(ops, hints)

    def __repr__(self):
        return " ".join(f"{op.mnemonic()}{self.get_hint(i)!r}" for i, op in enumerate(self.op_codes))


class Group:
    def __init__(self, body):
        validate_block_list(body, [])
        self.body = body

    def body_hash(self):
        return hashing.hash_seq(self.body, BLOCK_SUFFIX, BLOCK_SUFFIX_OFFSET)

    def get_hash(self):
        return (self.body_hash(), 0)

    def __repr__(self):
        return "block " + " ".join(repr(b) for b in self.body) + " end"


class Switch:
    def __init__(self, true_branch, false_branch):
        validate_block_list(true_branch, [OpCode.Assert])
        validate_block_list(false_branch, [OpCode.Not, OpCode.Assert])
        self.t_branch = true_branch
        self.f_branch = false_branch

    def true_branch_hash(self):
        return hashing.hash_seq(self.t_branch, BLOCK_SUFFIX, BLOCK_SUFFIX_OFFSET)

    def false_branch_hash(self):
        return hashing.hash_seq(self.f_branch, BLOCK_SUFFIX, BLOCK_SUFFIX_OFFSET)

    def get_hash(self):
        return (self.true_branch_hash(), self.false_branch_hash())

    def __repr__(self):
        return (
            "if " + " ".join(repr(b) for b in self.t_branch)
            + " else " + " ".join(repr(b) for b in self.f_branch) + " end"
        )


class Loop:
    def __init__(self, body):
        validate_block_list(body, [OpCode.Assert])
        self.body = body
        self.skip = [Span(LOOP_SKIP_BLOCK)]

    def image(self):
        return hashing.hash_seq(self.body, [], 0)

    def body_hash(self):
        return hashing.hash_seq(self.body, LOOP_BLOCK_SUFFIX, 0)

    def skip_hash(self):
        return hashing.hash_seq(self.skip, BLOCK_SUFFIX, BLOCK_SUFFIX_OFFSET)

    def get_hash(self):
        return (self.body_hash(), self.skip_hash())

    def __repr__(self):
        return "while " + " ".join(repr(b) for b in self.body) + " end"


def validate_block_list(blocks, starts_with):
    assert len(blocks) > 0, "a sequence of blocks must contain at least one block"
    first = blocks[0]
    assert isinstance(first, Span), "a sequence of blocks must start with a Span block"
    if starts_with:
        assert first.starts_with(starts_with), (
            "the first block does not start with a valid sequence of instructions"
        )
    was_span = True
    for block in blocks[1:]:
        if isinstance(block, Span):
            assert not was_span, "a Span block cannot be followed by another Span block"
        else:
            was_span = False
