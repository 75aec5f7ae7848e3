"""Program hashing: Merkle-like folding of the block tree into the op-sponge.

Mirrors reference src/programs/hashing.rs and the spec in docs/programs.md:
- hash_op: one op-injecting sponge round per instruction
- hash_acc: merge a control block's (v0, v1) hash into the parent's state via
  14 NOOP rounds over [parent, v0, v1, 0] starting at round offset 1
- hash_seq: fold a block sequence, with 16-alignment suffixes
"""

from ..utils import sponge
from ..config import BASE_CYCLE_LENGTH, SPONGE_WIDTH, HACC_NUM_ROUNDS
from .opcodes import OpCode

HACC_ROUND_OFFSET = 1
NOOP_VALUE = int(OpCode.Noop)


def hash_seq(blocks, suffix, suffix_offset):
    from .blocks import Span  # local import to avoid cycle

    state = [0] * SPONGE_WIDTH

    first = blocks[0]
    assert isinstance(first, Span), "first block in a sequence must be a Span block"
    state = first.hash(state)

    for block in blocks[1:]:
        if isinstance(block, Span):
            # extra NOOP round for 16-cycle alignment, then fold the span
            hash_op(state, NOOP_VALUE, 0, BASE_CYCLE_LENGTH - 1)
            state = block.hash(state)
        else:
            v0, v1 = block.get_hash()
            state = hash_acc(state[0], v0, v1)

    for i, op in enumerate(suffix):
        hash_op(state, int(op), 0, suffix_offset + i)

    return state[0]


def hash_op(state, op_code, op_value, step):
    sponge.apply_round(state, op_code, op_value, step)


def hash_acc(parent_hash, v0, v1):
    state = [parent_hash, v0, v1, 0]
    for i in range(HACC_NUM_ROUNDS):
        hash_op(state, NOOP_VALUE, 0, HACC_ROUND_OFFSET + i)
    return state
