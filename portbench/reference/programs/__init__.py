"""Programs layer: block IR, program hashing, inputs, assembly compiler."""

from ..math import field
from ..config import PROGRAM_DIGEST_SIZE
from .opcodes import OpCode, OpHint, FlowOps
from .blocks import Span, Group, Switch, Loop
from .inputs import ProgramInputs
from . import hashing


class Program:
    """A compiled program: a Group root block plus its 32-byte hash
    (reference src/programs/mod.rs:32-63)."""

    def __init__(self, root: Group):
        first = root.body[0]
        assert isinstance(first, Span), "a program must start with a Span block"
        op_code, _ = first.get_op(0)
        assert op_code == OpCode.Begin, "a program must start with BEGIN operation"

        v0, v1 = root.get_hash()
        state = hashing.hash_acc(0, v0, v1)
        self.root = root
        self.hash = b"".join(field.to_bytes(state[i]) for i in range(PROGRAM_DIGEST_SIZE))

    def __repr__(self):
        body = repr(self.root)
        return body[6:]  # strip the leading "block " like the reference strips "begin "


__all__ = [
    "Program", "ProgramInputs", "Span", "Group", "Switch", "Loop",
    "OpCode", "OpHint", "FlowOps", "hashing",
]
