"""VM opcode tables (reference src/processor/opcodes.rs).

Flow-control ops are 3-bit; user ops are 7-bit (2 high-degree bits + 5
low-degree bits).  Low-degree ops have hd bits = 11; the three high-degree
ops (Push/Cmp/RescR) have ld bits = 11111; Begin/Noop are the all-0 / all-1
composites.
"""

from enum import IntEnum


class FlowOps(IntEnum):
    Hacc = 0b000
    Begin = 0b001
    Tend = 0b010
    Fend = 0b011
    Loop = 0b100
    Wrap = 0b101
    Break = 0b110
    Void = 0b111

    def op_index(self):
        return int(self) & 0b111


class OpCode(IntEnum):
    # low-degree operations (hd bits = 11)
    Assert = 0b0_11_00000
    AssertEq = 0b0_11_00001
    Eq = 0b0_11_00010
    Drop = 0b0_11_00011
    Drop4 = 0b0_11_00100
    Choose = 0b0_11_00101
    Choose2 = 0b0_11_00110
    CSwap2 = 0b0_11_00111

    Add = 0b0_11_01000
    Mul = 0b0_11_01001
    And = 0b0_11_01010
    Or = 0b0_11_01011
    Inv = 0b0_11_01100
    Neg = 0b0_11_01101
    Not = 0b0_11_01110

    Read = 0b0_11_10000
    Read2 = 0b0_11_10001
    Dup = 0b0_11_10010
    Dup2 = 0b0_11_10011
    Dup4 = 0b0_11_10100
    Pad2 = 0b0_11_10101

    Swap = 0b0_11_11000
    Swap2 = 0b0_11_11001
    Swap4 = 0b0_11_11010
    Roll4 = 0b0_11_11011
    Roll8 = 0b0_11_11100
    BinAcc = 0b0_11_11101

    # high-degree operations (ld bits = 11111)
    Push = 0b0_00_11111
    Cmp = 0b0_01_11111
    RescR = 0b0_10_11111

    # composite operations
    Begin = 0b0_00_00000
    Noop = 0b0_11_11111

    def ld_index(self):
        if self in (OpCode.Push, OpCode.Cmp, OpCode.RescR):
            raise ValueError(f"{self.mnemonic()} is not a low-degree operation")
        return int(self) & 0b11111

    def hd_index(self):
        if self in (OpCode.Push, OpCode.Cmp, OpCode.RescR, OpCode.Noop, OpCode.Begin):
            return (int(self) >> 5) & 0b11
        raise ValueError(f"{self.mnemonic()} is not a high-degree operation")

    def mnemonic(self):
        return _MNEMONICS[self]


_MNEMONICS = {
    OpCode.Begin: "begin", OpCode.Noop: "noop",
    OpCode.Assert: "assert", OpCode.AssertEq: "asserteq",
    OpCode.Push: "push", OpCode.Read: "read", OpCode.Read2: "read2",
    OpCode.Dup: "dup", OpCode.Dup2: "dup2", OpCode.Dup4: "dup4", OpCode.Pad2: "pad2",
    OpCode.Drop: "drop", OpCode.Drop4: "drop4",
    OpCode.Swap: "swap", OpCode.Swap2: "swap2", OpCode.Swap4: "swap4",
    OpCode.Roll4: "roll4", OpCode.Roll8: "roll8",
    OpCode.Choose: "choose", OpCode.Choose2: "choose2", OpCode.CSwap2: "cswap2",
    OpCode.Add: "add", OpCode.Mul: "mul", OpCode.Inv: "inv", OpCode.Neg: "neg",
    OpCode.Not: "not", OpCode.And: "and", OpCode.Or: "or",
    OpCode.Eq: "eq", OpCode.Cmp: "cmp", OpCode.BinAcc: "binacc",
    OpCode.RescR: "rescr",
}


class OpHint:
    """Non-deterministic execution hints attached to span steps."""

    __slots__ = ("kind", "value")

    NONE = None  # set below

    def __init__(self, kind, value=0):
        self.kind = kind  # 'none' | 'eq_start' | 'rc_start' | 'cmp_start' | 'pmpath_start' | 'push'
        self.value = value

    def op_value(self):
        return self.value if self.kind == "push" else 0

    def __repr__(self):
        if self.kind == "eq_start":
            return "::eq"
        if self.kind in ("rc_start", "cmp_start", "pmpath_start"):
            return f".{self.value}"
        if self.kind == "push":
            return f"({self.value})"
        return ""

    @staticmethod
    def none():
        return OpHint.NONE

    @staticmethod
    def eq_start():
        return OpHint("eq_start")

    @staticmethod
    def rc_start(n):
        return OpHint("rc_start", n)

    @staticmethod
    def cmp_start(n):
        return OpHint("cmp_start", n)

    @staticmethod
    def pmpath_start(n):
        return OpHint("pmpath_start", n)

    @staticmethod
    def push_value(v):
        return OpHint("push", v)


OpHint.NONE = OpHint("none")
