"""PTX carry chains on the CPU, for the tests that check the port's inline
PTX (csrc/field128.cuh's multiply and squaring, csrc/leaf256.cuh's digit
fold): the instructions of one asm block of a csrc header, and an
interpreter of the u32 arithmetic they use (mov, setp.ne, selp, mul, mad
and madc on either half, add, addc, sub and subc, with the carry flag)."""

import re
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "distaff_torch" / "csrc"


def asm_block(header, signature):
    """The instructions of the first asm block after `signature` in
    csrc/<header>, and its operand expressions in order (%0, %1, ...)."""
    src = (CSRC / header).read_text()
    body = src[src.index(signature):]
    start = body.index("asm(")
    body = re.sub(r"//[^\n]*", "", body[start:body.index(");", start)])
    template, operands = body.split(":", 1)
    text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', template))
    text = text.replace("\\n", "\n").replace("\\t", " ")
    names = re.findall(r'"=?r"\(((?:[^()]|\([^()]*\))+)\)', operands)
    lines = [ln.strip() for ln in text.replace("{", "").replace("}", "").split(";")]
    return [ln for ln in lines if ln and not ln.startswith(".reg")], names


def run_ptx(instructions, operands):
    """Run u32 PTX arithmetic with the carry flag; operands maps %k to values."""
    mask = 0xFFFFFFFF
    regs, cf = {}, None

    def val(tok):
        if tok.startswith("%"):
            return operands[int(tok[1:])]
        if tok[0].isdigit():
            return int(tok.rstrip("U"), 0) & mask
        return regs[tok]

    for ins in instructions:
        op, args = ins.split(None, 1)
        dst, *src = [t.strip() for t in args.split(",")]
        parts = op.split(".")
        name, cc = parts[0], "cc" in parts
        carry_in = name in ("addc", "madc", "subc")
        if carry_in and cf is None:
            raise AssertionError(f"{ins}: reads the carry flag before any instruction sets it")
        c_in = cf if carry_in else 0
        if name in ("mov",):
            result = val(src[0])
        elif name == "setp":
            assert parts[1] == "ne"
            result = val(src[0]) != val(src[1])
        elif name == "selp":
            result = val(src[0]) if regs[src[2]] else val(src[1])
        elif name in ("mul", "mad", "madc"):
            prod = val(src[0]) * val(src[1])
            half = prod & mask if parts[1] == "lo" else prod >> 32
            total = half + (val(src[2]) if name != "mul" else 0) + c_in
            result = total & mask
            if cc:
                cf = total >> 32
        elif name in ("add", "addc"):
            total = val(src[0]) + val(src[1]) + c_in
            result = total & mask
            if cc:
                cf = total >> 32
        elif name in ("sub", "subc"):
            total = val(src[0]) - val(src[1]) - c_in
            result = total & mask
            if cc:
                cf = int(total < 0)
        else:
            raise AssertionError(f"instruction not modelled: {ins}")
        if dst.startswith("%"):
            operands[int(dst[1:])] = result
        else:
            regs[dst] = result
    return operands
