"""Assembly compiler: whitespace-token source -> Program block tree.

Grammar and macro expansions mirror the reference assembler
(reference src/programs/assembly/mod.rs, parsers.rs): blocks are
begin/block/if.true/else/repeat.n/while.true/end; macro instructions
(eq, gt.n, lt.n, rc.n, isodd.n, hash.n, smpath.n, pmpath.n, ...) lower to
multi-op sequences with non-deterministic input hints; spans are NOOP-padded
to length 16k-1; `repeat` is unrolled at compile time with span merging.
"""

from ..math import field
from ..config import BASE_CYCLE_LENGTH
from . import Program
from .opcodes import OpCode, OpHint
from .blocks import Span, Group, Switch, Loop

PUSH_OP_ALIGNMENT = 8
HASH_OP_ALIGNMENT = 16


class AssemblyError(Exception):
    def __init__(self, message, step):
        super().__init__(f"assembly error at {step}: {message}")
        self.message = message
        self.step = step


def compile(source: str) -> Program:
    tokens = source.split()
    if not tokens:
        raise AssemblyError("source code cannot be an empty string", 0)
    if tokens[0] != "begin":
        raise AssemblyError(f"a program must start with 'begin' but started with '{tokens[0]}'", 0)
    if tokens[-1] != "end":
        raise AssemblyError(f"a program must end with 'end' but ended with '{tokens[-1]}'", len(tokens) - 1)

    root_blocks = []
    i = _parse_branch(root_blocks, tokens, 0)
    root = Group(root_blocks)
    if i < len(tokens) - 1:
        raise AssemblyError("dangling instructions after program end", i)
    return Program(root)


# ------------------------------------------------------------------------------------------------
# block structure parsing
# ------------------------------------------------------------------------------------------------

def _parse_block(parent, tokens, i):
    head = tokens[i].split(".")

    if head[0] == "block":
        if len(head) > 1:
            raise AssemblyError(f"invalid block head '{tokens[i]}'", i)
        body = []
        i = _parse_branch(body, tokens, i)
        parent.append(Group(body))
        return i + 1

    if head[0] == "if":
        if len(head) == 1 or head[1] != "true":
            raise AssemblyError(f"invalid block head '{tokens[i]}'", i)
        t_branch = []
        i = _parse_branch(t_branch, tokens, i)
        f_branch = []
        if tokens[i] == "else":
            i = _parse_branch(f_branch, tokens, i)
        else:
            f_branch.append(Span([OpCode.Not, OpCode.Assert] + [OpCode.Noop] * 13))
        parent.append(Switch(t_branch, f_branch))
        return i + 1

    if head[0] == "repeat":
        num_iterations = _read_block_param(head, i)
        if num_iterations < 2:
            raise AssemblyError("number of iterations must be greater than 1", i)
        body_template = []
        i = _parse_branch(body_template, tokens, i)
        parent.append(Group(_repeat_block_sequence(body_template, num_iterations)))
        return i + 1

    if head[0] == "while":
        if len(head) == 1 or head[1] != "true":
            raise AssemblyError(f"invalid block head '{tokens[i]}'", i)
        body = []
        i = _parse_branch(body, tokens, i)
        parent.append(Loop(body))
        return i + 1

    raise AssemblyError(f"invalid block head '{tokens[i]}'", i)


def _parse_branch(body, tokens, i):
    head = tokens[i].split(".")
    if head[0] == "begin":
        head = ["block"] + head[1:]
        op_codes = [OpCode.Begin]
    elif head[0] == "block":
        op_codes = []
    elif head[0] == "if":
        op_codes = [OpCode.Assert]
    elif head[0] == "else":
        op_codes = [OpCode.Not, OpCode.Assert]
    elif head[0] == "repeat":
        op_codes = []
    elif head[0] == "while":
        op_codes = [OpCode.Assert]
    else:
        raise AssemblyError(f"invalid block head '{tokens[i]}'", i)

    op_hints = {}
    first_step = i
    i += 1
    while i < len(tokens):
        op = tokens[i].split(".")
        if op[0] in ("block", "if", "repeat", "while"):
            force_span = len(body) == 0
            _add_span(body, op_codes, op_hints, force_span)
            i = _parse_block(body, tokens, i)
        elif op[0] == "else":
            if head[0] != "if":
                raise AssemblyError("else without matching if", i)
            if i - first_step < 2:
                raise AssemblyError("a block must contain at least one instruction", first_step)
            _add_span(body, op_codes, op_hints, False)
            return i
        elif op[0] == "end":
            if i - first_step < 2:
                raise AssemblyError("a block must contain at least one instruction", first_step)
            _add_span(body, op_codes, op_hints, False)
            return i
        else:
            i = _parse_op_token(op, op_codes, op_hints, i)

    raise AssemblyError(f"unmatched '{tokens[first_step]}'", first_step)


def _add_span(body, op_codes, op_hints, force):
    if not op_codes and not force:
        return
    span_ops = list(op_codes)
    pad_length = BASE_CYCLE_LENGTH - (len(span_ops) % BASE_CYCLE_LENGTH) - 1
    span_ops.extend([OpCode.Noop] * pad_length)
    body.append(Span(span_ops, dict(op_hints)))
    op_codes.clear()
    op_hints.clear()


def _repeat_block_sequence(template, num_iterations):
    body = []
    if not isinstance(template[-1], Span):
        for _ in range(num_iterations):
            body.extend(template)
    elif len(template) == 1:
        # single-span loop: pairwise Span.merge would re-copy and re-validate
        # the accumulated span every iteration (quadratic); build the merged
        # op/hint lists in one pass instead - same result as folding merge
        span = template[0]
        ops = list(span.op_codes)
        hints = dict(span.op_hints)
        for _ in range(1, num_iterations):
            offset = len(ops) + 1
            ops.append(OpCode.Noop)
            ops.extend(span.op_codes)
            for step, hint in span.op_hints.items():
                hints[step + offset] = hint
        body.append(Span(ops, hints))
    else:
        body.extend(template)
        for _ in range(1, num_iterations):
            body[-1] = Span.merge(body[-1], template[0])
            body.extend(template[1:])
    return body


# ------------------------------------------------------------------------------------------------
# instruction parsing
# ------------------------------------------------------------------------------------------------

def _parse_op_token(op, op_codes, op_hints, step):
    name = op[0]
    handler = _OP_PARSERS.get(name)
    if handler is None:
        raise AssemblyError(f"invalid operation '{'.'.join(op)}'", step)
    handler(op_codes, op_hints, op, step)
    return step + 1


def _no_param(op, step):
    if len(op) > 1:
        raise AssemblyError(f"operation '{op[0]}' cannot have parameters", step)


def _read_param(op, step):
    """Optional numeric parameter, defaulting to 1; zero is invalid."""
    if len(op) == 1:
        return 1
    if len(op) > 2:
        raise AssemblyError(f"operation '{'.'.join(op)}' has too many parameters", step)
    try:
        result = int(op[1])
    except ValueError:
        raise AssemblyError(f"parameter '{op[1]}' is invalid", step)
    if result == 0:
        raise AssemblyError("parameter value must be greater than 0", step)
    return result


def _read_block_param(op, step):
    if len(op) < 2:
        raise AssemblyError("parameter is missing", step)
    if len(op) > 2:
        raise AssemblyError("too many parameters", step)
    try:
        return int(op[1])
    except ValueError:
        raise AssemblyError(f"parameter '{op[1]}' is invalid", step)


def _read_value(op, step):
    """PUSH value: decimal or 0x hex, must be a valid field element."""
    if len(op) == 1:
        raise AssemblyError("parameter is missing", step)
    if len(op) > 2:
        raise AssemblyError("too many parameters", step)
    try:
        if op[1].startswith("0x"):
            result = int(op[1][2:], 16)
        else:
            result = int(op[1], 10)
    except ValueError:
        raise AssemblyError(f"parameter '{op[1]}' is invalid", step)
    if result >= field.M:
        raise AssemblyError(f"parameter value must be smaller than {field.M}", step)
    return result


def _append_push_op(program, hints, value):
    # align PUSH to steps that are multiples of 8 by NOOP padding
    alignment = len(program) % PUSH_OP_ALIGNMENT
    pad = (PUSH_OP_ALIGNMENT - alignment) % PUSH_OP_ALIGNMENT
    program.extend([OpCode.Noop] * pad)
    hints[len(program)] = OpHint.push_value(value)
    program.append(OpCode.Push)


def _align_to_hash_cycle(program):
    alignment = len(program) % HASH_OP_ALIGNMENT
    pad = (HASH_OP_ALIGNMENT - alignment) % HASH_OP_ALIGNMENT
    program.extend([OpCode.Noop] * pad)


def _parse_noop(p, h, op, step):
    _no_param(op, step)
    p.append(OpCode.Noop)


def _parse_assert(p, h, op, step):
    if len(op) > 2:
        raise AssemblyError("too many parameters", step)
    if len(op) == 1:
        p.append(OpCode.Assert)
    elif op[1] == "eq":
        p.append(OpCode.AssertEq)
    else:
        raise AssemblyError(f"parameter {op[1]} is invalid; allowed values are: [eq]", step)


def _parse_push(p, h, op, step):
    _append_push_op(p, h, _read_value(op, step))


def _parse_read(p, h, op, step):
    if len(op) > 2:
        raise AssemblyError("too many parameters", step)
    if len(op) == 1 or op[1] == "a":
        p.append(OpCode.Read)
    elif op[1] == "ab":
        p.append(OpCode.Read2)
    else:
        raise AssemblyError(f"parameter {op[1]} is invalid; allowed values are: [a, ab]", step)


def _parse_dup(p, h, op, step):
    n = _read_param(op, step)
    seq = {
        1: [OpCode.Dup],
        2: [OpCode.Dup2],
        3: [OpCode.Dup4, OpCode.Roll4, OpCode.Drop],
        4: [OpCode.Dup4],
    }.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1, 2, 3, 4]", step)
    p.extend(seq)


def _parse_pad(p, h, op, step):
    n = _read_param(op, step)
    P2, D, D4 = OpCode.Pad2, OpCode.Drop, OpCode.Dup4
    seq = {
        1: [P2, D], 2: [P2], 3: [P2, P2, D], 4: [P2, P2],
        5: [P2, P2, P2, D], 6: [P2, P2, P2],
        7: [P2, P2, D4, D], 8: [P2, P2, D4],
    }.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1..8]", step)
    p.extend(seq)


def _parse_pick(p, h, op, step):
    n = _read_param(op, step)
    seq = {
        1: [OpCode.Dup2, OpCode.Drop],
        2: [OpCode.Dup4, OpCode.Roll4, OpCode.Drop, OpCode.Drop, OpCode.Drop],
        3: [OpCode.Dup4, OpCode.Drop, OpCode.Drop, OpCode.Drop],
    }.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1, 2, 3]", step)
    p.extend(seq)


def _parse_drop(p, h, op, step):
    n = _read_param(op, step)
    D, D4, U = OpCode.Drop, OpCode.Drop4, OpCode.Dup
    seq = {
        1: [D], 2: [D, D], 3: [U, D4], 4: [D4],
        5: [D, D4], 6: [D, D, D4], 7: [U, D4, D4], 8: [D4, D4],
    }.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1..8]", step)
    p.extend(seq)


def _parse_swap(p, h, op, step):
    n = _read_param(op, step)
    seq = {1: [OpCode.Swap], 2: [OpCode.Swap2], 4: [OpCode.Swap4]}.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1, 2, 4]", step)
    p.extend(seq)


def _parse_roll(p, h, op, step):
    n = _read_param(op, step)
    seq = {4: [OpCode.Roll4], 8: [OpCode.Roll8]}.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [4, 8]", step)
    p.extend(seq)


def _simple(opcode_list):
    def parser(p, h, op, step):
        _no_param(op, step)
        p.extend(opcode_list)
    return parser


def _parse_eq(p, h, op, step):
    _no_param(op, step)
    h[len(p)] = OpHint.eq_start()
    p.extend([OpCode.Read, OpCode.Eq])


def _parse_ne(p, h, op, step):
    _no_param(op, step)
    h[len(p)] = OpHint.eq_start()
    p.extend([OpCode.Read, OpCode.Eq, OpCode.Not])


def _comparison_param(op, step):
    n = _read_param(op, step)
    if n < 4 or n > 128:
        raise AssemblyError(f"parameter {n} is invalid; value must be between 4 and 128", step)
    return n


def _parse_gt(p, h, op, step):
    n = _comparison_param(op, step)
    p.extend([OpCode.Pad2, OpCode.Pad2, OpCode.Pad2, OpCode.Dup])
    _append_push_op(p, h, 1 << (n - 1))
    h[len(p)] = OpHint.cmp_start(n)
    p.extend([OpCode.Cmp] * n)
    p.extend([
        OpCode.Drop4, OpCode.Pad2, OpCode.Swap4, OpCode.Roll4,
        OpCode.AssertEq, OpCode.AssertEq, OpCode.Roll4, OpCode.Dup, OpCode.Drop4,
    ])


def _parse_lt(p, h, op, step):
    n = _comparison_param(op, step)
    p.extend([OpCode.Pad2, OpCode.Pad2, OpCode.Pad2, OpCode.Dup])
    _append_push_op(p, h, 1 << (n - 1))
    h[len(p)] = OpHint.cmp_start(n)
    p.extend([OpCode.Cmp] * n)
    p.extend([
        OpCode.Drop4, OpCode.Pad2, OpCode.Swap4, OpCode.Roll4,
        OpCode.AssertEq, OpCode.AssertEq, OpCode.Dup, OpCode.Drop4,
    ])


def _parse_rc(p, h, op, step):
    n = _comparison_param(op, step)
    p.append(OpCode.Pad2)
    _append_push_op(p, h, 1)
    p.extend([OpCode.Swap, OpCode.Dup])
    h[len(p)] = OpHint.rc_start(n)
    p.extend([OpCode.BinAcc] * n)
    p.extend([OpCode.Dup, OpCode.Drop4])
    h[len(p)] = OpHint.eq_start()
    p.extend([OpCode.Read, OpCode.Eq])


def _parse_isodd(p, h, op, step):
    n = _comparison_param(op, step)
    p.append(OpCode.Pad2)
    _append_push_op(p, h, 1)
    p.extend([OpCode.Swap, OpCode.Dup])
    h[len(p)] = OpHint.rc_start(n)
    p.extend([OpCode.BinAcc, OpCode.Swap2, OpCode.Roll4, OpCode.Dup])
    p.extend([OpCode.BinAcc] * (n - 1))
    p.extend([OpCode.Drop, OpCode.Drop, OpCode.Swap, OpCode.Roll4, OpCode.AssertEq, OpCode.Drop])


def _parse_choose(p, h, op, step):
    n = _read_param(op, step)
    seq = {1: [OpCode.Choose], 2: [OpCode.Choose2]}.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1, 2]", step)
    p.extend(seq)


def _parse_hash(p, h, op, step):
    n = _read_param(op, step)
    P2, D = OpCode.Pad2, OpCode.Drop
    seq = {1: [P2, P2, P2, D], 2: [P2, P2], 3: [P2, P2, D], 4: [P2]}.get(n)
    if seq is None:
        raise AssemblyError(f"parameter {n} is invalid; allowed values are: [1, 2, 3, 4]", step)
    p.extend(seq)
    _align_to_hash_cycle(p)
    p.extend([OpCode.RescR] * 10)
    p.append(OpCode.Drop4)


_SMPATH_SUB_CYCLE = (
    [OpCode.RescR] * 10
    + [OpCode.Drop4, OpCode.Read2, OpCode.Swap2, OpCode.Read2, OpCode.CSwap2, OpCode.Pad2]
)


def _parse_smpath(p, h, op, step):
    n = _read_param(op, step)
    if n < 2 or n > 256:
        raise AssemblyError(f"parameter {n} is invalid; value must be between 2 and 256", step)
    p.extend([OpCode.Read2, OpCode.Swap2, OpCode.Read2, OpCode.CSwap2, OpCode.Pad2])
    _align_to_hash_cycle(p)
    for _ in range(n - 2):
        p.extend(_SMPATH_SUB_CYCLE)
    p.extend(_SMPATH_SUB_CYCLE[:11])


_PMPATH_SUB_CYCLE = (
    [OpCode.RescR] * 10
    + [OpCode.Drop4, OpCode.Pad2, OpCode.Swap2, OpCode.Read2, OpCode.Swap4,
       OpCode.BinAcc, OpCode.Swap4, OpCode.CSwap2, OpCode.Pad2]
    + [OpCode.Noop] * 13
)


def _parse_pmpath(p, h, op, step):
    n = _read_param(op, step)
    if n < 2 or n > 256:
        raise AssemblyError(f"parameter {n} is invalid; value must be between 2 and 256", step)
    h[len(p)] = OpHint.pmpath_start(n)
    p.extend([OpCode.Read2, OpCode.Pad2])
    _append_push_op(p, h, 1)
    p.extend([OpCode.Swap, OpCode.Dup, OpCode.BinAcc, OpCode.Swap4, OpCode.CSwap2, OpCode.Pad2])
    _align_to_hash_cycle(p)
    for _ in range(n - 2):
        p.extend(_PMPATH_SUB_CYCLE)
    p.extend(_PMPATH_SUB_CYCLE[:11])
    p.extend([OpCode.Swap2, OpCode.Drop, OpCode.Roll4, OpCode.AssertEq])


_OP_PARSERS = {
    "noop": _parse_noop,
    "assert": _parse_assert,
    "push": _parse_push,
    "read": _parse_read,
    "dup": _parse_dup,
    "pad": _parse_pad,
    "pick": _parse_pick,
    "drop": _parse_drop,
    "swap": _parse_swap,
    "roll": _parse_roll,
    "add": _simple([OpCode.Add]),
    "sub": _simple([OpCode.Neg, OpCode.Add]),
    "mul": _simple([OpCode.Mul]),
    "div": _simple([OpCode.Inv, OpCode.Mul]),
    "neg": _simple([OpCode.Neg]),
    "inv": _simple([OpCode.Inv]),
    "not": _simple([OpCode.Not]),
    "and": _simple([OpCode.And]),
    "or": _simple([OpCode.Or]),
    "eq": _parse_eq,
    "ne": _parse_ne,
    "gt": _parse_gt,
    "lt": _parse_lt,
    "rc": _parse_rc,
    "isodd": _parse_isodd,
    "choose": _parse_choose,
    "hash": _parse_hash,
    "smpath": _parse_smpath,
    "pmpath": _parse_pmpath,
}
