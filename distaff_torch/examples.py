"""Example programs (reference src/examples/): each returns
(program, inputs, num_outputs, expected_result)."""

from .math import field
from .programs import ProgramInputs
from .programs import assembly
from .utils import hasher, rand


def fibonacci(n=6):
    """Compute the n-th Fibonacci term (reference examples/fibonacci.rs)."""
    program = assembly.compile(
        f"begin repeat.{n - 1} swap dup.2 drop add end end")
    inputs = ProgramInputs.from_public([1, 0])
    n1, n2 = 0, 1
    for _ in range(n - 1):
        n1, n2 = n2, field.add(n1, n2)
    return program, inputs, 1, [n2]


def collatz(start=5):
    """Count Collatz steps from `start` (reference examples/collatz.rs)."""
    program = assembly.compile("""
    begin
        pad read dup push.1 ne
        while.true
            swap push.1 add swap dup isodd.128
            if.true
                push.3 mul push.1 add
            else
                push.2 div
            end
            dup push.1 ne
        end
        swap
    end""")
    inputs = ProgramInputs([], [start], [])
    value, steps = start, 0
    while value != 1:
        value = field.div(value, 2) if value % 2 == 0 else field.add(field.mul(value, 3), 1)
        steps += 1
    return program, inputs, 1, [steps]


def comparison(value=6):
    """Compare a secret value against 9, multiply or add accordingly, then
    check oddness (reference examples/comparison.rs)."""
    program = assembly.compile("""
    begin
        push.9
        read
        dup.2
        lt.128
        if.true
            mul
        else
            add
        end
        dup
        isodd.128
    end""")
    expected = field.mul(9, value) if value < 9 else field.add(9, value)
    inputs = ProgramInputs([], [value], [])
    return program, inputs, 2, [expected & 1, expected]


def conditional(flag=1, a=13, b=29):
    """If/else branch selection (reference examples/conditional.rs)."""
    program = assembly.compile("""
    begin
        read if.true add else mul end
    end""")
    inputs = ProgramInputs([a, b], [flag], [])
    expected = field.add(a, b) if flag == 1 else field.mul(a, b)
    return program, inputs, 1, [expected]


def range_check(value=42, bits=63):
    """Check that a value fits in `bits` bits (reference examples/range.rs)."""
    program = assembly.compile(f"begin read rc.{bits} end")
    inputs = ProgramInputs([], [value], [])
    expected = 1 if value < (1 << bits) else 0
    return program, inputs, 1, [expected]


def merkle(depth=4):
    """Verify a Merkle authentication path twice - with smpath (index from
    the input tapes) and pmpath (index from the stack) - for a
    pseudo-randomly generated path (reference examples/merkle.rs)."""
    assert depth >= 2, "tree depth must be at least 2"
    s1 = bytes([1, 2, 3] + [0] * 29)
    s2 = bytes([4, 5, 6] + [0] * 29)
    leaves = 1 << (depth - 1)
    leaf_index = rand.prng(s1, field.M) % leaves
    path = [rand.prng_vector(s1, depth, field.M), rand.prng_vector(s2, depth, field.M)]

    expected = _compute_merkle_root(path, leaf_index, depth)

    program = assembly.compile(f"""
    begin
        read.ab
        dup.2
        smpath.{depth}
        swap.2
        push.{leaf_index}
        roll.4 swap swap.2
        pmpath.{depth}
    end""")

    # build input tapes (reference merkle.rs generate_program_inputs)
    a, b = [path[0][0]], [path[1][0]]
    index = leaf_index + (1 << (depth - 1))
    for i in range(1, depth):
        a.append(0)
        b.append(index & 1)
        index >>= 1
        a.append(path[0][i])
        b.append(path[1][i])
    for i in range(1, depth):
        a.append(path[0][i])
        b.append(path[1][i])

    inputs = ProgramInputs([], a, b)
    result = list(expected) + [expected[0], expected[1]]
    result.reverse()
    return program, inputs, 4, result


def _compute_merkle_root(path, index, n):
    r = index & 1
    buf = [path[0][r], path[1][r], path[0][1 - r], path[1][1 - r]]
    v = hasher.digest(buf)
    index = (index + (1 << (n - 1))) >> 1
    for i in range(2, n):
        if index & 1 == 0:
            buf = [v[0], v[1], path[0][i], path[1][i]]
        else:
            buf = [path[0][i], path[1][i], v[0], v[1]]
        v = hasher.digest(buf)
        index >>= 1
    return v


EXAMPLES = {
    "fibonacci": fibonacci,
    "collatz": collatz,
    "comparison": comparison,
    "conditional": conditional,
    "rangecheck": range_check,
    "merkle": merkle,
}
