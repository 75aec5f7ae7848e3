"""A plain stack machine for the assembly that the benchmark's programs use.

It gives a program's outputs from its text alone, as a second witness beside
the verifier: `begin ... end` and `repeat.n ... end` blocks, `push.x`,
`swap`, `dup`, `dup.2`, `dup.4`, `drop`, `add`, `mul` and `noop`, over
M = 2^128 - 45 * 2^40 + 1.  The stack's top is the first public input, and
below what a program has pushed it holds zeros, as Distaff's stack does.
"""

M = 340282366920938463463374557953744961537


def _dup(n):
    return lambda s: s[:n] + s


def _binary(f):
    return lambda s: [f(s[0], s[1]) % M] + s[2:]


OPS = {
    "noop": lambda s: s,
    "swap": lambda s: [s[1], s[0]] + s[2:],
    "dup": _dup(1),
    "dup.1": _dup(1),
    "dup.2": _dup(2),
    "dup.4": _dup(4),
    "drop": lambda s: s[1:],
    "add": _binary(lambda a, b: a + b),
    "mul": _binary(lambda a, b: a * b),
}


def run(source, public_inputs, num_outputs):
    """The top `num_outputs` stack values after running `source`."""
    tokens = source.split()
    if not tokens or tokens[0] != "begin":
        raise ValueError("a program starts with begin")
    stack, end = _block(tokens, 1, list(public_inputs) + [0] * 8)
    if end != len(tokens):
        raise ValueError("text after the program's end")
    return (stack + [0] * num_outputs)[:num_outputs]


def _block(tokens, i, stack):
    """Runs tokens[i:] up to their `end`; returns the stack and the index
    after that `end`."""
    while i < len(tokens):
        token = tokens[i]
        if token == "end":
            return stack, i + 1
        if token.startswith("repeat."):
            for _ in range(int(token[len("repeat."):])):
                stack, end = _block(tokens, i + 1, stack)
            i = end
            continue
        if token.startswith("push."):
            stack = [int(token[len("push."):], 0) % M] + stack
        elif token in OPS:
            stack = OPS[token](stack)
        else:
            raise ValueError(f"the plain stack machine has no {token!r}")
        stack = stack + [0] * max(0, 8 - len(stack))
        i += 1
    raise ValueError("a block without its end")
