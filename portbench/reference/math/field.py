"""Host-side scalar arithmetic in the 128-bit prime field M = 2^128 - 45*2^40 + 1.

Python integers are arbitrary precision, so scalar field math is plain modular
arithmetic here.  This module is the *oracle* and host-side implementation
(verifier, transcript, small polynomials); the device-side limb implementation
lives in distaff_torch.math.field_torch and is tested against this one.

Semantics match the reference field (reference src/math/field.rs), including
its quirks: exp(0, 0) == 0 and inv(0) == 0.
"""

# field modulus: 2^128 - 45 * 2^40 + 1
M = 340282366920938463463374557953744961537

# 2^40-th root of unity
G = 23953097886125630542083529559205016746

MODULUS = M
ZERO = 0
ONE = 1


def add(a, b):
    c = a + b
    return c - M if c >= M else c


def sub(a, b):
    return a - b if a >= b else M - b + a


def mul(a, b):
    return (a * b) % M


def mul_acc(a, b, c):
    """a[i] = a[i] + b[i] * c for all i (in place on list a)."""
    for i in range(len(a)):
        a[i] = (a[i] + b[i] * c) % M


def inv(x):
    # pow(0, M-2, M) == 0, matching the reference convention inv(0) == 0
    return pow(x, M - 2, M)


def inv_many(values):
    """Batch inversion (Montgomery's trick), skipping zeros like the reference."""
    n = len(values)
    result = [0] * n
    last = 1
    for i in range(n):
        result[i] = last
        if values[i] != 0:
            last = (last * values[i]) % M
    last = inv(last)
    for i in range(n - 1, -1, -1):
        if values[i] == 0:
            result[i] = 0
        else:
            result[i] = (last * result[i]) % M
            last = (last * values[i]) % M
    return result


def div(a, b):
    return (a * inv(b)) % M


def exp(b, p):
    # reference convention: exp(0, p) == 0 for every p, including p == 0
    if b == 0:
        return 0
    return pow(b, p, M)


def neg(x):
    return (M - x) % M


def get_root_of_unity(order):
    assert order != 0, "cannot get root of unity for order 0"
    assert order & (order - 1) == 0, "order must be a power of 2"
    log2 = order.bit_length() - 1
    assert log2 <= 40, "order cannot exceed 2^40"
    return pow(G, 1 << (40 - log2), M)


def get_power_series(b, length):
    result = [1] * length
    for i in range(1, length):
        result[i] = (result[i - 1] * b) % M
    return result


def from_bytes(b):
    return int.from_bytes(b, "little")


def to_bytes(x):
    return int(x).to_bytes(16, "little")


def elements_to_bytes(values):
    """Serialize a sequence of field elements as little-endian u128s."""
    return b"".join(int(v).to_bytes(16, "little") for v in values)


def elements_from_bytes(data):
    assert len(data) % 16 == 0
    return [int.from_bytes(data[i : i + 16], "little") for i in range(0, len(data), 16)]
