"""Host-side degree-3 polynomial batch machinery for radix-4 FRI.

Mirrors reference src/math/quartic.rs semantics.  The verifier uses these on
~100 rows; the prover's domain-sized versions run on device
(distaff_torch.ops.fri_torch).
"""

from . import field

M = field.M


def eval(p, x):
    assert len(p) == 4
    x2 = (x * x) % M
    x3 = (x2 * x) % M
    return (p[0] + p[1] * x + p[2] * x2 + p[3] * x3) % M


def evaluate_batch(polys, x):
    return [eval(p, x) for p in polys]


def interpolate_batch(xs, ys):
    """Interpolate each (xs[i], ys[i]) 4-point set into a cubic, with batched
    inversion across the whole batch."""
    assert len(xs) == len(ys)
    n = len(xs)
    equations = []
    inverses = []
    for i in range(n):
        x0, x1, x2, x3 = xs[i]
        x01 = x0 * x1 % M
        x02 = x0 * x2 % M
        x03 = x0 * x3 % M
        x12 = x1 * x2 % M
        x13 = x1 * x3 % M
        x23 = x2 * x3 % M

        eq0 = [(-x12 * x3) % M, (x12 + x13 + x23) % M, (-x1 - x2 - x3) % M, 1]
        eq1 = [(-x02 * x3) % M, (x02 + x03 + x23) % M, (-x0 - x2 - x3) % M, 1]
        eq2 = [(-x01 * x3) % M, (x01 + x03 + x13) % M, (-x0 - x1 - x3) % M, 1]
        eq3 = [(-x01 * x2) % M, (x01 + x02 + x12) % M, (-x0 - x1 - x2) % M, 1]
        equations.extend([eq0, eq1, eq2, eq3])
        inverses.extend([eval(eq0, x0), eval(eq1, x1), eval(eq2, x2), eval(eq3, x3)])

    inverses = field.inv_many(inverses)

    result = []
    for i in range(n):
        acc = [0, 0, 0, 0]
        for k in range(4):
            inv_y = ys[i][k] * inverses[i * 4 + k] % M
            eq = equations[i * 4 + k]
            for c in range(4):
                acc[c] = (acc[c] + inv_y * eq[c]) % M
        result.append(acc)
    return result


def transpose(vector, stride):
    """Strided 4-column transpose (reference src/math/quartic.rs:137-152)."""
    assert len(vector) % (4 * stride) == 0
    row_count = len(vector) // (4 * stride)
    return [
        [
            vector[i * stride],
            vector[(i + row_count) * stride],
            vector[(i + 2 * row_count) * stride],
            vector[(i + 3 * row_count) * stride],
        ]
        for i in range(row_count)
    ]


def to_quartic_vec(vector):
    assert len(vector) % 4 == 0
    return [list(vector[i : i + 4]) for i in range(0, len(vector), 4)]
