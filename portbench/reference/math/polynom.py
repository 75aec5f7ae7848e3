"""Host-side polynomial operations over the 128-bit field.

Used by the verifier (small polynomials: quartic FRI rows, remainder checks,
periodic-constant polys) and as the oracle for the device NTT pipeline.
Coefficients are Python ints, ascending order.  Mirrors the semantics of
reference src/math/polynom.rs; heavy domain-sized work runs on device via
distaff_torch.math.field_torch instead.
"""

from . import field

M = field.M


def eval(p, x):
    y = 0
    power = 1
    for c in p:
        y = (y + c * power) % M
        power = (power * x) % M
    return y


def eval_fft(p, root=None):
    """Evaluate polynomial (len power of 2) over the root-of-unity domain.

    Returns evaluations in natural order: out[i] = p(root^i).
    """
    n = len(p)
    if root is None:
        root = field.get_root_of_unity(n)
    return _ntt(list(p), root)


def interpolate_fft(v, root=None):
    """Interpolate evaluations over a root-of-unity domain into coefficients."""
    n = len(v)
    if root is None:
        root = field.get_root_of_unity(n)
    inv_root = pow(root, n - 1, M)
    coeffs = _ntt(list(v), inv_root)
    inv_n = field.inv(n)
    return [(c * inv_n) % M for c in coeffs]


def _ntt(values, root):
    """Iterative in-place radix-2 DIT NTT, natural order in and out."""
    n = len(values)
    assert n & (n - 1) == 0
    bits = n.bit_length() - 1
    # bit-reversal permutation
    for i in range(n):
        j = int(bin(i)[2:].zfill(bits)[::-1], 2)
        if j > i:
            values[i], values[j] = values[j], values[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, M)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(start, start + half):
                u = values[k]
                t = (values[k + half] * w) % M
                values[k] = (u + t) % M
                values[k + half] = (u - t) % M
                w = (w * w_len) % M
        length *= 2
    return values


def interpolate(xs, ys):
    """Lagrange interpolation (used for FRI remainder checks)."""
    assert len(xs) == len(ys)
    roots = get_zero_roots(xs)
    numerators = []
    for x in xs:
        numerators.append(syn_div(roots, x))
    denominators = [eval(numerators[i], xs[i]) for i in range(len(xs))]
    denominators = field.inv_many(denominators)

    result = [0] * len(xs)
    for i in range(len(xs)):
        y_slice = (ys[i] * denominators[i]) % M
        if ys[i] != 0:
            for j in range(len(xs)):
                if numerators[i][j] != 0:
                    result[j] = (result[j] + numerators[i][j] * y_slice) % M
    return result


def add(a, b):
    n = max(len(a), len(b))
    return [field.add(a[i] if i < len(a) else 0, b[i] if i < len(b) else 0) for i in range(n)]


def sub(a, b):
    n = max(len(a), len(b))
    return [field.sub(a[i] if i < len(a) else 0, b[i] if i < len(b) else 0) for i in range(n)]


def mul(a, b):
    result = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            result[i + j] = (result[i + j] + ai * bj) % M
    return result


def mul_by_const(p, k):
    return [(c * k) % M for c in p]


def div(a, b):
    """Polynomial long division, remainder ignored."""
    apos = degree_of(a)
    a = list(a)
    bpos = degree_of(b)
    assert apos >= bpos, "cannot divide by polynomial of higher degree"
    if bpos == 0:
        assert b[0] != 0, "cannot divide polynomial by zero"
    result = [0] * (apos - bpos + 1)
    for i in range(len(result) - 1, -1, -1):
        quot = field.div(a[apos], b[bpos])
        result[i] = quot
        for j in range(bpos - 1, -1, -1):
            a[i + j] = (a[i + j] - b[j] * quot) % M
        apos -= 1
    return result


def syn_div(a, b):
    """Divide polynomial `a` by (x - b); remainder ignored."""
    result = list(a)
    syn_div_in_place(result, b)
    return result


def syn_div_in_place(a, b):
    c = 0
    for i in range(len(a) - 1, -1, -1):
        temp = (a[i] + b * c) % M
        a[i] = c
        c = temp


def syn_div_expanded_in_place(a, degree, exceptions):
    """Divide `a` by (x^degree - 1) / prod_i (x - exceptions[i]) in place."""
    # a / (x^degree - 1): strided suffix sums
    result = list(a)
    degree_offset = len(a) - degree
    for i in range(degree_offset - 1, -1, -1):
        result[i] = (result[i] + result[i + degree]) % M

    # multiply by each (x - e)
    for exception in exceptions:
        neg_e = field.neg(exception)
        result.append(0)
        next_term = result[0]
        result[0] = 0
        for i in range(len(result) - 1):
            result[i] = (result[i] + next_term * neg_e) % M
            next_term, result[i + 1] = result[i + 1], next_term

    count = degree_offset + len(exceptions)
    a[:count] = result[degree : degree + count]
    for i in range(count, len(a)):
        a[i] = 0


def degree_of(poly):
    for i in range(len(poly) - 1, -1, -1):
        if poly[i] != 0:
            return i
    return 0


def infer_degree(evaluations):
    assert len(evaluations) & (len(evaluations) - 1) == 0
    return degree_of(interpolate_fft(evaluations))


def get_zero_roots(xs):
    """Coefficients of prod_i (x - xs[i])."""
    result = [1]
    for x in xs:
        result = mul(result, [field.neg(x), 1])
    return result
