"""Radix-4 FRI layer folding on tensors.

The port's counterpart of distaff_tpu/ops/fri_jax.py: each 4-point row is
evaluated at special_x in Lagrange form, which gives the field values of
the reference's interpolate-then-evaluate (reference
src/stark/fri/prover.rs:24-33).  The four nodes of row i are x*I^j with I
the primitive 4th root of unity, so the Lagrange denominators are
x^3 * K_k with global constants K_k; the caller passes x0^-3 as a power
series, so no inversion runs here.  Every multiply and add is a K2 launch.
"""

from ..math import field as hostfield
from ..math import field_torch as ft

M = hostfield.M

# I = primitive 4th root of unity; the row nodes are x * I^j
_I = hostfield.exp(hostfield.G, 1 << 38)
_C = [1, _I, hostfield.mul(_I, _I), hostfield.mul(hostfield.mul(_I, _I), _I)]
# K_k = prod_{j != k} (I^k - I^j); constant Lagrange denominators
_INV_K = [
    hostfield.inv(
        hostfield.mul(
            hostfield.mul(
                hostfield.sub(_C[k], _C[(k + 1) % 4]),
                hostfield.sub(_C[k], _C[(k + 2) % 4])),
            hostfield.sub(_C[k], _C[(k + 3) % 4])))
    for k in range(4)
]


def fold_rows(ys, x0, inv_x0_cubed, special_x):
    """ys: (q, 4, 4limbs) rows; x0: (q, 4limbs) first-column nodes;
    inv_x0_cubed: (q, 4limbs) = x0^-3; special_x: (4,) limbs -> (q, 4limbs)."""
    device = x0.device
    xj = [x0] + [ft.mul(x0, ft.constant(_C[j], device)) for j in (1, 2, 3)]
    d = [ft.sub(special_x, x) for x in xj]
    d01, d23 = ft.mul(d[0], d[1]), ft.mul(d[2], d[3])
    # numerators N_k = prod_{j != k} (special_x - x_j)
    numer = [ft.mul(d[1], d23), ft.mul(d[0], d23), ft.mul(d01, d[3]), ft.mul(d01, d[2])]
    acc = None
    for k in range(4):
        term = ft.mul(ft.mul(ys[:, k], numer[k]), ft.constant(_INV_K[k], device))
        acc = term if acc is None else ft.add(acc, term)
    return ft.mul(acc, inv_x0_cubed)


def transpose_quartic(values, stride):
    """quartic::transpose as a view: (n, 4limbs) -> (n/(4*stride), 4, 4limbs),
    rows[i][j] = values[(i + j*row_count) * stride]."""
    n = values.shape[0]
    row_count = n // (4 * stride)
    v = values[::stride] if stride > 1 else values
    return v.reshape(4, row_count, 4).transpose(0, 1)
