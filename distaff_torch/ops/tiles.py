"""NTTs, power series and pointwise passes over whole tensors.

The port's counterpart of distaff_tpu/ops/tiles.py.  The JAX module cut
every pass into fixed-shape tiles so that one set of compiled XLA
executables served every trace geometry; PyTorch runs eagerly and the
kernels take any shape, so here each pass runs on the whole tensor.

NTTs: a transform of size n <= leaf is one launch of kernel K1
(ntt_leaf).  A larger one is a Bailey four-step with n2 = leaf - row
transforms on K1, the twiddle multiply w^(k1*j2) as one K2 launch, and the
size-n1 column transforms by recursion; the transposes are PyTorch data
movement.  An NTT has a unique result, so the values are those of the
JAX package's Pease kernels bit for bit.
"""

import torch

from ..math import field as hostfield
from ..math import field_torch as ft
from . import field_kernels as fk

M = hostfield.M
LEAF = fk.MAX_LEAF


# ------------------------------------------------------------------------------------------------
# power series and pointwise helpers
# ------------------------------------------------------------------------------------------------

def power_series(x_int, n, device):
    """[x^0 .. x^(n-1)] as an (n, 4) tensor for a host-int base."""
    if n <= 0:
        return ft.zeros((0,), device)
    return ft.power_series_dev(ft.constant(int(x_int) % M, device), n)


def scale(values, c_int):
    """values * c for a host-int constant c."""
    return ft.mul(values, ft.constant(int(c_int) % M, values.device))


def weighted_register_sum(lde, weights):
    """sum_i weights[i] * lde[i] over (R, D, 4) with (R, 4) weights -> (D, 4)."""
    total = ft.mul(lde[0], weights[0])
    for i in range(1, lde.shape[0]):
        total = ft.add(total, ft.mul(lde[i], weights[i]))
    return total


def suffix_sums(w):
    """Inclusive modular suffix sums over axis 0 of (n, 4)."""
    return ft.cumsum(w.flip(0)).flip(0)


# ------------------------------------------------------------------------------------------------
# NTT
# ------------------------------------------------------------------------------------------------

def _four_step_table(n1, n2, root_int, device):
    """(n1, n2, 4) table of w^(k1*j2): row k1 is the power series of w^k1,
    built by doubling along j2 with one broadcast multiply per step."""
    table = ft.constant(1, device).expand(n1, 1, 4)
    p = power_series(root_int, n1, device)[:, None, :]     # w^(k1 * len)
    while table.shape[1] < n2:
        table = torch.cat([table, ft.mul(table, p)], dim=1)
        if table.shape[1] < n2:
            p = ft.mul(p, p)
    return table


def ntt_batched(values, root_int, leaf=LEAF):
    """Natural-order NTT of size n along axis 1 of (B, n, 4) limbs, root_int
    a primitive n-th root of unity; `leaf` (a power of two <= 1024) is the
    largest transform run as one K1 launch."""
    b, n = values.shape[0], values.shape[1]
    root_int = int(root_int)
    if n == 1:
        return values
    if n <= leaf:
        return fk.ntt_leaf(values, power_series(root_int, n // 2, values.device))

    n2 = leaf
    n1 = n // n2
    # split k = k2*n1 + k1: rows [b, k1] hold a[k2*n1 + k1] over k2
    t = values.reshape(b, n2, n1, 4).transpose(1, 2).reshape(b * n1, n2, 4)
    bv = fk.ntt_leaf(t, power_series(pow(root_int, n1, M), n2 // 2, values.device))
    bv = ft.mul(bv.reshape(b, n1, n2, 4),
                _four_step_table(n1, n2, root_int, values.device))   # *= w^(k1*j2)
    cin = bv.transpose(1, 2).reshape(b * n2, n1, 4)                   # [b, j2, k1]
    c = ntt_batched(cin, pow(root_int, n2, M), leaf)                  # -> [b, j2, j1]
    return c.reshape(b, n2, n1, 4).transpose(1, 2).reshape(b, n, 4)  # j = j1*n2 + j2


def intt_batched(values, root_int=None, leaf=LEAF):
    """Inverse NTT along axis 1 of (B, n, 4): the forward transform with the
    inverse root, scaled by 1/n."""
    n = values.shape[1]
    if n == 1:
        return values
    if root_int is None:
        root_int = hostfield.get_root_of_unity(n)
    out = ntt_batched(values, pow(int(root_int), n - 1, M), leaf)
    return scale(out, hostfield.inv(n))


def ntt(values, root_int=None, leaf=LEAF):
    """(n, 4) coefficient vector -> evaluations over the size-n domain."""
    n = values.shape[0]
    if n == 1:
        return values
    if root_int is None:
        root_int = hostfield.get_root_of_unity(n)
    return ntt_batched(values[None], root_int, leaf)[0]


def intt(values, root_int=None, leaf=LEAF):
    n = values.shape[0]
    if n == 1:
        return values
    return intt_batched(values[None], root_int, leaf)[0]
