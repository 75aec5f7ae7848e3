"""Step 4's synthetic divisions: kernel K11 (syn_div), its wrapper and
plain version.

K11 `syn_div` (csrc/syn_div.cu, syn_div.cuh) replaces the JAX package's
distaff_tpu/stark/prover.py::_syn_div_dev, _syn_div_expanded_dev,
_incl_suffix_sums and the sum of the three divisions (prover.py:568-572),
with the scans and series they run on (distaff_tpu/ops/tiles.py::
_suf_tile, suffix_sums, _ps_tile, _scale_tile; distaff_tpu/math/
field_jax.py::cumsum, power_series_dev): the constraint polynomial from
the batched iNTT's three rows in one single-pass launch (a chained scan
with decoupled look-back, tiles claimed from the end), which reads each
row once; the division by x - b as recurrences, from a power of b and one
of 1/b a thread out of K1's kind of power tables.  Bound by memory
traffic; see the source for the design.

The wrapper takes the plain version for tensors on the CPU, and launches
the kernel for tensors on the card, or raises.  The plain version is the
chain the port ran before K11 (the JAX functions' suffix sums, power
series and products), on K2's plain versions, so it launches nothing on
any device.
"""

import ctypes

import torch

from ..math import field as hostfield
from ..math import field_torch as ft
from . import cuda_lib
from . import field_kernels as fk
from . import tiles

M = hostfield.M
TILE = 1024                  # syn_div.cuh kTile = kThreads x kPerThread


def suffix_sums_plain(w, axis=0):
    """Inclusive modular suffix sums along an axis: log2(n) doubling steps
    (Hillis-Steele) of K2's plain add over the flipped axis."""
    x = w.movedim(axis, 0).flip(0)
    n, k = x.shape[0], 1
    while k < n:
        x = torch.cat([x[:k], fk.add_plain(x[k:], x[:-k])])
        k <<= 1
    return x.flip(0).movedim(0, axis)


def _divide_plain(poly, b, start):
    """Rows [start, start + len(poly)) of the division of a polynomial by
    (x - b), from its coefficients from `start` on (prover._syn_div_dev):
    out[i] = b^-(i+1) sum_{j > i} a_j b^j, a suffix sum of a_j b^j."""
    n, device = poly.shape[0], poly.device
    zero = ft.zeros((1,), device)
    if b == 1:
        return torch.cat([suffix_sums_plain(poly)[1:], zero])
    w = fk.mul_plain(poly, fk.power_series_plain(b, n, device, pow(b, start, M)))
    s_next = torch.cat([suffix_sums_plain(w)[1:], zero])               # s_{i+1}
    b_inv = hostfield.inv(b)
    return fk.mul_plain(s_next, fk.power_series_plain(b_inv, n, device,
                                                      pow(b_inv, start + 1, M)))


def _divide_expanded_plain(poly, degree, exception):
    """The last len(poly) rows of the division by (x^degree - 1) / (x -
    exception), from the polynomial's last len(poly) coefficients
    (prover._syn_div_expanded_dev):
    the quotient by x^degree - 1 is a stride-`degree` suffix sum (the slice
    padded in front to whole strides), the (x - exception) factor one
    shifted multiply-add."""
    n, device = poly.shape[0], poly.device
    pad = -n % degree
    padded = torch.cat([ft.zeros((pad,), device), poly]).reshape(-1, degree, 4)
    r = suffix_sums_plain(padded, axis=0).reshape(-1, 4)[pad:]
    zero = ft.zeros((1,), device)
    r_ext = torch.cat([r, zero])                             # length n + 1
    r_shift = torch.cat([zero, r])
    prod = fk.add_plain(fk.mul_plain(r_ext, ft.constant(hostfield.neg(exception), device)),
                        r_shift)
    count = n - degree + 1
    out = ft.zeros((n,), device)
    if count > 0:
        out[:count] = prod[degree: degree + count]
    return out


def syn_div_plain(polys3, degree, x_last, start=0):
    """syn_div's function on plain tensors: the divisions of the rows (a, f,
    t) of polys3 by x - 1, x - x_last and (x^degree - 1)/(x - x_last),
    summed, on K2's plain versions.  With `start`, rows [start, n) of the
    result alone, which read the coefficients from `start` on."""
    a, f, t = polys3[0, start:], polys3[1, start:], polys3[2, start:]
    return fk.add_plain(fk.add_plain(_divide_plain(a, 1, start), _divide_plain(f, x_last, start)),
                        _divide_expanded_plain(t, degree, x_last))


def syn_div_ops(n, degree):
    """(multiplies, adds) of the divisions at n points, at their leanest:
    the division by x - b as two recurrences of one multiply a point (the
    sum of f_j b^j by Horner, and b^-i F[i] = f_i + b b^-(i+1) F[i+1]), e R
    at the n - degree + 1 points that take it; the suffix sums of a, f b^j
    and t (stride degree), the recurrence's adds, the two sums of out and
    the subtraction of e R."""
    muls = 2 * n + (n - degree + 1)
    adds = 2 * (n - 1) + (n - degree) + 2 * n + 2 * (n - degree + 1)
    return muls, adds


def syn_div_table_keys(n, x_last, device):
    """The keys of K11's power tables at n points: b = x_last's (c = 1) and
    1/b's (c = 1/b)."""
    b = int(x_last) % M
    b_inv = hostfield.inv(b)
    return [tiles.factors_key(n, b, 1, device), tiles.factors_key(n, b_inv, b_inv, device)]


def syn_div_args(n, x_last, device):
    """K11's arguments beside the polynomials: the power tables of b =
    x_last (c = 1) and of 1/b (c = 1/b) at n points, cached (hi None up to
    1024 points), and b and -x_last as 4 host words each."""
    b = int(x_last) % M
    return (*tiles.tables(syn_div_table_keys(n, x_last, device)),
            [(v >> (32 * k)) & 0xFFFFFFFF for v in (b, hostfield.neg(b)) for k in range(4)])


def syn_div(polys3, degree, x_last):
    """The constraint polynomial from the (3, n, 4) coefficients (a, f, t)
    of the combined boundary and transition columns (n a power of two, rows
    contiguous): a / (x - 1) + f / (x - x_last) + t (x - x_last) /
    (x^degree - 1), as synthetic divisions with their remainders dropped,
    x_last a power of the size-n root.  Returns (n, 4) limbs."""
    n = polys3.shape[1] if polys3.dim() == 3 else 0
    if polys3.dim() != 3 or polys3.shape[0] != 3 or n < 2 or n & (n - 1) or \
            not 1 <= degree <= n:
        raise ValueError(f"syn_div: expected (3, n, 4) coefficients, n a power of two and "
                         f"1 <= degree <= n, got {tuple(polys3.shape)} and degree {degree}")
    if fk._on_cpu(polys3):
        return syn_div_plain(polys3, degree, x_last)
    cuda_lib.require_limbs("syn_div", polys3)
    if polys3.stride(1) != 4:
        raise ValueError(f"syn_div: the rows must be contiguous, got strides {polys3.stride()}")
    (b_lo, b_hi), (i_lo, i_hi), words = syn_div_args(n, x_last, polys3.device)
    n_tiles = -(-n // TILE)
    device = polys3.device
    flags = torch.empty(2 * n_tiles + 1, dtype=torch.int32, device=device)
    sums = torch.empty((n_tiles, 4, 4), dtype=torch.uint32, device=device)
    r = torch.empty((n, 4), dtype=torch.uint32, device=device)
    out = torch.empty((n, 4), dtype=torch.uint32, device=device)
    nul = ctypes.c_void_p(None)
    code = cuda_lib.lib().distaff_syn_div(
        cuda_lib.ptr(polys3), polys3.stride(0) // 4, n, degree, cuda_lib.ptr(b_lo),
        nul if b_hi is None else cuda_lib.ptr(b_hi), cuda_lib.ptr(i_lo),
        nul if i_hi is None else cuda_lib.ptr(i_hi), tiles._LOG_LO,
        (ctypes.c_uint32 * 4)(*words[:4]), (ctypes.c_uint32 * 4)(*words[4:]),
        cuda_lib.ptr(flags), cuda_lib.ptr(sums), cuda_lib.ptr(r), cuda_lib.ptr(out),
        cuda_lib.stream(out))
    cuda_lib.check(code, "syn_div")
    cuda_lib.LAUNCHES["syn_div"] += 1
    return out
