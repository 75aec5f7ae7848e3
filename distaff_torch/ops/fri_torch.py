"""Radix-4 FRI layer folding: kernel K9 (fri_fold), its wrapper and plain
version.

The port's counterpart of distaff_tpu/ops/fri_jax.py: each 4-point row is
evaluated at special_x in Lagrange form, which gives the field values of
the reference's interpolate-then-evaluate (reference
src/stark/fri/prover.rs:24-33).  The four nodes of row i are x*I^j with I
the primitive 4th root of unity, so the Lagrange denominators are
x^3 * K_k with global constants K_k, and no inversion runs.

K9 `fri_fold` (csrc/fri_fold.cu, fri_fold.cuh) folds one layer in one
launch, four rows a thread (one row a thread and four lanes a leaf on a
small layer): it replaces fri_jax._fold_rows_impl (jitted as
fold_rows, tiled as distaff_tpu/ops/tiles.py::_fold_tile) and the x0 and
x0^-3 power series of distaff_tpu/stark/fri.py::reduce, taking both from
K1's power tables of the LDE domain's root.  With `digests` it also
hashes the folded layer's quartic rows, the next Merkle tree's leaves
(BLAKE3, as K3 would hash them).  Bound by bytes and operations near
even; see the source for the design.

The wrapper takes the plain version for a column on the CPU, and launches
the kernel for one on the card, or raises.  The plain version is the chain
the port ran before K9 (the two power series and the fold on K2's plain
versions) and K3's plain BLAKE3 of the transposed rows, so it launches
nothing on any device.
"""

import ctypes

import torch

from ..math import field as hostfield
from ..math import field_torch as ft
from . import blake3_torch
from . import cuda_lib
from . import field_kernels as fk
from . import tiles

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
    """The fold on K2's plain versions: ys (q, 4, 4limbs) rows; x0 (q,
    4limbs) first-column nodes; inv_x0_cubed (q, 4limbs) = x0^-3;
    special_x (4,) limbs -> (q, 4limbs)."""
    mul, add, sub = fk.mul_plain, fk.add_plain, fk.sub_plain
    device = x0.device
    xj = [x0] + [mul(x0, ft.constant(_C[j], device)) for j in (1, 2, 3)]
    d = [sub(special_x, x) for x in xj]
    d01, d23 = mul(d[0], d[1]), mul(d[2], d[3])
    # numerators N_k = prod_{j != k} (special_x - x_j)
    numer = [mul(d[1], d23), mul(d[0], d23), mul(d01, d[3]), mul(d01, d[2])]
    acc = None
    for k in range(4):
        term = mul(mul(ys[:, k], numer[k]), ft.constant(_INV_K[k], device))
        acc = term if acc is None else add(acc, term)
    return mul(acc, inv_x0_cubed)


def transpose_quartic(values, stride):
    """quartic::transpose as a view: (n, 4limbs) -> (n/(4*stride), 4, 4limbs),
    rows[i][j] = values[(i + j*row_count) * stride]."""
    n = values.shape[0]
    row_count = n // (4 * stride)
    v = values[::stride] if stride > 1 else values
    return v.reshape(4, row_count, 4).transpose(0, 1)


# K9 folds four rows a thread where a thread a leaf gives every SM at
# least this many threads (air_probe k9 on the H100's 132 SMs: four rows a
# thread were faster from 2^17 rows up, one row and four lanes a leaf below)
FOLD_LEAVES_PER_SM = 128


def rows_per_thread(q, sms):
    """K9's rows a thread on a layer of q rows, on a card of `sms`
    multiprocessors: 4 (a leaf's quartic row) where the layer's q/4
    leaves give every SM FOLD_LEAVES_PER_SM threads, else 1 (four lanes a
    leaf), which a small layer's latency favours (PERF.md)."""
    return 4 if q // 4 >= sms * FOLD_LEAVES_PER_SM else 1


def fri_fold_ops(q, order):
    """(multiplies, adds, subtractions) of K9 over a layer of q rows on an
    order-point domain's tables, from its code at its leanest, four rows a
    thread (one where q < 4): a thread's table lookup of 1/x0 (a multiply
    where the domain has a hi table), t_0 = sx / x0, its rows' other t_j =
    t_0 zeta^-j and I t_j; a row's t (y0 - y2), I t (y1 - y3), t^2 and t^2
    (X + Y); y0 + y2, y1 + y3, X, X + Y, the sum and the two halvings (each
    a shift and an add) as adds; y0 - y2, y1 - y3, Y and X - Y.  The
    digests' compressions (q/4 with blake3) come on top."""
    rows = 4 if q >= 4 else 1
    thread = (order > 1 << tiles._LOG_LO) + 1 + 1 + 2 * (rows - 1)
    return q // rows * thread + 4 * q, 7 * q, 4 * q


def fri_fold_plain(column, special_x, root, stride=1, rows=None, digests=False, first=0):
    """fri_fold's function on plain tensors: the power series of x0 = w_L^i
    and of x0^-3 = w_L^-3i (w_L = root^stride) and fold_rows, on K2's plain
    versions.  With `rows` = (start, stop), the rows [start, stop) alone;
    with `digests`, (folded column, the BLAKE3 of its quartic rows on K3's
    plain version: the next Merkle tree's leaves).  With `first`, the
    column holds a slot's rows [first, first + q) of a larger layer (each
    quarter's values of them, as fri_fold takes them)."""
    if (rows is not None or first) and digests:
        raise ValueError("fri_fold_plain: the digests need the whole layer")
    q = column.shape[0] // 4
    start, stop = rows or (0, q)
    device = column.device
    w = pow(int(root), stride, M)
    inv3 = pow(hostfield.inv(w), 3, M)
    x0 = fk.power_series_plain(w, stop - start, device, pow(w, first + start, M))
    x0_inv3 = fk.power_series_plain(inv3, stop - start, device, pow(inv3, first + start, M))
    ys = transpose_quartic(column, 1)[start:stop]
    out = fold_rows(ys, x0, x0_inv3, ft.constant(special_x, device))
    if not digests:
        return out
    return out, blake3_torch.hash_rows_plain(transpose_quartic(out, 1))


def fold_words(special_x, root, stride, q):
    """K9's constants as 32 host words: special_x, zeta^-j (j = 1, 2, 3)
    and I zeta^-j (j = 0..3), zeta = w_L^(q/4) with w_L = root^stride: the
    rows i + j q/4 of a leaf have nodes x0 zeta^j, so their t = special_x /
    x0 are t_0 zeta^-j (one row a thread reads I alone)."""
    zeta_inv = hostfield.inv(pow(int(root), stride * max(q // 4, 1), M))
    values = [int(special_x) % M] + [pow(zeta_inv, j, M) for j in (1, 2, 3)]
    values += [_I * pow(zeta_inv, j, M) % M for j in range(4)]
    return [(v >> (32 * k)) & 0xFFFFFFFF for v in values for k in range(4)]


def fold_table_keys(n, stride, root, device):
    """The keys of K9's power tables for a layer of n points at `stride`:
    those of root over the LDE domain's n * stride points (the same for
    every layer of a proof)."""
    return [tiles.factors_key(n * stride, root, 1, device)]


def fri_fold(column, special_x, root, stride=1, digests=False, first=0, layer_rows=None):
    """One FRI layer folded at the host int special_x: column (4q, 4) limbs,
    the layer's evaluations over the domain of w_L = root^stride (order 4q;
    root's power tables, 4q*stride points, are K1's of the LDE domain).
    Row i holds column[i + j q] at the nodes w_L^i I^j.  Returns the (q, 4)
    folded column; with `digests` also the (q/4, 8) BLAKE3 digests of its
    quartic rows, the next layer's Merkle leaves.  On a slot of a mesh
    the column holds the rows [first, first + q) of a layer of
    `layer_rows` rows (its four quarters' values of them, quarter j at
    [j q, (j + 1) q)), without digests, and the result is their fold."""
    n = column.shape[0]
    if column.dim() != 2 or column.shape[1] != 4 or n < 4 or n & (n - 1) or stride < 1 or \
            stride & (stride - 1):
        raise ValueError(f"fri_fold: expected a (4q, 4) column of a power of two points and a "
                         f"power-of-two stride, got {tuple(column.shape)} and {stride}")
    q = n // 4
    layer_rows = q if layer_rows is None else layer_rows
    if digests and q < 4:
        raise ValueError(f"fri_fold: {q} folded points make no quartic leaf row")
    if first < 0 or first + q > layer_rows or (layer_rows != q and (digests or q < 4)):
        raise ValueError(f"fri_fold: rows [{first}, {first + q}) of {layer_rows} (a slot's "
                         f"rows fold at least 4, without digests)")
    if fk._on_cpu(column):
        return fri_fold_plain(column, special_x, root, stride, digests=digests, first=first)
    cuda_lib.require_limbs("fri_fold", column)
    column = column.contiguous()
    (lo, hi), = tiles.tables(fold_table_keys(4 * layer_rows, stride, root, column.device))
    out = torch.empty((q, 4), dtype=torch.uint32, device=column.device)
    leaves = (torch.empty((q // 4, 8), dtype=torch.uint32, device=column.device)
              if digests else None)
    nul = ctypes.c_void_p(None)
    sms = torch.cuda.get_device_properties(column.device).multi_processor_count
    code = cuda_lib.lib().distaff_fri_fold(
        cuda_lib.ptr(column), q, rows_per_thread(q, sms), cuda_lib.ptr(lo),
        nul if hi is None else cuda_lib.ptr(hi), tiles._LOG_LO, stride,
        (ctypes.c_uint32 * 32)(*fold_words(special_x, root, stride, q)), cuda_lib.ptr(out),
        nul if leaves is None else cuda_lib.ptr(leaves), first,
        0 if layer_rows == q else layer_rows, cuda_lib.stream(out))
    cuda_lib.check(code, "fri_fold")
    cuda_lib.LAUNCHES["fri_fold"] += 1
    return (out, leaves) if digests else out
