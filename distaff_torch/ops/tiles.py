"""NTTs over whole tensors, and the power tables the kernels share.

The port's counterpart of distaff_tpu/ops/tiles.py.  The JAX module cut
every pass into fixed-shape tiles so that one set of compiled XLA
executables served every trace geometry; PyTorch runs eagerly and the
kernels take any shape, so here each pass runs on the whole tensor.

NTTs: a transform of size n <= leaf is one launch of kernel K1
(ntt_pass).  A larger one is a Bailey four-step, n = n1 * n2, as two K1
passes over strided columns: pass A reads the columns k1 of the input (zero
extended where the input is shorter than n), transforms them over k2 and
multiplies by w^(k1*j2) on its store, from two small power tables; pass B
transforms the columns j2 of that into the caller's output.  No transpose,
no twiddle table of n entries, no K2 launch; the inverse transform's 1/n
rides on the first pass's store.  Above leaf^2 points pass B recurses, in
place, with one transpose.  An NTT has a unique result, so the values are
those of the JAX package's Pease kernels bit for bit.
"""

import torch

from ..math import field as hostfield
from . import field_kernels as fk

M = hostfield.M
LEAF = fk.MAX_LEAF


# ------------------------------------------------------------------------------------------------
# NTT
# ------------------------------------------------------------------------------------------------

# power tables (K1's, K4's, K7's, K9's, K10's, K11's), each built by K12
# launches once per device, size, root and constant
_TABLES = {}
_LOG_LO = 10


def _cached(key, build):
    if key not in _TABLES:
        _TABLES[key] = build()
    return _TABLES[key]


def _stage_twiddles(m, root_int, device):
    """The m/2 powers of a size-m root: a pass's butterfly twiddles."""
    return _cached(("tw", str(device), m, root_int),
                   lambda: fk.power_series(root_int, m // 2, device))


def _store_factors(n, root_int, c_int, device):
    """(lo, hi) with lo[x] = c w^x for x < min(n, 1024) and hi[y] =
    w^(1024 y), so that c w^e = lo[e % 1024] * hi[e // 1024] for e < n; hi
    is None for n <= 1024."""
    def build():
        size = min(n, 1 << _LOG_LO)
        lo = fk.power_series(root_int, size, device, c_int)
        if n <= size:
            return lo, None
        return lo, fk.power_series(pow(root_int, size, M), n // size, device)
    return _cached(("factors", str(device), n, root_int, c_int), build)


def _ntt_into(values, n_in, dst, n, root_int, c_int, leaf):
    """dst (B, n, 4) <- c * NTT_n of the rows of values (B, n_in, 4), zero
    extended from n_in to n points."""
    b = values.shape[0]
    device = values.device
    vs, ds = values.stride(0) // 4, dst.stride(0) // 4
    if n <= leaf:
        lo = None if c_int == 1 else _store_factors(1, root_int, c_int, device)[0]
        return fk.ntt_pass(values, dst, _stage_twiddles(n, root_int, device), b, 1,
                           (vs, 0, 1), (ds, 0, 1), n_in, lo)

    # n = n1 * n2, k = k2*n1 + k1, j = j1*n2 + j2: pass A transforms each
    # column k1 over k2 (size n2) and multiplies by c w^(k1*j2); pass B
    # transforms each column j2 over k1 (size n1) into j1*n2 + j2
    n2 = min(leaf, 1 << (n.bit_length() // 2))
    n1 = n // n2
    lo, hi = _store_factors(n, root_int, c_int, device)
    tw2 = _stage_twiddles(n2, pow(root_int, n1, M), device)
    scratch = torch.empty((b, n, 4), dtype=torch.uint32, device=device)
    if n1 <= leaf:
        # pass A stores rows [k1][j2], pass B reads their columns j2
        fk.ntt_pass(values, scratch, tw2, b, n1, (vs, 1, n1), (n, n2, 1), n_in, lo, hi)
        return fk.ntt_pass(scratch, dst, _stage_twiddles(n1, pow(root_int, n2, M), device),
                           b, n2, (n, 1, n2), (ds, 1, n2), n)
    # pass A stores [j2][k1], whose rows the size-n1 transforms take by
    # recursion, in place: the inner transform writes its result over its
    # input once its first pass has read it, so the recursion holds one
    # scratch of n points a level.  One transpose puts j1*n2 + j2 in place
    fk.ntt_pass(values, scratch, tw2, b, n1, (vs, 1, n1), (n, 1, n1), n_in, lo, hi)
    rows = scratch.view(b * n2, n1, 4)
    inner = _ntt_into(rows, n1, rows, n1, pow(root_int, n2, M), 1, leaf)
    dst.view(b, n1, n2, 4).copy_(inner.view(b, n2, n1, 4).transpose(1, 2))
    return dst


def ntt_buffers(n, leaf=LEAF):
    """How many (B, n, 4) buffers a transform of n points holds at once:
    its output, and one scratch for each level of the four-step (the
    device-memory check of the LDE counts them)."""
    if n <= leaf:
        return 1
    n1 = n // min(leaf, 1 << (n.bit_length() // 2))
    # the inner transform's output is this level's scratch
    return 2 if n1 <= leaf else 1 + ntt_buffers(n1, leaf)


def ntt_batched(values, root_int, leaf=LEAF, n=None):
    """Natural-order NTT of size n (default values.shape[1]) along axis 1 of
    (B, n_in, 4) limbs, zero extended from n_in to n points, root_int a
    primitive n-th root of unity.  `leaf` (a power of two <= 2048) is the
    largest transform of one K1 pass: n <= leaf is one launch, n <= leaf^2
    two, and a larger n recurses on the second pass."""
    return _transform(values, int(root_int), 1, leaf, n)


def _transform(values, root_int, c_int, leaf, n):
    b, n_in = values.shape[0], values.shape[1]
    n = n_in if n is None else n
    if n_in > n or n & (n - 1) or leaf > LEAF or leaf & (leaf - 1) or leaf < 2:
        raise ValueError(f"ntt: {n_in} points into a transform of {n}, leaf {leaf}")
    out = torch.empty((b, n, 4), dtype=torch.uint32, device=values.device)
    values = values.contiguous()
    if n == 1:                                    # (c = 1/n = 1)
        return out.copy_(values)
    return _ntt_into(values, n_in, out, n, root_int, c_int, leaf)


def intt_batched(values, root_int=None, leaf=LEAF):
    """Inverse NTT along axis 1 of (B, n, 4): the forward transform with the
    inverse root, its 1/n folded into the first pass's store."""
    n = values.shape[1]
    if root_int is None:
        root_int = hostfield.get_root_of_unity(n)
    return _transform(values, pow(int(root_int), n - 1, M), hostfield.inv(n), leaf, n)


def ntt(values, root_int=None, leaf=LEAF, n=None):
    """(n_in, 4) coefficient vector -> evaluations over the size-n domain
    (n defaults to n_in)."""
    n = values.shape[0] if n is None else n
    if root_int is None:
        root_int = hostfield.get_root_of_unity(n)
    return ntt_batched(values[None], root_int, leaf, n)[0]


def intt(values, root_int=None, leaf=LEAF):
    return intt_batched(values[None], root_int, leaf)[0]
