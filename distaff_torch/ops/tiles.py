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

import contextlib

import torch

from ..math import field as hostfield
from . import field_kernels as fk

M = hostfield.M
LEAF = fk.MAX_LEAF


# ------------------------------------------------------------------------------------------------
# NTT
# ------------------------------------------------------------------------------------------------

# power tables (K1's, K4's, K7's, K9's, K10's, K11's) by key: a prover
# builds every table of its proof in one K12 launch at its start
# (build_tables, from the keys of each user's *_table_keys function), and a
# table that no plan built is built on first use (tables)
_TABLES = {}
_LOG_LO = 10


def device_key(device):
    """A device as the tables' keys name it: a card with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def twiddle_key(m, root_int, device):
    """The key of the m/2 powers of a size-m root: a pass's butterfly
    twiddles."""
    return ("tw", device_key(device), m, int(root_int))


def factors_key(n, root_int, c_int, device):
    """The key of (lo, hi) with lo[x] = c w^x for x < min(n, 1024) and
    hi[y] = w^(1024 y), so that c w^e = lo[e % 1024] * hi[e // 1024] for e <
    n; hi is None for n <= 1024."""
    return ("factors", device_key(device), n, int(root_int), int(c_int))


def _series(key):
    """The K12 tables (x, n, c) of a key."""
    if key[0] == "tw":
        _, _, m, root = key
        return [(root, m // 2, 1)]
    _, _, n, root, c = key
    size = min(n, 1 << _LOG_LO)
    return [(root, size, c)] + ([(pow(root, size, M), n // size, 1)] if n > size else [])


def build_tables(keys):
    """Build every table of `keys` that the cache lacks, in one K12 launch
    a device (the plain version on the CPU).  Returns the keys built."""
    missing = list(dict.fromkeys(k for k in keys if k not in _TABLES))
    for device in dict.fromkeys(k[1] for k in missing):
        mine = [k for k in missing if k[1] == device]
        series = [_series(k) for k in mine]
        with _on(device):
            built = iter(fk.power_series_many([t for ts in series for t in ts], device))
            _settle(device)
        for key, ts in zip(mine, series):
            lo, *hi = (next(built) for _ in ts)
            _TABLES[key] = lo if key[0] == "tw" else (lo, hi[0] if hi else None)
    return missing


def _on(device):
    """The context that launches on `device`: its card, for a card."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _settle(device):
    """Wait for tables built on a side stream (a mesh slot's, parallel/
    mesh.py): every stream of the card reads the cache."""
    device = torch.device(device)
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        if stream != torch.cuda.default_stream(device):
            stream.synchronize()


def tables(keys):
    """The tables of `keys`, each built where the cache lacks it."""
    build_tables(keys)
    return [_TABLES[k] for k in keys]


def _stage_twiddles(m, root_int, device):
    """The m/2 powers of a size-m root: a pass's butterfly twiddles."""
    return tables([twiddle_key(m, root_int, device)])[0]


def _store_factors(n, root_int, c_int, device):
    """(lo, hi) of factors_key(n, root_int, c_int)."""
    return tables([factors_key(n, root_int, c_int, device)])[0]


def _split(n, leaf):
    """A four-step transform's n = n1 * n2: pass A's size n2, pass B's n1."""
    n2 = min(leaf, 1 << (n.bit_length() // 2))
    return n // n2, n2


def transform_keys(n, root_int, c_int, device, leaf=LEAF):
    """The keys of the tables that a transform of n points at root_int,
    times c_int, takes (_ntt_into's, through its recursion)."""
    root_int, c_int = int(root_int), int(c_int)
    if n == 1:
        return []
    if n <= leaf:
        return [twiddle_key(n, root_int, device)] + (
            [] if c_int == 1 else [factors_key(1, root_int, c_int, device)])
    n1, n2 = _split(n, leaf)
    keys = [factors_key(n, root_int, c_int, device),
            twiddle_key(n2, pow(root_int, n1, M), device)]
    if n1 <= leaf:
        return keys + [twiddle_key(n1, pow(root_int, n2, M), device)]
    return keys + transform_keys(n1, pow(root_int, n2, M), 1, device, leaf)


def ntt_keys(n, root_int, device):
    """The table keys of ntt_batched to n points at root_int."""
    return transform_keys(n, root_int, 1, device)


def intt_keys(n, root_int, device):
    """The table keys of intt_batched over n points at root_int."""
    return transform_keys(n, pow(int(root_int), n - 1, M), hostfield.inv(n), device)


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
    n1, n2 = _split(n, leaf)
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
