"""Field kernels K1 (ntt_pass), K2 (field_ew), K5 (butterfly) and K6
(inv_batch): wrappers and plain versions.

K1 `ntt_pass` (csrc/ntt_pass.cu, ntt_pass.cuh) replaces the TPU kernel
distaff_tpu/ops/field_pallas.py::_leaf_ntt_kernel (launched by
_leaf_ntt_planes, wrapped by leaf_ntt_bm) and the four-step glue around it:
a batch of natural-order NTTs of size m <= 2048 over strided columns, with
zero extension and the four-step twiddle (or a constant) on the store, all
stages in on-chip memory.  ops/tiles.ntt_batched runs a transform of up to
2048^2 points as two launches.  Bound by operations; see the source for the
design.

K2 `field_ew` (csrc/field_ew.cu) replaces the in-kernel limb arithmetic of
both Pallas kernels (field_pallas.py _add_limbs, _sub_limbs, _mul_limbs)
and the XLA arithmetic of distaff_tpu/math/field_jax.py (add, sub, mul,
exp_const): elementwise over broadcast operands.  add/sub/mul are bound by
memory traffic, exp_const by operations.

K6 `inv_batch` (csrc/inv_batch.cu) replaces the XLA batch inversion
distaff_tpu/math/field_jax.py::inv_batch_scan (Montgomery's trick): every
element's inverse, zero to zero, with one Fermat chain a block.  Its plain
version is `exp_const_plain(a, M - 2)`, another algorithm with the same
results.  Bound by memory traffic.

K5 `butterfly` (csrc/butterfly.cu) replaces the TPU kernel
distaff_tpu/ops/field_pallas.py::_butterfly_kernel (launched by
butterfly_stage_planes, wrapped by butterfly_stage): one radix-2 stage,
(a + b, (a - b) * w).  `ntt_stagewise` drives it stage by stage, as
ntt_pallas does; the kernel bench (distaff_torch/tools/kernel_bench.py) is
its only caller.  Bound by memory traffic.

Each wrapper takes its kernel's plain version for tensors on the CPU, and
launches the kernel for tensors on the card, or raises: there is no
fallback from one to the other.  The plain versions (`*_plain`) compute in
int64 on 32-bit limbs for add/sub and on 16-bit halfwords for products,
because PyTorch has almost no uint32 arithmetic; they run on any device,
which is how the kernels are checked against them on the card.
"""

import ctypes

import torch

from . import cuda_lib

M = 2**128 - 45 * 2**40 + 1
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
_M_LIMBS = tuple((M >> (32 * k)) & _MASK32 for k in range(4))
# R = 2^128 mod M = 45*2^40 - 1 as three 16-bit halfwords
_R_HALFWORDS = tuple((((45 << 40) - 1) >> (16 * k)) & _MASK16 for k in range(3))

MAX_LEAF = 2048


# ------------------------------------------------------------------------------------------------
# plain versions: int64 limb tensors (..., 4), each limb in [0, 2^32)
# ------------------------------------------------------------------------------------------------

def _limbs(x):
    return [x[..., k] for k in range(4)]


def _add_raw(a, b):
    """4-limb add of limb lists -> (sum limbs, carry-out)."""
    out, carry = [], 0
    for k in range(4):
        t = a[k] + b[k] + carry
        out.append(t & _MASK32)
        carry = t >> 32
    return out, carry


def _sub_raw(a, b):
    """4-limb subtract of limb lists -> (difference limbs mod 2^128, borrow-out)."""
    out, borrow = [], 0
    for k in range(4):
        t = a[k] - b[k] - borrow
        borrow = (t < 0).to(torch.int64)
        out.append(t + (borrow << 32))
    return out, borrow


def add64(a, b):
    s, carry = _add_raw(_limbs(a), _limbs(b))
    d, borrow = _sub_raw(s, _M_LIMBS)
    # s >= M iff the trial subtraction does not borrow, or the add carried out
    need = (carry > 0) | (borrow == 0)
    return torch.stack([torch.where(need, d[k], s[k]) for k in range(4)], -1)


def sub64(a, b):
    d, borrow = _sub_raw(_limbs(a), _limbs(b))
    d2, _ = _add_raw(d, _M_LIMBS)
    under = borrow > 0
    return torch.stack([torch.where(under, d2[k], d[k]) for k in range(4)], -1)


def _halfwords(x):
    out = []
    for k in range(4):
        out.append(x[..., k] & _MASK16)
        out.append(x[..., k] >> 16)
    return out


def _product_columns(x, y):
    """Column sums of the schoolbook product of two halfword lists."""
    cols = [0] * (len(x) + len(y) - 1)
    for i, xi in enumerate(x):
        for j, yj in enumerate(y):
            cols[i + j] = cols[i + j] + xi * yj
    return cols


def _plus(x, y):
    n = max(len(x), len(y))
    return [(x[k] if k < len(x) else 0) + (y[k] if k < len(y) else 0) for k in range(n)]


def _normalize(cols, out_len):
    """Propagate carries so each of out_len halfwords is < 2^16."""
    out, carry = [], 0
    for k in range(out_len):
        v = (cols[k] if k < len(cols) else 0) + carry
        out.append(v & _MASK16)
        carry = v >> 16
    return out


def _reduce256(h):
    """16 halfwords of a 256-bit value -> (..., 4) int64 limbs mod M, folding
    the high half through R = 2^128 mod M as field_jax._reduce_256 does."""
    lo, hi = h[:8], h[8:]
    p1 = _normalize(_plus(_product_columns(hi, _R_HALFWORDS), lo), 12)      # < 2^175
    p2 = _normalize(_plus(_product_columns(p1[8:], _R_HALFWORDS), p1[:8]), 9)  # < 2^128 + 2^95
    p3 = _normalize(_plus([p2[8] * r for r in _R_HALFWORDS], p2[:8]), 8)    # < 2^128
    limbs = [p3[2 * k] | (p3[2 * k + 1] << 16) for k in range(4)]
    d, borrow = _sub_raw(limbs, _M_LIMBS)
    keep = borrow > 0
    return torch.stack([torch.where(keep, limbs[k], d[k]) for k in range(4)], -1)


def mul64(a, b):
    a, b = torch.broadcast_tensors(a, b)
    cols = _product_columns(_halfwords(a), _halfwords(b))
    return _reduce256(_normalize(cols, 16))


def exp64(a, e):
    result = torch.zeros_like(a)
    result[..., 0] = 1
    base = a
    while e:
        if e & 1:
            result = mul64(result, base)
        e >>= 1
        if e:
            base = mul64(base, base)
    return result


def _bitrev(n, device):
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx = idx >> 1
    return rev


def ntt_leaf64(values, tw):
    """Pease stages of field_jax._ntt_stages_bm, then the bit-reversal of
    leaf_ntt_bm: (B, n, 4) int64 limbs -> natural-order NTT along axis 1."""
    b, n = values.shape[0], values.shape[1]
    half = n // 2
    pair = torch.arange(half, device=values.device)
    x = values
    for s in range(n.bit_length() - 1):
        w = tw.index_select(0, (pair >> s) << s)[None]            # stage-s twiddle row
        a, c = x[:, :half], x[:, half:]
        even = add64(a, c)
        odd = mul64(sub64(a, c), w)
        x = torch.stack([even, odd], dim=2).reshape(b, n, 4)
    return x.index_select(1, _bitrev(n, values.device))


def add_plain(a, b):
    return add64(a.to(torch.int64), b.to(torch.int64)).to(torch.uint32)


def sub_plain(a, b):
    return sub64(a.to(torch.int64), b.to(torch.int64)).to(torch.uint32)


def mul_plain(a, b):
    return mul64(a.to(torch.int64), b.to(torch.int64)).to(torch.uint32)


def exp_const_plain(a, e):
    return exp64(a.to(torch.int64), int(e)).to(torch.uint32)


def ntt_leaf_plain(values, tw):
    return ntt_leaf64(values.to(torch.int64), tw.to(torch.int64)).to(torch.uint32)


# ------------------------------------------------------------------------------------------------
# K2 field_ew
# ------------------------------------------------------------------------------------------------

_OPS = {"add": (0, add_plain), "sub": (1, sub_plain), "mul": (2, mul_plain)}
_MAX_DIMS = 4


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def collapse_dims(shape, *operands):
    """The batch dimensions of an elementwise operation over (..., 4)
    `operands` broadcast to `shape`, as K2 indexes them: size-1 dimensions
    dropped and each dimension merged into the one outside it where that is
    contiguous with it in every operand.  Returns (sizes, strides), outermost
    first, strides in elements, one list per operand (0 = broadcast)."""
    views = [t.expand(shape) for t in operands]
    sizes, strides = [], [[] for _ in operands]
    for d, size in enumerate(shape[:-1]):
        if size == 1:
            continue
        inner = [v.stride(d) // 4 for v in views]
        if sizes and all(st[-1] == s * size for st, s in zip(strides, inner)):
            sizes[-1] *= size
            for st, s in zip(strides, inner):
                st[-1] = s
        else:
            sizes.append(size)
            for st, s in zip(strides, inner):
                st.append(s)
    if not sizes:
        return [1], [[0] for _ in operands]
    return sizes, strides


def _binary(name, a, b):
    op, plain = _OPS[name]
    if _on_cpu(a, b):
        return plain(a, b)
    what = f"field_ew.{name}"
    cuda_lib.require_limbs(what, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.uint32, device=a.device)
    n = out.numel() // 4
    if n == 0:
        return out
    sizes, (sa, sb) = collapse_dims(shape, a, b)
    if len(sizes) > _MAX_DIMS:
        raise ValueError(f"{what}: at most {_MAX_DIMS} batch dimensions after collapsing, "
                         f"got shape {tuple(shape)}")
    arr = ctypes.c_longlong * len(sizes)
    code = cuda_lib.lib().distaff_field_binary(
        op, len(sizes), cuda_lib.ptr(a), cuda_lib.ptr(b), cuda_lib.ptr(out), n,
        arr(*sizes), arr(*sa), arr(*sb), cuda_lib.stream(out))
    cuda_lib.check(code, what)
    cuda_lib.LAUNCHES[what] += 1
    return out


def add(a, b):
    """(a + b) mod M over broadcast (..., 4) uint32 limb tensors."""
    return _binary("add", a, b)


def sub(a, b):
    """(a - b) mod M over broadcast (..., 4) uint32 limb tensors."""
    return _binary("sub", a, b)


def mul(a, b):
    """(a * b) mod M over broadcast (..., 4) uint32 limb tensors."""
    return _binary("mul", a, b)


def exp_const(a, e):
    """a^e elementwise for a host-int exponent 0 <= e < 2^128 (0^0 == 1)."""
    e = int(e)
    if not 0 <= e < 1 << 128:
        raise ValueError(f"exponent out of range: {e}")
    if _on_cpu(a):
        return exp_const_plain(a, e)
    cuda_lib.require_limbs("field_ew.exp_const", a)
    a = a.contiguous()
    out = torch.empty_like(a)
    code = cuda_lib.lib().distaff_field_exp(
        cuda_lib.ptr(a), cuda_lib.ptr(out), a.numel() // 4,
        e & ((1 << 64) - 1), e >> 64, cuda_lib.stream(a))
    cuda_lib.check(code, "field_ew.exp_const")
    cuda_lib.LAUNCHES["field_ew.exp_const"] += 1
    return out


# ------------------------------------------------------------------------------------------------
# K6 inv_batch
# ------------------------------------------------------------------------------------------------

def inv_batch_plain(a):
    return exp_const_plain(a, M - 2)


def inv_batch(a):
    """Elementwise inverse of (..., 4) uint32 limbs; zero maps to zero."""
    if _on_cpu(a):
        return inv_batch_plain(a)
    cuda_lib.require_limbs("inv_batch", a)
    a = a.contiguous()
    out = torch.empty_like(a)
    code = cuda_lib.lib().distaff_inv_batch(
        cuda_lib.ptr(a), cuda_lib.ptr(out), a.numel() // 4, cuda_lib.stream(a))
    cuda_lib.check(code, "inv_batch")
    cuda_lib.LAUNCHES["inv_batch"] += 1
    return out


# ------------------------------------------------------------------------------------------------
# K1 ntt_pass
# ------------------------------------------------------------------------------------------------

def _pass_offsets(batch, cols, m, strides, device):
    """(batch, cols, m) element offsets of a pass's points, and the offsets
    of each point in its batch row, for strides (batch, column, point)."""
    bs, cs, ps = strides
    in_row = (torch.arange(cols, device=device)[:, None] * cs
              + torch.arange(m, device=device)[None, :] * ps)
    return torch.arange(batch, device=device)[:, None, None] * bs + in_row[None], in_row


def ntt_pass_plain(src, dst, tw, batch, cols, src_strides, dst_strides, n_in,
                   lo=None, hi=None):
    """ntt_pass's function on int64 limbs: a gather of the transforms, the
    Pease leaf of ntt_leaf64, the store factors and a scatter into dst."""
    m = 2 * tw.shape[0]
    device = src.device
    idx, in_row = _pass_offsets(batch, cols, m, src_strides, device)
    valid = in_row < n_in
    idx = torch.where(valid[None], idx, 0).reshape(-1)
    x = src.reshape(-1, 4).view(torch.int32).index_select(0, idx).to(torch.int64) & _MASK32
    x = x.view(batch * cols, m, 4) * valid.repeat(batch, 1)[..., None]
    y = ntt_leaf64(x, tw.to(torch.int64)).view(batch, cols, m, 4)
    if lo is not None:
        e = (torch.arange(cols, device=device)[:, None]
             * torch.arange(m, device=device)[None, :]).reshape(-1)
        log_lo = lo.shape[0].bit_length() - 1
        f = lo.to(torch.int64).index_select(0, e & (lo.shape[0] - 1))
        if hi is not None:
            f = mul64(f, hi.to(torch.int64).index_select(0, e >> log_lo))
        y = mul64(y, f.view(1, cols, m, 4))
    out_idx, _ = _pass_offsets(batch, cols, m, dst_strides, device)
    dst.view(-1, 4).view(torch.int32).index_copy_(
        0, out_idx.reshape(-1), y.reshape(-1, 4).to(torch.uint32).view(torch.int32))
    return dst


def _pass_span(batch, cols, m, strides, limit):
    """One more than the largest element offset a pass touches."""
    bs, cs, ps = strides
    return (batch - 1) * bs + min(limit, (cols - 1) * cs + (m - 1) * ps + 1)


def ntt_pass(src, dst, tw, batch, cols, src_strides, dst_strides, n_in, lo=None, hi=None):
    """One pass of the four-step NTT into dst: for b < batch and t < cols
    (a power of two), the natural-order NTT of size m = 2 * len(tw) of the
    points k of (b, t) at src element b*bs + t*cs + k*ps (src_strides =
    (bs, cs, ps), in (4,)-limb elements of the contiguous src), points whose
    offset t*cs + k*ps in their row is n_in or more counting as zero; output
    point j goes to dst element b*bs + t*cs + j*ps (dst_strides), times
    lo[e % len(lo)] * hi[e // len(lo)], e = t*j, where lo is given (times
    lo[e] alone, e < len(lo), without hi).  tw holds the m/2 powers of the
    size-m root; m is a power of two in [2, MAX_LEAF].  Returns dst."""
    m = 2 * tw.shape[0]
    if m < 2 or m > MAX_LEAF or m & (m - 1) or cols < 1 or cols & (cols - 1) or batch < 1:
        raise ValueError(f"ntt_pass: m = {m} (a power of two in [2, {MAX_LEAF}]), "
                         f"cols = {cols} (a power of two), batch = {batch}")
    tensors = [t for t in (src, dst, tw, lo, hi) if t is not None]
    for t in tensors:
        if not t.is_contiguous() or t.shape[-1] != 4:
            raise ValueError(f"ntt_pass: expected contiguous (..., 4) limbs, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if _pass_span(batch, cols, m, src_strides, n_in) > src.numel() // 4 or \
            _pass_span(batch, cols, m, dst_strides, 1 << 62) > dst.numel() // 4:
        raise ValueError("ntt_pass: the strides reach beyond src or dst")
    if src.data_ptr() < dst.data_ptr() + dst.numel() * 4 and \
            dst.data_ptr() < src.data_ptr() + src.numel() * 4:
        raise ValueError("ntt_pass: src and dst overlap")
    exponents = (cols - 1) * (m - 1) + 1
    if lo is not None and exponents > lo.shape[0] * (hi.shape[0] if hi is not None else 1):
        raise ValueError(f"ntt_pass: factor tables of {lo.shape[0]} x "
                         f"{1 if hi is None else hi.shape[0]} cover fewer than {exponents} exponents")
    if lo is not None and lo.shape[0] & (lo.shape[0] - 1):
        raise ValueError(f"ntt_pass: lo must have a power-of-two length, got {lo.shape[0]}")
    if hi is not None and lo is None:
        raise ValueError("ntt_pass: hi needs lo")
    if _on_cpu(*tensors):
        return ntt_pass_plain(src, dst, tw, batch, cols, src_strides, dst_strides, n_in, lo, hi)
    cuda_lib.require_limbs("ntt_pass", *tensors)
    nul = ctypes.c_void_p(None)
    code = cuda_lib.lib().distaff_ntt_pass(
        cuda_lib.ptr(src), cuda_lib.ptr(dst), cuda_lib.ptr(tw),
        cuda_lib.ptr(lo) if lo is not None else nul, cuda_lib.ptr(hi) if hi is not None else nul,
        batch, cols.bit_length() - 1, m.bit_length() - 1, *src_strides, n_in, *dst_strides,
        0 if lo is None else lo.shape[0].bit_length() - 1, cuda_lib.stream(dst))
    cuda_lib.check(code, "ntt_pass")
    cuda_lib.LAUNCHES["ntt_pass"] += 1
    return dst


# ------------------------------------------------------------------------------------------------
# K5 butterfly
# ------------------------------------------------------------------------------------------------

def butterfly_stage_plain(a, b, w):
    return add_plain(a, b), mul_plain(sub_plain(a, b), w)


def butterfly_stage(a, b, w):
    """One radix-2 stage over (n, 4) uint32 limbs: (a + b, (a - b) * w)."""
    if a.dim() != 2 or a.shape != b.shape or a.shape != w.shape:
        raise ValueError(f"butterfly: expected three equal (n, 4) operands, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(w.shape)}")
    if _on_cpu(a, b, w):
        return butterfly_stage_plain(a, b, w)
    cuda_lib.require_limbs("butterfly", a, b, w)
    a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
    even, odd = torch.empty_like(a), torch.empty_like(a)
    code = cuda_lib.lib().distaff_butterfly(
        cuda_lib.ptr(a), cuda_lib.ptr(b), cuda_lib.ptr(w), cuda_lib.ptr(even),
        cuda_lib.ptr(odd), a.shape[0], cuda_lib.stream(a))
    cuda_lib.check(code, "butterfly")
    cuda_lib.LAUNCHES["butterfly"] += 1
    return even, odd


def ntt_stagewise(values, root=None):
    """Natural-order NTT of an (n, 4) vector, n a power of two >= 2, one
    butterfly launch per stage (ntt_pallas's schedule): Pease stages with
    the twiddle of pair i at stage s being W[(i >> s) << s], the stages'
    outputs interleaved, and one bit-reversal at the end."""
    from ..math import field as hostfield
    from . import tiles

    n = values.shape[0]
    if n < 2 or n & (n - 1):
        raise ValueError(f"ntt_stagewise: n must be a power of two >= 2, got {n}")
    if root is None:
        root = hostfield.get_root_of_unity(n)
    half = n // 2
    table = tiles.power_series(root, half, values.device)
    pair = torch.arange(half, device=values.device)
    x = values
    for s in range(n.bit_length() - 1):
        w = table.index_select(0, (pair >> s) << s)
        even, odd = butterfly_stage(x[:half], x[half:], w)
        x = torch.stack([even, odd], dim=1).reshape(n, 4)
    return x.index_select(0, _bitrev(n, values.device))
