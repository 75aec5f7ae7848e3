"""The 256-point leaf NTT as byte-limb matrix products: kernel K16
(leaf256), its wrapper and plain version.

The port's counterpart of distaff_tpu/ops/mxu_ntt.py, whose name it keeps.
The JAX module puts the leaf's multiplies on the TPU's matrix unit (bf16
products, f32 sums); here that unit is Hopper's int8 tensor cores
(mma.sync m16n8k32, u8 x u8 products, s32 sums), the same exact products.

A 256-point NTT is two stages of 16-point DFTs (n = i1 + 16 i2, k = k2 + 16
k1):

    A[b, i1, k2]       = sum_i2 W[k2, i2] x[b, i1 + 16 i2],   W[k2, i2] = w16^(i2 k2)
    X[b, 16 k1 + k2]   = sum_i1 C[k2][k1, i1] A[b, i1, k2],   C[k2][k1, i1] = w16^(k1 i1) w^(i1 k2)

with w16 = w^16: the twiddles ride in the sixteen stage-B matrices.  Split
into bytes, a field product is a convolution of limbs: with BIGMAT[(i, d),
(j, q)] = byte d - q of m[i, j], one unsigned-byte matrix product gives the
31 digits (weights 2^(8d), each < 16 * 16 * 255^2 < 2^24) of every output
element, and 31 digits reduce mod M once.

K16 `leaf256` (csrc/leaf256.cu, leaf256.cuh) replaces distaff_tpu/ops/
mxu_ntt.py::_leaf256_impl with its _matrices and _reduce_digits: both
stages of a tile of 8 leaves in one launch, stage A's elements kept in
shared memory for stage B.  It reads the same products the other way
round: the matrix's 16 byte planes side by side are one fixed A operand
(`kernel_entries` lays them out in mma's fragment order), and digit d takes
the window of the data's planes d, d - 1, ..., d - 15 as B, so the k-steps
that meet no plane are skipped and each lane reduces the digits of its own
elements; design and bound in the header.  Like the JAX function it is off
the prover's path (the prover's leaves are K1's): the kernel bench and
chip_smoke.py drive it.

`leaf_ntt256` takes its plain version for a tensor on the CPU and launches
K16 for a tensor on the card, or raises.  The plain version is the JAX
algorithm on int64 tensors (the byte products summed as float64 matrix
products, exact: every sum is below 2^24), so it launches nothing on any
device.
"""

import ctypes

import numpy as np
import torch

from ..math import field as hostfield
from . import cuda_lib
from . import field_kernels as fk

M = hostfield.M
N1 = 16
N2 = 16
LEAF = N1 * N2          # 256
DIGITS = 31             # output digits of a 16 x 16-byte limb convolution
_R2 = (1 << 256) % M    # 2^256 mod M, < 2^91
_R2_HALFWORDS = tuple((_R2 >> (16 * k)) & 0xFFFF for k in range(6))
KSTEPS = 8              # leaf256.cuh kKSteps: 32-byte k-steps, planes 2kk and 2kk + 1
PLAIN_CHUNK = 4096      # leaves a step of the plain version

# by (root, device): the stage matrices as bytes, and K16's entries
_MATRICES = {}
_ENTRIES = {}


def stage_entries(root256_int):
    """The field entries of the stage matrices for the root w: W (16, 16),
    W[k2][i2] = w16^(i2 k2), and C (16, 16, 16), C[k2][k1][i1] =
    w16^(k1 i1) w^(i1 k2), as Python ints."""
    w = int(root256_int) % M
    w16 = pow(w, N1, M)
    wa = [[pow(w16, i2 * k2, M) for i2 in range(N2)] for k2 in range(N2)]
    c = [[[pow(w16, k1 * i1, M) * pow(w, i1 * k2, M) % M for i1 in range(N1)]
          for k1 in range(N1)] for k2 in range(N2)]
    return wa, c


def _entry_bytes(entries):
    """Nested lists of field ints -> (..., 16) uint8 little-endian bytes."""
    flat = np.asarray(entries, dtype=object).reshape(-1)
    raw = b"".join(int(v).to_bytes(16, "little") for v in flat)
    shape = np.asarray(entries, dtype=object).shape
    return np.frombuffer(raw, dtype=np.uint8).reshape(*shape, 16)


def _bigmat(limbs8):
    """(rows, cols, 16) entry bytes -> BIGMAT (rows * DIGITS, cols * 16)
    uint8 with BIGMAT[(i, d), (j, q)] = byte d - q of entry (i, j)."""
    rows, cols = limbs8.shape[:2]
    out = np.zeros((rows, DIGITS, cols, 16), dtype=np.uint8)
    for q in range(16):
        out[:, q:q + 16, :, q] = limbs8.transpose(0, 2, 1)
    return out.reshape(rows * DIGITS, cols * 16)


def _matrices(root256_int, device):
    """The stage matrices for the root, as the JAX _matrices gives them
    (there as bf16): (A (496, 256), B (16, 496, 256)) uint8 on `device`,
    A[(k2, d), (i2, q)] = byte d - q of W[k2][i2] and B[k2][(k1, d), (i1,
    q)] = byte d - q of C[k2][k1][i1]."""
    key = (int(root256_int) % M, str(torch.device(device)))
    if key not in _MATRICES:
        wa, c = stage_entries(root256_int)
        a_mat = _bigmat(_entry_bytes(wa))
        b_mat = np.stack([_bigmat(_entry_bytes(ck)) for ck in c])
        _MATRICES[key] = (torch.from_numpy(a_mat).to(device), torch.from_numpy(b_mat).to(device))
    return _MATRICES[key]


def fragments(limbs8):
    """(m, 16, 16, 16) entry bytes [m, i, j, p] -> K16's A fragments of
    each matrix: (m, 8, 32, 4) uint32, [m, kk, lane, r] the word of mma's
    register a_r at k-step kk for lane (g, t) = (lane // 4, lane % 4): row
    g + 8 (r % 2) of the planes side by side, byte e plane 2kk + r // 2 of
    entry (row, 4t + e)."""
    kk, g, t, r, e = np.indices((KSTEPS, 8, 4, 4, 4))
    words = limbs8[:, g + 8 * (r & 1), 4 * t + e, 2 * kk + (r >> 1)]
    return np.ascontiguousarray(words).view(np.uint32).reshape(limbs8.shape[0], KSTEPS, 32, 4)


def kernel_entries(root256_int, device):
    """K16's matrices: W then C[0..15] as their A fragments, (17, 8, 32, 4)
    uint32 on `device` (`fragments`)."""
    key = (int(root256_int) % M, str(torch.device(device)))
    if key not in _ENTRIES:
        wa, c = stage_entries(root256_int)
        _ENTRIES[key] = torch.from_numpy(fragments(_entry_bytes([wa] + c))).to(device)
    return _ENTRIES[key]


def _bytes16(limbs):
    """(..., 4) int64 limbs -> (..., 16) int64 bytes, little-endian."""
    return torch.stack([(limbs[..., k] >> (8 * b)) & 0xFF for k in range(4) for b in range(4)],
                       -1)


def _reduce_digits_plain(digits):
    """(DIGITS, ...) int64 digits, each in [0, 2^32) -> (..., 4) uint32
    canonical field elements of sum_d digits[d] 2^(8d) mod M.  The JAX
    _reduce_digits on int64 halfword columns: the digits at their bit
    offsets (digit d at 16 (d // 2) + 8 (d % 2)), one carry sweep into 18
    halfwords (the value is below 2^273), the bits from 2^256 up folded
    back twice as multiples of R^2 = 2^256 mod M, then the 256-bit
    reduction of K2's plain multiply."""
    cols = [0] * 18
    for d in range(DIGITS):
        cols[d // 2] = cols[d // 2] + (digits[d] << (8 * (d % 2)))
    h = fk._normalize(cols, 18)
    p = fk._normalize(fk._plus(h[:16], fk._product_columns(h[16:], _R2_HALFWORDS)), 17)
    # p < 2^256 + 2^108: bit 256 is 0 or 1, and where it is 1 the rest is small
    p = fk._normalize(fk._plus(p[:16], [p[16] * r for r in _R2_HALFWORDS]), 16)
    return fk._reduce256(p).to(torch.uint32)


def _leaf_plain(x, a_mat, b_mat):
    """(b, 256, 4) int64 limbs -> (b, 256, 4) uint32: _leaf256_impl's steps,
    the matrices as float64."""
    b = x.shape[0]
    x8 = _bytes16(x.view(b, N2, N1, 4))                            # [b, i2, i1, q]
    lhs = x8.permute(1, 3, 0, 2).reshape(N2 * 16, b * N1)          # (i2, q) x (b, i1)
    pa = (a_mat @ lhs.to(torch.float64)).to(torch.int64)           # (496, b * 16)
    a_limbs = _reduce_digits_plain(pa.view(N2, DIGITS, b, N1).permute(1, 2, 3, 0))
    a8 = _bytes16(a_limbs.to(torch.int64))                         # [b, i1, k2, q]
    rhs = a8.permute(2, 1, 3, 0).reshape(N2, N1 * 16, b)           # (k2, (i1, q), b)
    pb = torch.bmm(b_mat, rhs.to(torch.float64)).to(torch.int64)   # (k2, (k1, d), b)
    out = _reduce_digits_plain(pb.view(N2, N1, DIGITS, b).permute(2, 3, 1, 0))
    return out.reshape(b, LEAF, 4)


def leaf_ntt256_plain(values, root256_int):
    """K16's function on plain tensors: (B, 256, 4) uint32 limbs ->
    natural-order 256-point NTT along axis 1 at the root, PLAIN_CHUNK
    leaves a step."""
    _check(values)
    a_mat, b_mat = (m.to(torch.float64) for m in _matrices(root256_int, values.device))
    x = values.to(torch.int64)
    out = torch.empty_like(values)
    for start in range(0, values.shape[0], PLAIN_CHUNK):
        out[start:start + PLAIN_CHUNK] = _leaf_plain(x[start:start + PLAIN_CHUNK], a_mat, b_mat)
    return out


def _check(values):
    if values.dim() != 3 or tuple(values.shape[1:]) != (LEAF, 4) or values.dtype != torch.uint32:
        raise ValueError(f"leaf_ntt256: expected (B, {LEAF}, 4) uint32 limbs, got "
                         f"{values.dtype} {tuple(values.shape)}")


def leaf_ntt256(values, root256_int):
    """(B, 256, 4) batch-major uint32 limbs -> their natural-order
    256-point NTTs along axis 1 at the 256th root of unity `root256_int`
    (the contract of the JAX leaf_ntt256); one launch of K16 on the card."""
    _check(values)
    if fk._on_cpu(values):
        return leaf_ntt256_plain(values, root256_int)
    cuda_lib.require_limbs("leaf_ntt256", values)
    values = values.contiguous()
    entries = kernel_entries(root256_int, values.device)
    out = torch.empty_like(values)
    if values.shape[0] == 0:
        return out
    code = cuda_lib.lib().distaff_leaf256(
        cuda_lib.ptr(values), cuda_lib.ptr(entries), cuda_lib.ptr(out), values.shape[0],
        cuda_lib.stream(out))
    cuda_lib.check(code, "leaf256")
    cuda_lib.LAUNCHES["leaf256"] += 1
    return out


def resident_warps():
    """Warps of K16 resident on an SM of the current card, by its registers
    and shared memory."""
    blocks, warps = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.lib().distaff_leaf256_blocks_per_sm(ctypes.byref(blocks),
                                                                 ctypes.byref(warps)),
                   "leaf256 occupancy")
    return blocks.value * warps.value


def leaf256_work(leaves):
    """K16's least work for `leaves` leaves: (bytes moved: the leaves read
    and written once, int8 tensor-core operations: the fewest byte products
    the function needs, 16 x 16 x 256 multiply-adds (two operations each)
    an application of a stage matrix to a vector, 32 applications a leaf,
    digit reductions: two an element).  The byte products are not BIGMAT's
    2 x 496 x 256 x 16 a leaf: half of BIGMAT's bytes are zero (256 of its
    496 (d, q) pairs carry a byte), and K16 skips them."""
    return (2 * leaves * LEAF * 16, leaves * 2 * 2 * N2 * (N1 * N1 * 256),
            leaves * 2 * LEAF)
