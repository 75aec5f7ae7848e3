"""Step 3's boundary columns: kernel K10 (boundary_columns), its wrapper
and plain version.

K10 `boundary_columns` (csrc/boundary_columns.cu, boundary_columns.cuh)
replaces the JAX package's distaff_tpu/stark/prover.py::
_evaluate_boundaries_device with its weighted register sums (distaff_tpu/
ops/tiles.py::_wsum_tile) and x^b power series: the first- and last-step
boundary columns over the evaluation domain in one launch, reading the
LDE's stride slice in place and x^b from K1's kind of power tables.  The
four weighted register sums of a tile of points are one unsigned-byte
matrix product on the int8 tensor cores (the weights' Toeplitz byte
expansion times the values' bytes), each sum's 31 digit sums reduced once.
Bound by bytes; see the source for the design.

The wrapper takes the plain version for tensors on the CPU, and launches
the kernel for tensors on the card, or raises.  The plain version is the
chain the port ran before K10 (four weighted sums, the power series of x^b,
the constants), on K2's plain versions, so it launches nothing on any
device.
"""

import ctypes

import numpy as np
import torch

from ..math import field as hostfield
from ..math import field_torch as ft
from . import cuda_lib
from . import field_kernels as fk
from . import tiles
from .deep_kernels import weighted_sum_plain

M = hostfield.M
MAX_REGISTERS = 128          # boundary_columns.cuh kMaxRegisters


def boundary_ops(regs):
    """K10's work a point at its leanest, from its code: (byte operations of
    the int8 product, digit reductions, multiplies, adds).  The product is
    A's 128 rows (four sums of 31 digits, one padding row each) by the
    point's 16R value bytes, 2 operations a byte product; each of the four
    sums is one f128::reduce_digits; x^b's table lookup and the two x^b
    products are 3 multiplies, the four constants and the two last sums 6
    adds."""
    return 2 * 128 * 16 * regs, 4, 3, 6


def boundary_columns_plain(lde, i_parts, f_parts, xb_root, start=0):
    """boundary_columns' function on plain tensors: for each of i_parts and
    f_parts = (w1, w2, c1, c2) host ints, sum_r w1_r lde[r] + c1 + x^b
    (sum_r w2_r lde[r] + c2) with x^b = xb_root^k, on K2's plain versions.
    With `start`, the points are k = start + i of a larger domain."""
    n, device = lde.shape[1], lde.device
    xb = fk.power_series_plain(xb_root, n, device, pow(int(xb_root), start, M))

    def combine(parts):
        w1, w2, c1, c2 = parts
        s1 = weighted_sum_plain(lde, ft.from_ints(np.array(w1, dtype=object), device))
        s2 = weighted_sum_plain(lde, ft.from_ints(np.array(w2, dtype=object), device))
        base = fk.add_plain(s1, ft.constant(c1, device))
        adj = fk.add_plain(s2, ft.constant(c2, device))
        return fk.add_plain(base, fk.mul_plain(xb, adj))

    return combine(i_parts), combine(f_parts)


def boundary_table_keys(n, xb_root, device):
    """The keys of K10's power tables over n points: x^b = xb_root^k."""
    return [tiles.factors_key(n, xb_root, 1, device)]


def boundary_args(lde, i_parts, f_parts, xb_root, domain=None):
    """K10's arguments beside the LDE: the (4, R) weights w1i, w2i, w1f,
    w2f as 16R host words (a kernel parameter, like the constants), x^b's
    tables over `domain` points (default the LDE's; lo, hi; hi None up to
    1024 points) and the four constants as 16 host words."""
    weights = (i_parts[0], i_parts[1], f_parts[0], f_parts[1])
    weight_words = [(int(v) % M >> (32 * k)) & 0xFFFFFFFF for row in weights for v in row
                    for k in range(4)]
    tables, = tiles.tables(boundary_table_keys(domain or lde.shape[1], xb_root, lde.device))
    constants = (i_parts[2], i_parts[3], f_parts[2], f_parts[3])
    words = [(int(v) % M >> (32 * k)) & 0xFFFFFFFF for v in constants for k in range(4)]
    return weight_words, tables, words


def boundary_columns(lde, i_parts, f_parts, xb_root, first=0, domain=None):
    """The first- and last-step boundary columns over the n = lde.shape[1]
    points k of D_ev (n a power of two): lde (R, n, 4) registers, any point
    stride (the LDE's stride slice, read in place); i_parts and f_parts the
    (w1, w2, c1, c2) host ints of evaluator.boundary_weight_vectors; x^b at
    point k = xb_root^k.  Returns the two (n, 4) columns.  On a slot of a
    mesh lde holds the points [first, first + n) of a domain of `domain`
    points (a power of two), and the columns are theirs."""
    regs, n = lde.shape[0], lde.shape[1]
    if lde.dim() != 3 or n < 1 or n & (n - 1) or not 1 <= regs <= MAX_REGISTERS or any(
            len(parts[0]) != regs or len(parts[1]) != regs for parts in (i_parts, f_parts)):
        raise ValueError(f"boundary_columns: expected (R <= {MAX_REGISTERS}, n a power of two, "
                         f"4) registers and R weights a sum, got {tuple(lde.shape)}")
    domain = n if domain is None else domain
    if first < 0 or first + n > domain or domain & (domain - 1):
        raise ValueError(f"boundary_columns: points [{first}, {first + n}) of {domain}")
    if fk._on_cpu(lde):
        return boundary_columns_plain(lde, i_parts, f_parts, xb_root, first)
    cuda_lib.require_limbs("boundary_columns", lde)
    weights, (lo, hi), words = boundary_args(lde, i_parts, f_parts, xb_root, domain)
    out = torch.empty((2, n, 4), dtype=torch.uint32, device=lde.device)
    code = cuda_lib.lib().distaff_boundary_columns(
        cuda_lib.ptr(lde), lde.stride(0) // 4, lde.stride(1) // 4, regs, n,
        (ctypes.c_uint32 * len(weights))(*weights),
        cuda_lib.ptr(lo), ctypes.c_void_p(None) if hi is None else cuda_lib.ptr(hi),
        tiles._LOG_LO, (ctypes.c_uint32 * 16)(*words), cuda_lib.ptr(out), first,
        cuda_lib.stream(out))
    cuda_lib.check(code, "boundary_columns")
    cuda_lib.LAUNCHES["boundary_columns"] += 1
    return out[0], out[1]
