"""Step 6's kernels, K7 (deep_compose) and K8 (poly_eval): wrappers and
plain versions.

K7 `deep_compose` (csrc/deep_compose.cu, deep_compose.cuh) replaces the
JAX package's distaff_tpu/stark/prover.py::_compose_tiles_batched with the
power series and weighted register sums (distaff_tpu/ops/tiles.py::
_wsum_tile) that feed it: the DEEP composition over the LDE domain in one
launch, reading the LDE in place by bulk asynchronous copies, its two
weighted register sums as one byte-limb product on the int8 tensor cores
(csrc/wsum_product.cuh, shared with K10 and K15), x and x^incr from K1's
cached power tables, and the inverses of (x - z)(x - zg) by Montgomery's
trick over rounds of 8192 points a block.  Bound by bytes; the
composition's 15 multiplies a point set its time.

K8 `poly_eval` (csrc/poly_eval.cu, poly_eval.cuh) replaces
distaff_tpu/stark/prover.py::_ps_points and _poly_eval_tile_multi (driven
by _poly_eval_rows_multi): rows of coefficients at up to four points in
one launch, a Horner sum a thread and a tree a block over each span of
2048 coefficients (16384 in calls from 2^22 coefficients on), scaled to its
place, and the row's last block summing the spans.  Bound by bytes; the
multiplies it issues and, in small calls, latency set its time.

K15 `coeff_wsum` (csrc/coeff_wsum.cu, coeff_wsum.cuh) replaces
distaff_tpu/ops/tiles.py::weighted_register_sum (_wsum_tile) on the trace's
polynomials, as the streaming prover calls it: both of step 6's weighted
register sums over the (R, N) coefficients in one launch, a (2, N) result
that K1 extends to the LDE domain and K7 composes (a weighted sum commutes
with the NTT): K7's ring and tensor-core product with no further
epilogue.  Bound by bytes.

Each wrapper takes its plain version for tensors on the CPU, and launches
the kernel for tensors on the card, or raises.  The plain versions are the
chain the port ran before these kernels (power series, products and sums,
the composition over a batch inverse), on K2's and K6's plain versions, so
they launch nothing on any device: chip_smoke.py holds the kernels against
them on the card.
"""

import ctypes

import torch

from ..math import field as hostfield
from ..math import field_torch as ft
from . import cuda_lib
from . import field_kernels as fk
from . import tiles

M = hostfield.M
POLY_EVAL_LOG_SPAN = 11        # poly_eval.cuh: a block's shortest span of a row, 2^(8 + 3)
POLY_EVAL_MAX_POINTS = 4       # poly_eval.cuh kMaxPoints
POLY_EVAL_SQUARINGS = 32       # poly_eval.cuh kSquarings: x^(2^k) for k < 32
COEFF_WSUM_MAX_REGISTERS = 128  # wsum_product.cuh kMaxRegisters
WSUM_PRODUCT_ROWS = 64          # wsum_product.cuh: A's rows for two sums, 31 digits and a 0 row each
LOG_LO = tiles._LOG_LO         # K1's power tables (tiles._store_factors): lo holds 2^LOG_LO


def sum_plain(a, axis):
    """Modular sum along an axis, a log-depth tree of K2's plain add."""
    x = a.movedim(axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = fk.add_plain(x[:half], x[half : 2 * half])
        if x.shape[0] % 2:
            s = torch.cat([s, x[2 * half :]])
        x = s
    return x[0]


# ------------------------------------------------------------------------------------------------
# K8 poly_eval
# ------------------------------------------------------------------------------------------------

def poly_eval_plain(polys, points):
    """(P, R, 4) values at each host-int point of the rows of (R, L, 4)
    coefficients: each point's power series times the rows, summed."""
    length = polys.shape[1]
    ps = torch.stack([fk.power_series_plain(x, length, polys.device) for x in points])
    return sum_plain(fk.mul_plain(polys[None], ps[:, None]), axis=2)


def poly_eval_launches(points):
    """K8 launches of poly_eval at `points` points: one a group of up to
    POLY_EVAL_MAX_POINTS, whatever the rows' length."""
    return -(-points // POLY_EVAL_MAX_POINTS)


def squaring_words(points):
    """The host words of x_p^(2^k), k < POLY_EVAL_SQUARINGS, for each point:
    K8's __grid_constant__ table."""
    words = []
    for x in points:
        v = int(x) % M
        for _ in range(POLY_EVAL_SQUARINGS):
            words += [(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
            v = v * v % M
    return words


_TICKETS = {}


def _tickets(rows, device):
    """K8's per-row counters on `device`, zero between launches (the row's
    last block resets its own): allocated once a device and stream (the
    launches that share them run one after another on it), grown when
    needed."""
    key = cuda_lib.stream_key(device)
    if key not in _TICKETS or _TICKETS[key].shape[0] < rows:
        _TICKETS[key] = torch.zeros(max(rows, 64), dtype=torch.int32, device=device)
    return _TICKETS[key]


def evaluate_group(polys, points, launch):
    """One K8 launch for up to POLY_EVAL_MAX_POINTS points over the rows of
    polys (R, L, 4): launch(polys, out, partial, tickets, length, rows,
    count, words) runs it, with out (R, count, 4), partial (R, count,
    ceil(L / 2048), 4) the blocks' scratch (for the shortest span) and words
    squaring_words(points).
    Returns (count, R, 4)."""
    rows, length = polys.shape[0], polys.shape[1]
    count = len(points)
    blocks = -(-length >> POLY_EVAL_LOG_SPAN)
    out = torch.empty((rows, count, 4), dtype=torch.uint32, device=polys.device)
    partial = torch.empty((rows, count, blocks if blocks > 1 else 0, 4), dtype=torch.uint32,
                          device=polys.device)
    launch(polys, out, partial, _tickets(rows, polys.device), length, rows, count,
           squaring_words(points))
    return out.transpose(0, 1)


def _launch(polys, out, partial, tickets, length, rows, count, words):
    code = cuda_lib.lib().distaff_poly_eval(
        cuda_lib.ptr(polys), cuda_lib.ptr(out), cuda_lib.ptr(partial), cuda_lib.ptr(tickets),
        length, rows, count, (ctypes.c_uint32 * len(words))(*words), cuda_lib.stream(out))
    cuda_lib.check(code, "poly_eval")
    cuda_lib.LAUNCHES["poly_eval"] += 1


def poly_eval(polys, points):
    """T_r(x_p) for the rows of (R, L, 4) uint32 coefficients (low degree
    first) at host-int points: (P, R, 4) limbs on the device of polys."""
    points = [int(x) % M for x in points]
    if polys.dim() != 3 or polys.shape[1] < 1 or not points:
        raise ValueError(f"poly_eval: expected (R, L, 4) coefficients and a point, got "
                         f"{tuple(polys.shape)} and {len(points)} points")
    if fk._on_cpu(polys):
        return poly_eval_plain(polys, points)
    cuda_lib.require_limbs("poly_eval", polys)
    polys = polys.contiguous()
    groups = [evaluate_group(polys, points[k : k + POLY_EVAL_MAX_POINTS], _launch)
              for k in range(0, len(points), POLY_EVAL_MAX_POINTS)]
    return groups[0] if len(groups) == 1 else torch.cat(groups)


# ------------------------------------------------------------------------------------------------
# K7 deep_compose
# ------------------------------------------------------------------------------------------------

def deep_compose_ops(regs):
    """K7's work a point at its leanest, from its code: (byte operations of
    the int8 product, digit reductions, multiplies, adds, subtractions).
    The product is A's 64 rows (two sums of 31 digits and a 0 row each) by
    the point's 16R value bytes, 2 operations a byte product; each sum is
    one f128::reduce_digits; forward: x and x^incr from their tables (2
    multiplies), d = (x - z)(x - zg) (1, 2 subtractions), the numerator (6
    multiplies, 3 adds, 3 subtractions), y = N q and q d (2); backward: x
    and d again (2, 2 subtractions), N / d = y / q and 1/q d (2).  The
    block's inversion a round of 8192 points is left out."""
    return 2 * WSUM_PRODUCT_ROWS * 16 * regs, 2, 15, 3, 7


def weighted_sum_plain(lde, weights):
    """sum_r weights[r] lde[r] over (R, n, 4) on K2's plain versions."""
    total = fk.mul_plain(lde[0], weights[0])
    for r in range(1, lde.shape[0]):
        total = fk.add_plain(total, fk.mul_plain(lde[r], weights[r]))
    return total


def coeff_wsum_plain(polys, w1, w2):
    """coeff_wsum's function on plain tensors: the two weighted sums on
    K2's plain versions."""
    return torch.stack([weighted_sum_plain(polys, w1), weighted_sum_plain(polys, w2)])


def coeff_wsum(polys, w1, w2):
    """(2, N, 4): sum_r w1[r] polys[r] and sum_r w2[r] polys[r] over the
    rows of (R, N, 4) limbs, w1 and w2 (R, 4); one launch of K15 on the card."""
    regs, n = polys.shape[0], polys.shape[1]
    if polys.dim() != 3 or w1.shape != (regs, 4) or w2.shape != w1.shape or \
            not 1 <= regs <= COEFF_WSUM_MAX_REGISTERS:
        raise ValueError(f"coeff_wsum: expected (R <= {COEFF_WSUM_MAX_REGISTERS}, N, 4) rows and "
                         f"(R, 4) weights, got {tuple(polys.shape)}, {tuple(w1.shape)} and "
                         f"{tuple(w2.shape)}")
    if fk._on_cpu(polys, w1, w2):
        return coeff_wsum_plain(polys, w1, w2)
    cuda_lib.require_limbs("coeff_wsum", polys, w1, w2)
    if polys.stride(1) != 4:
        raise ValueError("coeff_wsum: each register's coefficients must be contiguous")
    w1, w2 = w1.contiguous(), w2.contiguous()
    out = torch.empty((2, n, 4), dtype=torch.uint32, device=polys.device)
    code = cuda_lib.lib().distaff_coeff_wsum(
        cuda_lib.ptr(polys), polys.stride(0) // 4, regs, n, cuda_lib.ptr(w1), cuda_lib.ptr(w2),
        cuda_lib.ptr(out), cuda_lib.stream(out))
    cuda_lib.check(code, "coeff_wsum")
    cuda_lib.LAUNCHES["coeff_wsum"] += 1
    return out


def coeff_wsum_ops(regs):
    """K15's work a coefficient: (byte operations of the int8 product,
    digit reductions), K7's sums alone."""
    return 2 * WSUM_PRODUCT_ROWS * 16 * regs, 2


def deep_compose_plain(lde, c_lde, w1, w2, root, incr, scalars, start=0):
    """deep_compose's function on plain tensors: the weighted sums, the
    power series of x and x^incr and the composition over one batch
    inverse of (x - z)(x - zg), on K2's and K6's plain versions.  With
    `start`, the inputs are the points x = root^(start + i) of a larger
    domain, and the result is deep_compose's there."""
    n, device = lde.shape[1], lde.device
    z, zg, s1, s2, c_at_z, k1, k2, kc = (ft.constant(v, device) for v in scalars)
    a1 = weighted_sum_plain(lde, w1)
    a2 = weighted_sum_plain(lde, w2)
    root_incr = pow(int(root), int(incr), M)
    xs = fk.power_series_plain(root, n, device, pow(int(root), start, M))
    x_incr = fk.power_series_plain(root_incr, n, device, pow(root_incr, start, M))
    mul, add, sub = fk.mul_plain, fk.add_plain, fk.sub_plain

    xz = sub(xs, z)
    xzg = sub(xs, zg)
    w = fk.inv_batch_plain(mul(xz, xzg))
    u = mul(w, xzg)
    v = mul(w, xz)
    base = add(mul(sub(a1, s1), u), mul(sub(a2, s2), v))
    composed = add(mul(base, k1), mul(mul(base, x_incr), k2))
    return add(composed, mul(mul(sub(c_lde, c_at_z), u), kc))


def compose_table_keys(n, root, incr, device):
    """The keys of K7's power tables over n points: x = root^i and
    x^incr."""
    return [tiles.factors_key(n, root, 1, device),
            tiles.factors_key(n, pow(int(root), int(incr), M), 1, device)]


def compose_args(lde, root, incr, scalars, domain=None):
    """K7's arguments after the pointers' tensors: (lde stride, regs, n,
    tables (x lo, x hi, x^incr lo, x^incr hi; hi None up to 1024 points),
    the scalars as 32 host words); the tables cover `domain` points
    (default n)."""
    n = lde.shape[1]
    (x_lo, x_hi), (i_lo, i_hi) = tiles.tables(
        compose_table_keys(domain or n, root, incr, lde.device))
    words = [(int(v) % M >> (32 * k)) & 0xFFFFFFFF for v in scalars for k in range(4)]
    return lde.stride(0) // 4, lde.shape[0], n, (x_lo, x_hi, i_lo, i_hi), words


def deep_compose(lde, c_lde, w1, w2, root, incr, scalars, first=0, domain=None):
    """The DEEP composition over the n = lde.shape[1] points x = root^i of
    the LDE domain (n a power of two): lde (R, n, 4) register evaluations, c_lde (n, 4) the
    constraint polynomial's, w1 and w2 (R, 4) the weights of A1 and A2,
    incr the exponent of x's degree adjustment and scalars the host ints
    (z, zg, s1, s2, c(z), k1, k2, kc).  Returns (n, 4) limbs.  On a slot
    of a mesh the inputs are the points [first, first + n) of a domain of
    `domain` points (a power of two), and so is the result."""
    if len(scalars) != 8 or lde.dim() != 3 or c_lde.shape != lde.shape[1:] or \
            w1.shape != (lde.shape[0], 4) or w2.shape != w1.shape:
        raise ValueError(f"deep_compose: shapes {tuple(lde.shape)}, {tuple(c_lde.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} and {len(scalars)} scalars")
    n = lde.shape[1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"deep_compose: the domain's size must be a power of two, got {n}")
    domain = n if domain is None else domain
    if first < 0 or first + n > domain or domain & (domain - 1):
        raise ValueError(f"deep_compose: points [{first}, {first + n}) of {domain}")
    if fk._on_cpu(lde, c_lde, w1, w2):
        return deep_compose_plain(lde, c_lde, w1, w2, root, incr, scalars, first)
    cuda_lib.require_limbs("deep_compose", lde, c_lde, w1, w2)
    c_lde, w1, w2 = c_lde.contiguous(), w1.contiguous(), w2.contiguous()
    if lde.stride(1) != 4:
        raise ValueError("deep_compose: each register's points must be contiguous")
    stride, regs, n, tables, words = compose_args(lde, root, incr, scalars, domain)
    out = torch.empty((n, 4), dtype=torch.uint32, device=lde.device)
    nul = ctypes.c_void_p(None)
    code = cuda_lib.lib().distaff_deep_compose(
        cuda_lib.ptr(lde), stride, regs, n, cuda_lib.ptr(c_lde), cuda_lib.ptr(w1),
        cuda_lib.ptr(w2), *[nul if t is None else cuda_lib.ptr(t) for t in tables], LOG_LO,
        (ctypes.c_uint32 * 32)(*words), cuda_lib.ptr(out), first, cuda_lib.stream(out))
    cuda_lib.check(code, "deep_compose")
    cuda_lib.LAUNCHES["deep_compose"] += 1
    return out
