"""distaff_torch's FRI fold (kernel K9) and step 3's boundary columns
(kernel K10) on the CPU: the wrappers' plain versions against the JAX
package's fri_jax.fold_rows and prover._evaluate_boundaries_device,
fri.reduce's layer roots against the JAX package's host FRI (quartic
interpolation and host Merkle trees), and both kernels' bodies built with
g++ from their headers and run against the plain versions: K9 a thread at
a time, K10 a block at a time with its tensor-core product through the
emulation of ldmatrix and mma in tests/torch_mma_host.h, and its Toeplitz product against weighted
sums in Python integers.  Exact equality throughout (integer field
arithmetic).  Each JAX function is compiled once, at one shape, for all of
its cases."""

import ctypes
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distaff_tpu.crypto.blake3 import blake3_batch
from distaff_tpu.crypto.merkle import MerkleTree
from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.math import quartic
from distaff_tpu.ops import fri_jax
from distaff_tpu.stark import prover as jax_prover
from distaff_tpu.utils import rand as jax_rand
from distaff_torch import ProofOptions
from distaff_torch.crypto import merkle_dev
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import blake3_torch
from distaff_torch.ops import boundary_kernels as bk
from distaff_torch.ops import field_kernels as fk
from distaff_torch.ops import fri_torch, tiles
from distaff_torch.stark import fri, prover

M = jax_host_field.M
CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"
TESTS = Path(__file__).resolve().parent          # torch_mma_host.h: the tensor-core emulation
SPECIAL_X = 0x0BAD_CAFE_F00D_1234_5678_9ABC_DEF0_1357 % M


def _ints(count, rng):
    return [int.from_bytes(rng.bytes(16), "little") % M for _ in range(count)]


def _limbs(ints):
    return ft.from_ints(np.array(ints, dtype=object), "cpu")


def _root(n):
    return jax_host_field.get_root_of_unity(n)


# ------------------------------------------------------------------------------------------------
# K9 fri_fold
# ------------------------------------------------------------------------------------------------

# (q, root of the nodes x0 = w^i): a layer of 16 points at its own root, and
# 300 rows at the nodes of a 2^11-point domain (not a layer: the wrapper
# takes power-of-two layers only, the plain version any rows)
FOLD_CASES = ((4, _root(16)), (300, _root(1 << 11)))


@pytest.fixture(scope="module")
def jax_folds():
    """fri_jax.fold_rows over the rows of both FOLD_CASES at once (one XLA
    compile), x0 = w^i and x0^-3 = w^-3i from the JAX package's power
    series; returns [(column, folded rows as ints)] per case."""
    rng = np.random.default_rng(9)
    columns, ys, x0, inv3 = [], [], [], []
    for q, w in FOLD_CASES:
        column = _ints(4 * q, rng)
        columns.append(column)
        ys += [[column[i + j * q] for j in range(4)] for i in range(q)]
        x0.append(fj.power_series(w, q))
        inv3.append(fj.power_series(pow(jax_host_field.inv(w), 3, M), q))
    got = fri_jax.fold_rows(fj.from_ints(np.array(ys, dtype=object)), jnp.concatenate(x0),
                            jnp.concatenate(inv3), fj.constant(SPECIAL_X))
    folded = fj.to_ints(got).tolist()
    out, start = [], 0
    for (q, _), column in zip(FOLD_CASES, columns):
        out.append((column, folded[start:start + q]))
        start += q
    return out


def test_fri_fold_matches_jax_fold_rows_at_the_layers_root(jax_folds):
    # the wrapper at the layer's own root, and at a root of a 4x larger
    # domain with stride 4 (as fri.reduce passes the LDE domain's root)
    column, want = jax_folds[0]
    got = fri_torch.fri_fold(_limbs(column), SPECIAL_X, FOLD_CASES[0][1])
    assert ft.to_ints(got).tolist() == want
    got = fri_torch.fri_fold(_limbs(column), SPECIAL_X, _root(64), stride=4)
    assert ft.to_ints(got).tolist() == want


def test_fri_fold_plain_matches_jax_fold_rows_over_300_rows(jax_folds):
    column, want = jax_folds[1]
    got = fri_torch.fri_fold_plain(_limbs(column), SPECIAL_X, FOLD_CASES[1][1])
    assert ft.to_ints(got).tolist() == want
    # a window of rows, as chip_smoke.py holds the kernel a piece at a time
    part = fri_torch.fri_fold_plain(_limbs(column), SPECIAL_X, FOLD_CASES[1][1], rows=(100, 220))
    assert ft.to_ints(part).tolist() == want[100:220]


def _host_reduce(values, root):
    """The JAX package's host FRI: each layer's rows hashed into a host
    Merkle tree, and interpolated and evaluated at the point drawn from its
    root (reference src/stark/fri/prover.rs).  Returns the layer roots and
    the last layer's rows."""
    roots = []
    while True:
        q = len(values) // 4
        rows = [[values[i + j * q] for j in range(4)] for i in range(q)]
        limbs = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for v in row for k in range(4)]
                          for row in rows], dtype=np.uint32)
        tree = MerkleTree(blake3_batch(limbs.view(np.uint8)), "blake3")
        roots.append(tree.root())
        if len(values) <= fri.MAX_REMAINDER_LENGTH:
            return roots, rows
        xs = [[pow(root, i + j * q, M) for j in range(4)] for i in range(q)]
        special_x = jax_rand.prng(tree.root(), M)
        values = quartic.evaluate_batch(quartic.interpolate_batch(xs, rows), special_x)
        root = pow(root, 4, M)


def test_reduce_gives_the_jax_packages_host_layer_roots(monkeypatch):
    n = 1 << 12
    values = _ints(n, np.random.default_rng(12))
    want_roots, want_rows = _host_reduce(values, _root(n))
    folds, parts = [], []
    real = fri_torch.fri_fold

    def counted(*args, **kwargs):
        folds.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(fri_torch, "fri_fold", counted)
    trees, layers = fri.reduce(_limbs(values), _root(n), ProofOptions(), parts.append)
    assert [tree.root() for tree in trees] == want_roots
    assert ft.to_ints(layers[-1]).tolist() == want_rows
    # one fold a layer, each over the previous layer's column; the parts in order
    assert folds == [n, n // 4]
    assert parts == ["layer trees"] + ["root draws", "folds (K9)", "layer trees"] * 2
    assert set(parts) == set(fri.PARTS)


@pytest.mark.parametrize("hash_fn", ["blake3", "sha3"])
def test_reduce_commits_the_folds_leaf_digests(monkeypatch, hash_fn):
    # with blake3 each folded layer's tree is built from the digests that
    # the fold returns (leaves=True), and K3 hashes the first layer's rows
    # alone; its roots are those of the layer rows hashed as before.  Any
    # other hash takes the fold without digests and hashes the rows itself.
    n = 1 << 12
    values = _limbs(_ints(n, np.random.default_rng(13)))
    options = ProofOptions(hash_fn=hash_fn)
    calls, hashed = [], []
    real_fold, real_hash = fri_torch.fri_fold, blake3_torch.hash_rows

    def fold(*args, **kwargs):
        calls.append(kwargs.get("digests", False))
        return real_fold(*args, **kwargs)

    def hash_rows(rows, out=None):
        hashed.append(rows.shape[0])
        return real_hash(rows, out)

    monkeypatch.setattr(fri_torch, "fri_fold", fold)
    monkeypatch.setattr(merkle_dev, "hash_rows", hash_rows)
    trees, layers = fri.reduce(values, _root(n), options)
    assert calls == [hash_fn == "blake3"] * 2
    assert hashed == ([n // 4] if hash_fn == "blake3" else [])
    for tree, rows in zip(trees, layers):
        assert tree.root() == merkle_dev.commit(rows, hash_fn).root()


# ------------------------------------------------------------------------------------------------
# K10 boundary_columns
# ------------------------------------------------------------------------------------------------

N_EV = 64


class _Evaluator:
    """What both packages' _evaluate_boundaries_device read of an
    evaluator, with seeded weights and constants."""

    def __init__(self, regs, seed):
        rng = np.random.default_rng(seed)
        self.domain_size = N_EV
        self.b_degree_adj = 37
        self.parts = tuple((_ints(regs, rng), _ints(regs, rng), *_ints(2, rng)) for _ in range(2))

    def boundary_weight_vectors(self, register_count):
        assert register_count == len(self.parts[0][0])
        return self.parts


class _Trace:
    def __init__(self, lde_dev, stride):
        self.lde_dev = lde_dev
        self.streaming = False
        self.stride = stride

    def ev_slice(self):
        return self.lde_dev[:, ::self.stride]


@pytest.mark.parametrize("regs,stride", [(5, 4), (11, 2)])
def test_boundary_columns_match_jax_evaluate_boundaries(regs, stride):
    # 5 and 11 registers: the JAX sums pad to groups of 8
    evaluator = _Evaluator(regs, regs)
    rng = np.random.default_rng(stride)
    lde = [_ints(N_EV * stride, rng) for _ in range(regs)]
    want = jax_prover._evaluate_boundaries_device(
        evaluator, _Trace(fj.from_ints(np.array(lde, dtype=object)), stride), stride)
    got = prover._evaluate_boundaries_device(evaluator, _Trace(_limbs(lde), stride))
    for g, w in zip(got, want):
        assert ft.to_ints(g).tolist() == fj.to_ints(w).tolist()


def test_boundary_columns_plain_at_an_offset_matches_the_whole_domain():
    evaluator = _Evaluator(3, 7)
    rng = np.random.default_rng(7)
    lde = _limbs([_ints(N_EV, rng) for _ in range(3)])
    xb = pow(_root(N_EV), 5, M)
    want = bk.boundary_columns_plain(lde, *evaluator.parts, xb)
    for start, stop in ((0, 16), (16, 64), (40, 41)):
        got = bk.boundary_columns_plain(lde[:, start:stop], *evaluator.parts, xb, start=start)
        assert all(torch.equal(g, w[start:stop]) for g, w in zip(got, want))


# ------------------------------------------------------------------------------------------------
# the kernels' bodies on the CPU
# ------------------------------------------------------------------------------------------------

_HARNESS = r"""
#include <cstring>
#include <vector>
#include "boundary_columns.cuh"
#include "fri_fold.cuh"
#include "torch_mma_host.h"

// K9's kernel body on the CPU, a thread at a time, `rows` rows a thread;
// with digests each leaf's words gathered from its lanes as the kernel's
// shuffles gather them
template <int kRows>
static void fold_layer(const fri_fold::Args& a) {
    struct Words {
        uint32_t w[4 * kRows];
    };
    const long long n = fri_fold::threads(a);
    std::vector<Words> own(n);
    for (long long g = 0; g < n; ++g) fri_fold::fold<kRows>(a, g, own[g].w);
    if (!a.digests) return;
    constexpr int kLanes = fri_fold::kLeafRows / kRows;
    for (long long g = 0; g < n; g += kLanes) {
        uint32_t words[4 * fri_fold::kLeafRows];
        for (int l = 0; l < kLanes; ++l)
            for (int w = 0; w < 4 * kRows; ++w) words[4 * kRows * l + w] = own[g + l].w[w];
        fri_fold::hash_leaf(a, g / kLanes, words);
    }
}

extern "C" void fri_fold_host(const void* column, long long q, int rows, const void* lo,
                              const void* hi, int log_lo, long long stride,
                              const uint32_t* constants, void* out, void* digests) {
    fri_fold::Args a{(const uint4*)column, q, rows,
                     (int)(q % 4 ? q : fri_fold::kLeafRows / rows), (const uint4*)lo,
                     (const uint4*)hi, log_lo, stride, {}, (uint4*)out, (uint32_t*)digests};
    std::memcpy(&a.k, constants, sizeof(a.k));
    if (rows == 4)
        fold_layer<4>(a);
    else
        fold_layer<1>(a);
}

namespace bc = boundary_columns;

static void stage_b(const bc::Args& a, const bc::Layout& l, long long tile, int g, uint8_t* b_s) {
    for (int i = 0; i < bc::copies(a, l, g); ++i) {
        int dst;
        const uint4* src = bc::stage_copy(a, l, tile, g, i, dst);
        std::memcpy(b_s + dst, src, 16);
    }
}

// the launcher's Args: the weights' 4 x regs x 4 words into rows of
// kMaxRegisters
static bc::Args boundary_args(const void* lde, long long reg_stride, long long point_stride,
                              int regs, long long n, const uint32_t* weights, const void* xb_lo,
                              const void* xb_hi, int log_lo, const uint32_t* constants,
                              void* out) {
    bc::Args a{(const uint4*)lde, reg_stride, point_stride, regs, n, (const uint4*)xb_lo,
               (const uint4*)xb_hi, log_lo, {}, (uint4*)out, {}};
    std::memcpy(a.c, constants, sizeof(a.c));
    for (int s = 0; s < bc::kSums; ++s)
        std::memcpy(a.w + s * bc::kMaxRegisters, weights + 4 * s * regs, sizeof(uint4) * regs);
    return a;
}

// K10's kernel as the card runs it, the blocks of a grid of `grid` one
// after another: each block's stages (tile, group) in order, the copies of
// the stage stages - 1 on before each stage's product into the ring of
// slots, the eight warps' products through the fragment emulation above,
// the digits over the consumed slot, each thread's sum and then each even
// thread's column
extern "C" void boundary_columns_host(const void* lde, long long reg_stride,
                                      long long point_stride, int regs, long long n,
                                      const uint32_t* weights, const void* xb_lo,
                                      const void* xb_hi, int log_lo, const uint32_t* constants,
                                      void* out, int grid) {
    const bc::Args a = boundary_args(lde, reg_stride, point_stride, regs, n, weights, xb_lo,
                                     xb_hi, log_lo, constants, out);
    const bc::Layout l = bc::layout(regs);
    std::vector<uint8_t> shared(bc::shared_bytes(l));
    uint8_t* const a_s = shared.data();
    uint8_t* const b_s = a_s + l.a_bytes;
    static mma_host::Acc acc[8];
    std::vector<f128::u128> values(bc::kThreads);
    for (int block = 0; block < grid; ++block) {
        bc::Cursor in{block, 0, 0}, at = in;
        auto issue = [&]() {
            if (in.tile < bc::tiles(a)) stage_b(a, l, in.tile, in.g, b_s + in.slot * l.slot_bytes);
            bc::advance(in, l, grid);
        };
        if (l.groups == 1)
            for (int tid = 0; tid < bc::kThreads; ++tid) bc::build_a(a, l, 0, a_s, tid);
        for (int i = 0; i < l.stages - 1; ++i) issue();
        std::memset(acc, 0, sizeof(acc));
        for (; at.tile < bc::tiles(a); bc::advance(at, l, grid)) {
            issue();
            if (l.groups > 1)
                for (int tid = 0; tid < bc::kThreads; ++tid) bc::build_a(a, l, at.g, a_s, tid);
            for (int w = 0; w < 8; ++w)
                mma_host::product(l.pitch, bc::group_regs(a, l, at.g), a_s,
                                  b_s + at.slot * l.slot_bytes, w & 3, w >> 2, acc[w],
                                  bc::PointB{l.pitch});
            if (at.g != l.groups - 1) continue;
            uint32_t* const digits = (uint32_t*)(b_s + at.slot * l.slot_bytes);
            for (int w = 0; w < 8; ++w) mma_host::store_digits<bc::kSums>(acc[w], digits, w & 3, w >> 2);
            for (int tid = 0; tid < bc::kThreads; ++tid)
                values[tid] = bc::sum_value(a, digits, tid);
            for (int tid = 0; tid < bc::kThreads; tid += 2)
                bc::finish(a, at.tile, tid, values[tid], values[tid + 1]);
        }
    }
}

// The four weighted sums of each point, (4, n): D = A B over each register
// group of A and B as build_a and stage_copy lay them out, a plain loop over
// their bytes, the digits summed over the groups and reduced by
// f128::reduce_digits
extern "C" void boundary_sums_host(const void* lde, long long reg_stride,
                                   long long point_stride, int regs, long long n,
                                   const uint32_t* weights, void* out) {
    const uint32_t none[16] = {};
    const bc::Args a = boundary_args(lde, reg_stride, point_stride, regs, n, weights, nullptr,
                                     nullptr, 0, none, nullptr);
    const bc::Layout l = bc::layout(regs);
    std::vector<uint8_t> a_s(l.a_bytes), b_s(l.stage_bytes);
    std::vector<uint32_t> digits(bc::kRows * bc::kTile);
    for (long long tile = 0; tile < bc::tiles(a); ++tile) {
        std::fill(digits.begin(), digits.end(), 0);
        for (int g = 0; g < l.groups; ++g) {
            for (int tid = 0; tid < bc::kThreads; ++tid) bc::build_a(a, l, g, a_s.data(), tid);
            stage_b(a, l, tile, g, b_s.data());
            for (int row = 0; row < bc::kRows; ++row)
                for (int p = 0; p < bc::kTile; ++p)
                    for (int c = 0; c < 32 * wsum::ksteps(bc::group_regs(a, l, g)); ++c)
                        digits[row * bc::kTile + p] +=
                            a_s[row * l.pitch + c] * b_s[p * l.pitch + c];
        }
        for (int s = 0; s < bc::kSums; ++s)
            for (int p = 0; p < bc::kTile && tile * bc::kTile + p < n; ++p)
                ((uint4*)out)[s * n + tile * bc::kTile + p] =
                    f128::to_limbs(f128::reduce_digits(&digits[32 * s * bc::kTile + p], bc::kTile));
    }
}
"""


@pytest.fixture(scope="module")
def kernel_bodies(tmp_path_factory):
    """csrc/fri_fold.cuh and boundary_columns.cuh built with g++ as host
    functions with the kernels' arguments."""
    tmp = tmp_path_factory.mktemp("fri")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC), "-I",
                    str(TESTS), str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, ll, i32, u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(
        ctypes.c_uint32)
    lib.fri_fold_host.argtypes = [vp, ll, i32, vp, vp, i32, ll, u32p, vp, vp]
    lib.boundary_columns_host.argtypes = [vp, ll, ll, i32, ll, u32p, vp, vp, i32, u32p, vp,
                                          i32]
    lib.boundary_sums_host.argtypes = [vp, ll, ll, i32, ll, u32p, vp]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fold_body(lib, column, root, stride, digests, rows):
    """K9's body over a layer of `column`'s points at `rows` rows a thread:
    (folded column, its leaf digests or None)."""
    points = column.shape[0]
    q = points // 4
    lo, hi = tiles._store_factors(points * stride, root, 1, "cpu")
    out = torch.zeros((q, 4), dtype=torch.uint32)
    leaves = torch.zeros((q // 4, 8), dtype=torch.uint32) if digests else None
    lib.fri_fold_host(
        _ptr(column), q, rows, _ptr(lo), _ptr(hi), tiles._LOG_LO, stride,
        (ctypes.c_uint32 * 32)(*fri_torch.fold_words(SPECIAL_X, root, stride, q)), _ptr(out),
        _ptr(leaves))
    return out, leaves


@pytest.mark.parametrize("points,stride,rows", [
    pytest.param(4, 1, 1, id="4-1"),            # one row: a thread of one row
    pytest.param(16, 1, 4, id="16-1"),          # four rows, one thread, x0 from lo alone
    pytest.param(1024, 4, 4, id="1024-4"),      # 256 rows of a 4096-point domain: lo and hi
    pytest.param(4096, 16, 4, id="4096-16"),    # 1024 rows, 2^16-point tables
    pytest.param(16, 1, 1, id="16-1-one-row"),  # one row a thread, four lanes a leaf
    pytest.param(4096, 16, 1, id="4096-16-one-row"),
])
def test_fri_fold_kernel_body_matches_plain(kernel_bodies, points, stride, rows):
    column = _limbs(_ints(points, np.random.default_rng(points + stride)))
    root = _root(points * stride)
    out, _ = _fold_body(kernel_bodies, column, root, stride, False, rows)
    assert torch.equal(out, fri_torch.fri_fold_plain(column, SPECIAL_X, root, stride))


@pytest.mark.parametrize("points,stride,rows", [
    pytest.param(1024, 1, 4, id="1024-1"),
    pytest.param(1024, 4, 4, id="1024-4"),
    pytest.param(1024, 4, 1, id="1024-4-one-row"),
])
def test_fri_fold_kernel_body_leaf_digests_match_plain(kernel_bodies, points, stride, rows):
    # each leaf's four rows (one thread's, or four lanes' gathered) are the
    # next layer's leaf row: its BLAKE3 against K3's plain version over the
    # transposed plain fold
    column = _limbs(_ints(points, np.random.default_rng(points * stride)))
    root = _root(points * stride)
    out, leaves = _fold_body(kernel_bodies, column, root, stride, True, rows)
    want = fri_torch.fri_fold_plain(column, SPECIAL_X, root, stride)
    assert torch.equal(out, want)
    assert torch.equal(leaves, blake3_torch.hash_rows_plain(fri_torch.transpose_quartic(want, 1)))


@pytest.mark.parametrize("regs,values", [(1, "random"), (20, "random"), (128, "random"),
                                          (128, "M - 1")])
def test_boundary_columns_toeplitz_product_matches_field_sums(kernel_bodies, regs, values):
    # K10's A (the weights' Toeplitz byte expansion) times B (the values'
    # bytes), summed over the register groups (four at R = 128) and reduced
    # from the digits, against the weighted sums in Python integers; with
    # every value and weight M - 1 the digit sums are the largest they get
    n = 100                                           # two tiles, the second partial
    rng = np.random.default_rng(regs)
    if values == "M - 1":
        ints, weights = [[M - 1] * n] * regs, [[M - 1] * regs] * 4
    else:
        ints, weights = [_ints(n, rng) for _ in range(regs)], [_ints(regs, rng) for _ in range(4)]
    lde = _limbs(ints)
    words = [(v >> (32 * k)) & 0xFFFFFFFF for row in weights for v in row for k in range(4)]
    out = torch.zeros((4, n, 4), dtype=torch.uint32)
    kernel_bodies.boundary_sums_host(_ptr(lde), n, 1, regs, n,
                                     (ctypes.c_uint32 * len(words))(*words), _ptr(out))
    want = [[sum(w * row[k] for w, row in zip(ws, ints)) % M for k in range(n)] for ws in weights]
    assert ft.to_ints(out).tolist() == want


@pytest.mark.parametrize("regs,n,stride", [
    (3, 64, 4),       # one tile, x^b from the lo table alone
    (20, 2048, 2),    # 32 tiles over three blocks, x^b from lo and hi, the main path's registers
    (7, 256, 1),
    (128, 64, 1),     # four register groups of 32: A rebuilt at each stage
    (33, 128, 2),     # two groups of 17, each with a k-step half past its registers
    (20, 512, 8),     # point stride 8
    (5, 100, 4),      # a partial last tile (64 + 36 points)
])
def test_boundary_columns_kernel_body_matches_plain(kernel_bodies, regs, n, stride):
    rng = np.random.default_rng(regs + n)
    lde = _limbs([_ints(n * stride, rng) for _ in range(regs)])[:, ::stride]
    parts = tuple((_ints(regs, rng), _ints(regs, rng), *_ints(2, rng)) for _ in range(2))
    xb_root = pow(_root(1 << (n - 1).bit_length()), 11, M)
    weights, (lo, hi), words = bk.boundary_args(lde, *parts, xb_root)
    out = torch.zeros((2, n, 4), dtype=torch.uint32)
    kernel_bodies.boundary_columns_host(
        _ptr(lde), lde.stride(0) // 4, lde.stride(1) // 4, regs, n,
        (ctypes.c_uint32 * len(weights))(*weights), _ptr(lo), _ptr(hi), tiles._LOG_LO,
        (ctypes.c_uint32 * 16)(*words), _ptr(out), min(-(-n // 64), 3))
    want = bk.boundary_columns_plain(lde, *parts, xb_root)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_wrappers_refuse_what_they_cannot_take():
    column = _limbs(list(range(24)))
    with pytest.raises(ValueError, match="power of two"):
        fri_torch.fri_fold(column, 1, _root(32))
    with pytest.raises(ValueError, match="power-of-two stride"):
        fri_torch.fri_fold(column[:16], 1, _root(32), stride=3)
    lde = _limbs([list(range(8))] * 2)
    parts = ([1, 2], [3, 4], 5, 6)
    with pytest.raises(ValueError, match="weights"):
        bk.boundary_columns(lde, parts, ([1], [2], 3, 4), 1)
    with pytest.raises(ValueError, match="power of two"):
        bk.boundary_columns(lde[:, :6], parts, parts, 1)
