"""distaff_torch's 256-point leaf NTT on the CPU: kernel K16's plain version
(ops/mxu_ntt.leaf_ntt256 on CPU tensors) against the JAX package's
mxu_ntt.leaf_ntt256 and against K1's plain transform (tiles.ntt_batched at
n = 256), its stage matrices against the JAX _matrices, its digit
reduction against the JAX _reduce_digits and host ints, and K16's body
(csrc/leaf256.cuh) built with g++: its plane-layout fragments times the
data's windows against BIGMAT, its digit reduction against host ints, and
its launch run a block at a time through tests/torch_mma_host.h's
emulation of mma against the plain version and the JAX function.  Exact
equality throughout (integer field arithmetic)."""

import ctypes
import random
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.ops import mxu_ntt as jax_mxu
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import mxu_ntt, tiles
from torch_ptx_host import asm_block, run_ptx

M = jax_host_field.M
ROOT = jax_host_field.get_root_of_unity(256)
INV_ROOT = pow(ROOT, 255, M)
CSRC = Path(mxu_ntt.__file__).resolve().parent.parent / "csrc"
TESTS = Path(__file__).resolve().parent          # torch_mma_host.h: the tensor-core emulation
LARGEST_DIGIT = 16 * 16 * 255 ** 2              # 16 units x 16 byte pairs of 255 x 255


def _leaves(count, seed):
    """`count` leaves of seeded random elements, the first three rows all 0,
    all 1 and all M - 1, as host ints."""
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(16), "little") % M for _ in range(256)]
            for _ in range(count)]
    for row, v in zip(rows, (0, 1, M - 1)):
        row[:] = [v] * 256
    return rows


def _limbs(rows):
    return ft.from_ints(np.array(rows, dtype=object), "cpu")


@pytest.fixture(scope="module")
def jax_case():
    """Five leaves through the JAX leaf_ntt256 (one XLA compile)."""
    rows = _leaves(5, 5)
    got = np.asarray(jax_mxu.leaf_ntt256(fj.from_ints(np.array(rows, dtype=object)), ROOT))
    return rows, got


def test_plain_matches_jax_leaf_ntt256(jax_case):
    rows, want = jax_case
    got = mxu_ntt.leaf_ntt256(_limbs(rows), ROOT)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("root", [ROOT, INV_ROOT], ids=["forward", "inverse"])
def test_plain_matches_k1(root):
    x = _limbs(_leaves(3, 3))
    assert torch.equal(mxu_ntt.leaf_ntt256(x, root), tiles.ntt_batched(x, root))


def test_matrices_match_jax():
    a_mat, b_mat = mxu_ntt._matrices(ROOT, "cpu")
    jax_a, jax_b = jax_mxu._matrices(ROOT)
    assert a_mat.shape == (496, 256) and b_mat.shape == (16, 496, 256)
    assert np.array_equal(a_mat.numpy(), np.asarray(jax_a.astype(jnp.float32)).astype(np.uint8))
    assert np.array_equal(b_mat.numpy(), np.asarray(jax_b.astype(jnp.float32)).astype(np.uint8))


def test_reduce_digits_matches_jax():
    # tests/test_mxu_ntt.py's oracle digits: random ~264-bit values in 31 digits below 2^24
    rng = random.Random(7)
    digits = [[rng.randrange(1 << 24) for _ in range(6)] for _ in range(mxu_ntt.DIGITS)]
    want = fj.to_ints(np.asarray(jax_mxu._reduce_digits(
        jnp.asarray(np.array(digits, dtype=np.float32)))))
    got = ft.to_ints(mxu_ntt._reduce_digits_plain(torch.tensor(digits, dtype=torch.int64)))
    assert [int(v) for v in got] == [int(v) for v in want]


@pytest.mark.parametrize("digit", [(1 << 24) - 1, LARGEST_DIGIT, (1 << 32) - 1])
def test_reduce_digits_extremes(digit):
    digits = torch.full((mxu_ntt.DIGITS, 2), digit, dtype=torch.int64)
    digits[::2, 1] = 0                                       # every other digit 0 in column 1
    got = ft.to_ints(mxu_ntt._reduce_digits_plain(digits))
    for c in range(2):
        value = sum(int(digits[d, c]) << (8 * d) for d in range(mxu_ntt.DIGITS))
        assert int(got[c]) == value % M


_HARNESS = r"""
#include <cstring>
#include <vector>
#include "leaf256.cuh"
#include "torch_mma_host.h"

using namespace leaf256;

typedef uint32_t Fragments[kKSteps][32][4];      // a matrix's A fragments [kk][lane][a0-a3]
typedef uint32_t Planes[32][kSide];              // each lane's planes P[0..15]

static void load_fragments(const uint32_t* frags, int m, Fragments& a) {
    for (int kk = 0; kk < kKSteps; ++kk)
        for (int lane = 0; lane < 32; ++lane)
            std::memcpy(a[kk][lane], frags + 4 * fragment_unit(m, kk, lane), 16);
}

// kstep's products for one lane, recorded: the instruction (32 or 16 for
// m16n8k32 or m16n8k16, 0 for none) and its operand registers
struct Issued {
    int k = 0;
    uint32_t a[4] = {}, b[2] = {};
    void k32(const uint32_t (&q)[4], uint32_t b0, uint32_t b1) {
        k = 32;
        std::memcpy(a, q, sizeof(a));
        b[0] = b0;
        b[1] = b1;
    }
    void k16(uint32_t a0, uint32_t a1, uint32_t b0) {
        k = 16;
        a[0] = a0;
        a[1] = a1;
        b[0] = b0;
    }
};

// digit d of the warp's product for the 32 lanes at once: each lane's
// kstep on the live k-steps (leaf256.cu's apply, one chain), the warp's
// instruction run on the 32 lanes' operands
static void digit(const Fragments& a, const Planes& p, int d, int32_t (&acc)[32][4]) {
    std::memset(acc, 0, sizeof(acc));
    for (int kk = 0; kk < kKSteps; ++kk)
        for (int h = 0; h < 2; ++h) {
            if (!live(d, kk)) continue;
            Issued op[32];
            uint32_t quad[32][4], pair[32][2], b[32][4] = {}, b16[32];
            for (int lane = 0; lane < 32; ++lane) {
                kstep(op[lane], a[kk][lane], p[lane], d, kk, h);
                std::memcpy(quad[lane], op[lane].a, 16);
                std::memcpy(pair[lane], op[lane].a, 8);
                std::memcpy(b[lane], op[lane].b, 8);
                b16[lane] = op[lane].b[0];
            }
            if (op[0].k == 32) mma_host::mma(acc, quad, b, 0);
            if (op[0].k == 16) mma_host::mma16(acc, pair, b16);
        }
}

// leaf256.cu's apply for the 32 lanes of a warp at once
static void apply(const Fragments& a, const Planes& p, bool canonical, uint4 (&y)[32][4]) {
    Digits s[32][4] = {};
    for (int k = 0; k < kLimbs; ++k) {
        int32_t acc[4][32][4] = {};
        for (int dd = 0; dd < 4 && 4 * k + dd < f128::kDigits; ++dd) digit(a, p, 4 * k + dd, acc[dd]);
        for (int lane = 0; lane < 32; ++lane)
            for (int i = 0; i < 4; ++i)
                take(s[lane][i], k, acc[0][lane][i], acc[1][lane][i], acc[2][lane][i],
                     acc[3][lane][i]);
    }
    for (int lane = 0; lane < 32; ++lane)
        for (int i = 0; i < 4; ++i) y[lane][i] = finish(s[lane][i], canonical);
}

extern "C" int live_host(int d, int kk) { return live(d, kk); }

// a lane's planes P of four elements x (four words each)
extern "C" void planes_host(const uint32_t* x, uint32_t* p) {
    uint4 v[4];
    std::memcpy(v, x, sizeof(v));
    uint32_t pp[kSide];
    planes(v, pp);
    std::memcpy(p, pp, sizeof(pp));
}

// The digits of matrix 0 of `frags` applied to eight vectors x[v][j] (four
// words an element): out[d][row][v], through the lanes' planes and windows
extern "C" void digits_host(const uint32_t* frags, const uint32_t* x, uint32_t* out) {
    Fragments a;
    Planes p;
    load_fragments(frags, 0, a);
    for (int lane = 0; lane < 32; ++lane) {
        uint4 v[4];
        for (int e = 0; e < 4; ++e)
            std::memcpy(&v[e], x + 4 * (kSide * (lane >> 2) + 4 * (lane & 3) + e), 16);
        planes(v, p[lane]);
    }
    for (int d = 0; d < f128::kDigits; ++d) {
        int32_t acc[32][4];
        digit(a, p, d, acc);
        for (int lane = 0; lane < 32; ++lane)
            for (int i = 0; i < 4; ++i)
                out[(d * kSide + acc_row(lane, i)) * 8 + acc_column(lane, i)] = (uint32_t)acc[lane][i];
    }
}

// sum_d digits[d] 2^(8d) through take and finish
extern "C" void finish_host(const uint32_t* digits, int canonical, uint32_t* out) {
    Digits s = {};
    for (int k = 0; k < kLimbs; ++k)
        take(s, k, digits[4 * k], digits[4 * k + 1], digits[4 * k + 2],
             4 * k + 3 < f128::kDigits ? digits[4 * k + 3] : 0);
    const uint4 r = finish(s, canonical != 0);
    std::memcpy(out, &r, 16);
}

// the limbs (0-7, then the pend) that take leaves for finish
extern "C" void limbs_host(const uint32_t* digits, uint32_t* out) {
    Digits s = {};
    for (int k = 0; k < kLimbs; ++k)
        take(s, k, digits[4 * k], digits[4 * k + 1], digits[4 * k + 2],
             4 * k + 3 < f128::kDigits ? digits[4 * k + 3] : 0);
    std::memcpy(out, s.limb, sizeof(s.limb));
    out[kLimbs] = s.pend;
}

// K16's launch on the CPU, a block at a time, each phase of leaf256.cu for
// every warp of the block before the next; a lane's loads before its
// warp's stores
extern "C" void leaf256_host(const uint32_t* x, const uint32_t* frags, uint32_t* out,
                             long long leaves) {
    std::vector<uint4> mid(kSharedBytes / 16);
    const uint4* const xu = (const uint4*)x;
    Fragments a;
    Planes p;
    uint4 y[32][4];
    for (long long leaf0 = 0; leaf0 < leaves; leaf0 += kTile) {
        const int valid = leaves - leaf0 < kTile ? (int)(leaves - leaf0) : kTile;
        std::memset(mid.data(), 0xAB, kSharedBytes);
        load_fragments(frags, 0, a);
        for (int warp = 0; warp < kWarps; ++warp) {
            for (int r = 0; r < kATiles; ++r) {
                const int leaf = a_leaf(warp, r), h = a_half(warp, r);
                for (int lane = 0; lane < 32; ++lane) {
                    uint4 v[4] = {};
                    if (leaf < valid)
                        for (int e = 0; e < 4; ++e) v[e] = xu[(leaf0 + leaf) * kPoints + a_point(h, lane, e)];
                    planes(v, p[lane]);
                }
                apply(a, p, false, y);
                for (int lane = 0; lane < 32; ++lane)
                    for (int i = 0; i < 4; ++i) mid[a_store(leaf, h, lane, i)] = y[lane][i];
            }
        }
        for (int warp = 0; warp < kWarps; ++warp)
            for (int t = 0; t < kBTiles; ++t) {
                const int k2 = b_k2(warp, t);
                load_fragments(frags, 1 + k2, a);
                for (int lane = 0; lane < 32; ++lane) {
                    uint4 v[4];
                    for (int e = 0; e < 4; ++e) v[e] = mid[b_load(k2, lane, e)];
                    planes(v, p[lane]);
                }
                apply(a, p, true, y);
                for (int lane = 0; lane < 32; ++lane)
                    for (int i = 0; i < 4; ++i) mid[b_store(k2, lane, i)] = y[lane][i];
            }
        for (int e = 0; e < valid * kPoints; ++e)
            std::memcpy(out + 4 * (leaf0 * kPoints + e), &mid[out_slot(e)], 16);
    }
}
"""


@pytest.fixture(scope="module")
def k16(tmp_path_factory):
    """csrc/leaf256.cuh built with g++ as a host function with the kernel's
    arguments, and its product, windows and reduction alone."""
    tmp = tmp_path_factory.mktemp("leaf256")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC), "-I",
                    str(TESTS), str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.live_host.argtypes = [i32, i32]
    lib.planes_host.argtypes = [vp, vp]
    lib.digits_host.argtypes = [vp, vp, vp]
    lib.finish_host.argtypes = [vp, i32, vp]
    lib.limbs_host.argtypes = [vp, vp]
    lib.leaf256_host.argtypes = [vp, vp, vp, ctypes.c_longlong]
    return lib


def test_plane_fragments_times_windows_are_bigmat(k16):
    """The plane-layout A fragments (mxu_ntt.fragments) times every window
    of the data's planes, the live k-steps only, through kstep's dispatch
    (an odd digit's m16n8k32, an even digit's two m16n8k16), give BIGMAT's
    rows (i, d) times the vectors' bytes, on random bytes; and the skipped
    k-steps are exactly the all-zero blocks of the data's expanded operand."""
    rng = np.random.default_rng(16)
    entry = rng.integers(1, 256, (1, 16, 16, 16), dtype=np.uint8)       # [m, i, j, p]
    data = rng.integers(1, 256, (8, 16, 16), dtype=np.uint8)            # [v, j, q]
    frags = mxu_ntt.fragments(entry)
    assert frags.shape == (1, 8, 32, 4)
    out = np.zeros((31, 16, 8), dtype=np.uint32)
    k16.digits_host(frags.ctypes.data, np.ascontiguousarray(data).ctypes.data, out.ctypes.data)
    big = mxu_ntt._bigmat(entry[0]).astype(np.int64)                    # [(i, d), (j, q)]
    want = (big @ data.reshape(8, 256).T.astype(np.int64)).reshape(16, 31, 8)
    assert np.array_equal(out.astype(np.int64), want.transpose(1, 0, 2))
    # B_d[(p, j), v] = byte d - p of x_j: k-step kk is rows p = 2kk, 2kk + 1
    for d in range(31):
        b = np.zeros((16, 16, 8), dtype=np.int64)
        for p in range(16):
            if 0 <= d - p < 16:
                b[p] = data[:, :, d - p].T
        for kk in range(8):
            assert bool(k16.live_host(d, kk)) == bool(b[2 * kk:2 * kk + 2].any()), (d, kk)
    assert sum(k16.live_host(d, kk) for d in range(31) for kk in range(8)) == 136
    # a lane's planes: P[q] = byte q of its four elements
    p = np.zeros(16, dtype=np.uint32)
    k16.planes_host(np.ascontiguousarray(data[0, :4]).ctypes.data, p.ctypes.data)
    assert p.tolist() == [int(np.ascontiguousarray(data[0, :4, q]).view(np.uint32)[0])
                          for q in range(16)]


def _digits_of(value):
    return [(value >> (8 * d)) & 0xFF for d in range(mxu_ntt.DIGITS)]


def _digit_cases():
    """Digit vectors: values at M and 2^128, one whose second fold carries
    into bit 128 (t = 2^129 - 1), the largest digits a product can give and
    random ones."""
    r = (45 << 40) - 1
    h = ((1 << 129) - 1) // r
    cases = [_digits_of(v) for v in (0, 1, M - 1, M, M + 1, (1 << 128) - 1, 1 << 128,
                                     (1 << 256) - 1, (1 << 248) * 255 + M,
                                     ((1 << 129) - 1 - h * r) + (h << 128))]
    cases += [[LARGEST_DIGIT] * mxu_ntt.DIGITS, [LARGEST_DIGIT, 0] * 15 + [LARGEST_DIGIT]]
    rng = random.Random(18)
    return cases + [[rng.randrange(LARGEST_DIGIT + 1) for _ in range(mxu_ntt.DIGITS)]
                    for _ in range(50)]


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "below-2^128"])
def test_finish_matches_host_ints(k16, canonical):
    """take and finish (the host code) on digit vectors against Python
    ints: canonical below M, else below 2^128."""
    cases = _digit_cases()
    out = np.zeros(4, dtype=np.uint32)
    for digits in cases:
        k16.finish_host(np.array(digits, dtype=np.uint32).ctypes.data, int(canonical),
                        out.ctypes.data)
        got = sum(int(w) << (32 * k) for k, w in enumerate(out))
        value = sum(dg << (8 * d) for d, dg in enumerate(digits))
        assert got % M == value % M and got < (M if canonical else 1 << 128), digits


def test_reduction_ptx_matches_host_ints(k16):
    """leaf256.cuh's PTX of take, fold, below and canonical (the card's
    reduction) run by an interpreter of their instructions on each digit
    vector of _digit_cases: take's limbs those of the host code, fold's w
    below 2^128 + 2^102, below's result below 2^128 and canonical's below M,
    each equal to the value mod M."""
    take, names = asm_block("leaf256.cuh", "F128_FN void take(")
    assert names == ["s.limb[k]", "s.pend", "c1", "column()", "c0"]
    fold, names = asm_block("leaf256.cuh", "F128_FN void fold(")
    assert names == [f"w[{k}]" for k in range(5)] + [f"s.limb[{k}]" for k in range(8)] + ["s.pend"]
    below, _ = asm_block("leaf256.cuh", "F128_FN uint4 below(")
    reduce, _ = asm_block("leaf256.cuh", "F128_FN uint4 canonical(")
    want_limbs = np.zeros(9, dtype=np.uint32)
    seen_top = False
    for digits in _digit_cases():
        k16.limbs_host(np.array(digits, dtype=np.uint32).ctypes.data, want_limbs.ctypes.data)
        limbs, pend = [], 0
        for k in range(8):
            d = (digits + [0])[4 * k:4 * k + 4]
            limb, pend = run_ptx(take, [0, 0, d[2] + (d[3] << 8), 1 << 16,
                                        d[0] + (d[1] << 8) + pend])[:2]
            limbs.append(limb)
        assert limbs + [pend] == [int(v) for v in want_limbs], digits
        value = sum(dg << (8 * d) for d, dg in enumerate(digits))
        w = run_ptx(fold, [0] * 5 + limbs + [pend])[:5]
        wide = sum(x << (32 * k) for k, x in enumerate(w))
        assert wide < (1 << 128) + (1 << 102) and wide % M == value % M, digits
        seen_top |= w[4] == 1
        out = sum(x << (32 * k) for k, x in enumerate(run_ptx(below, [0] * 4 + w)[:4]))
        assert out < 1 << 128 and out % M == value % M, digits
        out = sum(x << (32 * k) for k, x in enumerate(run_ptx(reduce, [0] * 4 + w)[:4]))
        assert out == value % M, digits
    assert seen_top


def _edge_leaves(count, seed):
    """Leaves of 0, 1 and M - 1 alone: a row of each, then each element one
    of the three at random."""
    rng = np.random.default_rng(seed)
    rows = [[v] * 256 for v in (0, 1, M - 1)]
    rows += [[(0, 1, M - 1)[k] for k in rng.integers(0, 3, 256)] for _ in range(count - 3)]
    return rows


@pytest.mark.parametrize("leaves,root,edge", [(37, ROOT, False), (3, INV_ROOT, False),
                                              (19, ROOT, True)],
                         ids=["ragged", "inverse", "edge"])
def test_kernel_body_matches_plain(k16, leaves, root, edge):
    x = _limbs(_edge_leaves(leaves, leaves) if edge else _leaves(leaves, leaves))
    entries = mxu_ntt.kernel_entries(root, "cpu")
    out = torch.zeros_like(x)
    k16.leaf256_host(x.data_ptr(), entries.data_ptr(), out.data_ptr(), leaves)
    assert torch.equal(out, mxu_ntt.leaf_ntt256_plain(x, root))


def test_kernel_body_matches_jax(k16, jax_case):
    rows, want = jax_case
    x = _limbs(rows)
    out = torch.zeros_like(x)
    k16.leaf256_host(x.data_ptr(), mxu_ntt.kernel_entries(ROOT, "cpu").data_ptr(),
                     out.data_ptr(), len(rows))
    assert np.array_equal(out.numpy(), want)


def test_probe_patches_match_leaf256():
    # tools/air_probe.py k16 builds K16's variants from patched copies of
    # csrc/: every text it replaces must be in the source it patches, once
    from distaff_torch.tools import air_probe

    for name, (patches, _) in air_probe.K16_VARIANTS.items():
        for file, old, _ in patches:
            assert (CSRC / file).read_text().count(old) == 1, (name, file, old)
