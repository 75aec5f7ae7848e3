"""distaff_torch's 256-point leaf NTT on the CPU: kernel K16's plain version
(ops/mxu_ntt.leaf_ntt256 on CPU tensors) against the JAX package's
mxu_ntt.leaf_ntt256 and against K1's plain transform (tiles.ntt_batched at
n = 256), its stage matrices against the JAX _matrices, its digit
reduction against the JAX _reduce_digits and host ints, and K16's body
(csrc/leaf256.cuh) built with g++ and run a block at a time through
tests/torch_mma_host.h's emulation of ldmatrix and mma.  Exact equality
throughout (integer field arithmetic)."""

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

extern "C" void a_fragment_host(const uint32_t* matrix, int i, int kk, int h, int lane,
                                uint32_t* out) {
    uint32_t a[4];
    a_fragment(matrix, i, kk, h, lane_of(lane), a);
    std::memcpy(out, a, sizeof(a));
}

typedef uint32_t Fragments[kKSteps][4][32][2];     // [kk][n8 tile][lane][b0, b1]

// leaf256.cu's apply for the 32 lanes of a warp at once
static void apply(const uint32_t* matrix, int i, const Fragments& b, uint32_t* digits,
                  uint4 (&v)[32]) {
    mma_host::Acc acc;
    std::memset(acc, 0, sizeof(acc));
    for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[2][32][4];
        for (int h = 0; h < 2; ++h)
            for (int lane = 0; lane < 32; ++lane) a_fragment(matrix, i, kk, h, lane_of(lane), a[h][lane]);
        for (int nt = 0; nt < 4; ++nt) {
            uint32_t bb[32][4] = {};
            for (int lane = 0; lane < 32; ++lane) {
                bb[lane][0] = b[kk][nt][lane][0];
                bb[lane][1] = b[kk][nt][lane][1];
            }
            for (int h = 0; h < 2; ++h) mma_host::mma(acc[h][nt], a[h], bb, 0);
        }
    }
    for (int h = 0; h < 2; ++h)
        for (int nt = 0; nt < 4; ++nt)
            for (int lane = 0; lane < 32; ++lane)
                for (int i2 = 0; i2 < 4; ++i2) {
                    const int at = digit_word(h, nt, lane, i2);
                    if (at >= 0) digits[at] = (uint32_t)acc[h][nt][lane][i2];
                }
    for (int lane = 0; lane < 32; ++lane) v[lane] = reduce(digits, lane);
}

// K16's launch on the CPU, a block at a time, each phase of leaf256.cu for
// every warp of the block before the next (stage B's fragments, read by
// every warp before the barrier, loaded once)
extern "C" void leaf256_host(const uint32_t* x, const uint32_t* entries, uint32_t* out,
                             long long leaves) {
    std::vector<uint8_t> shared(kSharedBytes);
    const uint32_t* const mat_a = (const uint32_t*)(shared.data() + kStageAAt);
    uint4* const mid = (uint4*)(shared.data() + kMidAt);
    Fragments b;
    for (long long leaf0 = 0; leaf0 < leaves; leaf0 += kTile) {
        const int valid = leaves - leaf0 < kTile ? (int)(leaves - leaf0) : kTile;
        std::memset(shared.data(), 0xAB, shared.size());
        std::memcpy(shared.data() + kStageAAt, entries, kMatrixBytes);
        std::memcpy(shared.data() + kStageBAt, entries + kMatrixWords, kMatrixBytes);
        for (int warp = 0; warp < kWarps; ++warp) {
            uint32_t* const digits = (uint32_t*)(shared.data() + kDigitsAt) + warp * kDigitWords;
            for (int s = 0; s < 2; ++s) {
                const int group = warp + kWarps * s;
                for (int kk = 0; kk < kKSteps; ++kk)
                    for (int nt = 0; nt < 4; ++nt)
                        for (int lane = 0; lane < 32; ++lane)
                            for (int half = 0; half < 2; ++half)
                                b[kk][nt][lane][half] = group_leaf(group, 8 * nt + (lane >> 2)) < valid
                                    ? x[input_word(leaf0, group, nt, kk, half, lane)] : 0u;
                for (int k2 = 0; k2 < kSide; ++k2) {
                    uint4 v[32];
                    apply(mat_a, k2, b, digits, v);
                    for (int lane = 0; lane < 32; ++lane)
                        mid[mid_unit(k2, group_leaf(group, lane), group_column(lane))] = v[lane];
                }
            }
        }
        for (int k2 = 0; k2 < kSide; ++k2) {
            if (k2 + 1 < kSide)
                std::memcpy(shared.data() + kStageBAt + ((k2 + 1) & 1) * kMatrixBytes,
                            entries + (2 + k2) * kMatrixWords, kMatrixBytes);
            for (int kk = 0; kk < kKSteps; ++kk)
                for (int np = 0; np < 2; ++np) {
                    int offset[32];
                    uint32_t r[32][4];
                    for (int lane = 0; lane < 32; ++lane)
                        offset[lane] = 16 * stage_b_row(k2, np, kk, lane);
                    mma_host::ldmatrix_x4((const uint8_t*)mid, offset, r);
                    for (int lane = 0; lane < 32; ++lane)
                        for (int half = 0; half < 2; ++half) {
                            b[kk][2 * np][lane][half] = r[lane][half];
                            b[kk][2 * np + 1][lane][half] = r[lane][2 + half];
                        }
                }
            const uint32_t* const mat_b =
                (const uint32_t*)(shared.data() + kStageBAt + (k2 & 1) * kMatrixBytes);
            for (int warp = 0; warp < kWarps; ++warp) {
                uint32_t* const digits = (uint32_t*)(shared.data() + kDigitsAt) + warp * kDigitWords;
                for (int r = 0; r < 2; ++r) {
                    uint4 v[32];
                    apply(mat_b, 2 * warp + r, b, digits, v);
                    for (int lane = 0; lane < 32; ++lane) mid[mid_unit(k2, lane, 2 * warp + r)] = v[lane];
                }
            }
        }
        for (int e = 0; e < valid * kPoints; ++e)
            std::memcpy(out + 4 * (leaf0 * kPoints + e), &mid[out_unit(e)], 16);
    }
}
"""


@pytest.fixture(scope="module")
def k16(tmp_path_factory):
    """csrc/leaf256.cuh built with g++ as a host function with the kernel's
    arguments, and its A-fragment function."""
    tmp = tmp_path_factory.mktemp("leaf256")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC), "-I",
                    str(TESTS), str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.a_fragment_host.argtypes = [vp, i32, i32, i32, i32, vp]
    lib.leaf256_host.argtypes = [vp, vp, vp, ctypes.c_longlong]
    return lib


def test_fragments_are_bigmat(k16):
    """Every A fragment K16 builds from an entry's words is BIGMAT's m16 x
    k32 tile in mma's layout: lane (g, t)'s a0-a3 bytes 4t..4t+3 of rows g,
    g + 8 at units 2kk and 2kk + 1."""
    entries = mxu_ntt.kernel_entries(ROOT, "cpu")
    a_mat, b_mat = mxu_ntt._matrices(ROOT, "cpu")
    for m, big in ((0, a_mat), (5, b_mat[4])):
        rows = torch.cat([big.view(16, 31, 256), torch.zeros((16, 1, 256), dtype=torch.uint8)],
                         1).numpy()                           # [i][d][(j, q)], d = 31 all 0
        matrix = entries[m].contiguous()
        out = np.zeros(4, dtype=np.uint32)
        for i in range(16):
            for kk in range(8):
                for h in range(2):
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        lib_args = (matrix.data_ptr(), i, kk, h, lane, out.ctypes.data)
                        k16.a_fragment_host(*lib_args)
                        want = [rows[i, 16 * h + g + 8 * r, 32 * kk + 16 * u + 4 * t:
                                     32 * kk + 16 * u + 4 * t + 4].view(np.uint32)[0]
                                for u in range(2) for r in range(2)]
                        assert out.tolist() == want, (m, i, kk, h, lane)


@pytest.mark.parametrize("leaves,root", [(37, ROOT), (3, INV_ROOT)], ids=["ragged", "inverse"])
def test_kernel_body_matches_plain(k16, leaves, root):
    x = _limbs(_leaves(leaves, leaves))
    entries = mxu_ntt.kernel_entries(root, "cpu")
    out = torch.zeros_like(x)
    k16.leaf256_host(x.data_ptr(), entries.data_ptr(), out.data_ptr(), leaves)
    assert torch.equal(out, mxu_ntt.leaf_ntt256_plain(x, root))
