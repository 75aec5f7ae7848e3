// K16 leaf256: the 256-point leaf NTT as two stages of byte-limb matrix
// products on the int8 tensor cores, a tile of 32 leaves a block in one
// launch.
//
// Replaces the JAX package's distaff_tpu/ops/mxu_ntt.py::_leaf256_impl
// (with _matrices and _reduce_digits), which ran the same products as bf16
// matmuls on the TPU's matrix unit with f32 sums; here they are
// mma.sync.m16n8k32 u8 x u8 products with s32 sums, exact alike (every
// digit sum is below 16 * 16 * 255^2 < 2^24).  With n = i1 + 16 i2 and
// k = k2 + 16 k1 (ops/mxu_ntt.py):
//   stage A   A[b, i1, k2] = sum_i2 W[k2][i2] x[b, i1 + 16 i2]
//   stage B   X[b, 16 k1 + k2] = sum_i1 C[k2][k1][i1] A[b, i1, k2]
// Each is "apply a 16 x 16 field matrix m to vectors v": the digits
// D[(i, d), v] = sum_(j, q) BIGMAT[(i, d), (j, q)] byte_q(v_j), BIGMAT's
// row (i, d), column (j, q) byte d - q of m[i][j], 512 rows (d = 31 is all
// 0) by 256 bytes.  Stage A applies W to the 16 vectors (b, i1) of a leaf
// (v_j = x[b, i1 + 16 j]), stage B applies C[k2] to the leaves (v_j =
// A[b, j, k2]).  f128::reduce_digits takes each (element, 31 digits) to
// the field once.
//
// The matrices are mma's A operand.  Expanded, one is 124 KB and the
// seventeen 2.1 MB: they fit no block's shared memory, and read from L2
// in fragment order they would cost 2.1 MB a tile, 67 KB a leaf at 32
// leaves a tile (11 GB for the 163,840 leaves of a 2^16 LDE, several
// times the 1.34 GB of the leaves themselves).  So the fragments are built
// in registers from the entries' 16 bytes: BIGMAT is Toeplitz in (d, q),
// and mma's word of lane (g, t) at row d, bytes 4t..4t+3 of unit j is
// bytes d-4t, d-4t-1, d-4t-2, d-4t-3 of m[i][j] (0 outside 0..15): two
// words of the entry and one byte_perm, whose word indices and selector
// depend on the lane and the row half alone (Lane below).  An entry is
// kept as its four limbs and a zero word (5 words; an index outside the
// limbs reads the zero), so a block holds W (5 KB) for good and C[k2]
// (5 KB) in two buffers, the next one copied (cp.async) while this one is
// used.  A fragment (4 words) costs 8 shared loads and 4 byte_perms and
// feeds 4 mma (the warp's four n8 tiles).
//
// A block: 256 threads, 32 leaves.  Stage A: warp w takes vector groups w
// and w + 8 (a group: leaves 2G and 2G + 1, 16 columns each, 32 vectors),
// their B fragments (each a word of an input element: mma's "col" operand
// is the vector's bytes, 16 a unit) loaded once from device memory into 64
// registers, then for each k2 its two m16 tiles (digits 0-15 and 16-31)
// over 8 k-steps (16 mma), the digits stored in the warp's area and each
// lane reducing one vector's element into `mid`, shared memory, [k2][leaf]
// [i1].  Stage B, for each k2: every warp loads slab k2 of mid as its B
// fragments (the 32 leaves, ldmatrix.x4, each row an element), a barrier
// frees the slab, and warp w computes rows k1 = 2w, 2w + 1 (16 mma each)
// and reduces lane c's leaf's X[c, 16 k1 + k2] into the slab's units.  Then
// the block writes its leaves out, coalesced.  A ragged last tile loads
// zeros and stores only its leaves.
//
// Bound on the H100 (ops/mxu_ntt.leaf256_work): per leaf 8 KB of device
// memory, 4.06M byte multiply-adds (4.1 us per 1,000 leaves at 1,979 TOPS,
// against 2.45 us of bytes at 3.35 TB/s) and 512 digit reductions on the
// CUDA cores (REDUCE_OPS each in chip_smoke.py).  This design also issues
// the fragments' loads and byte_perms (about 3 instructions an mma) beside
// the 1,024 mma a leaf; chip_smoke.py phase 10 times it beside K1.
//
// This header compiles as plain C++ too: the CPU tests run a block's
// stages through tests/torch_mma_host.h's emulation of ldmatrix and mma on
// the offsets and fragments below.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace leaf256 {

constexpr int kPoints = 256;                   // a leaf
constexpr int kSide = 16;                      // 256 = 16 x 16
constexpr int kTile = 32;                      // leaves a block
constexpr int kThreads = 256;                  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kKSteps = kSide / 2;             // 32-byte k-steps: two 16-byte units each
constexpr int kEntryWords = 5;                 // an entry's four limbs and a zero word
constexpr int kMatrixWords = kSide * kSide * kEntryWords;
constexpr int kMatrixBytes = 4 * kMatrixWords;       // 5120
// mid: element (k2, leaf, unit) at 16-byte unit k2 kSlabUnits + leaf kRowUnits + unit; a
// row of 17 units and a slab of 545 (both odd) keep ldmatrix's eight rows and the final
// reads across slabs on distinct banks
constexpr int kRowUnits = kSide + 1;
constexpr int kSlabUnits = kTile * kRowUnits + 1;
// a warp's digits: row d, vector c at word d kDigitPitch + c; a pitch of 8 mod 32 words
// puts the 64-bit stores of a half warp on 32 distinct banks
constexpr int kDigitPitch = 40;
constexpr int kDigitWords = f128::kDigits * kDigitPitch;

// shared memory, in bytes: W, the two buffers of C, mid, the warps' digits
constexpr int kStageAAt = 0;
constexpr int kStageBAt = kMatrixBytes;
constexpr int kMidAt = 3 * kMatrixBytes;
constexpr int kDigitsAt = kMidAt + 16 * kSide * kSlabUnits;
constexpr int kSharedBytes = kDigitsAt + 4 * kWarps * kDigitWords;    // 194,560

// The A fragment's two entry words and byte_perm selector for a lane:
// word(v, d, t) = bytes d-4t-e of v at byte e (e = 0..3) lie in v's words
// kw and kw + 1, kw = floor((d - 4t - 3) / 4), from offset o = (d - 4t - 3)
// mod 4 of word kw.  at[h][r][0/1]: the two word indices (4, the zero
// word, outside the limbs) for the rows d = 16h + g + 8r of lane (g, t).
struct Lane {
    int at[2][2][2];
    uint32_t selector;
};

F128_FN int entry_word(int k) { return k >= 0 && k < 4 ? k : 4; }

F128_FN Lane lane_of(int lane) {
    const int g = lane >> 2, t = lane & 3;
    Lane l;
    int o = 0;
    for (int h = 0; h < 2; ++h)
        for (int r = 0; r < 2; ++r) {
            const int lo = 16 * h + 8 * r + g - 4 * t - 3;
            const int kw = lo >= 0 ? lo / 4 : -((3 - lo) / 4);
            o = lo - 4 * kw;
            l.at[h][r][0] = entry_word(kw);
            l.at[h][r][1] = entry_word(kw + 1);
        }
    l.selector = 0;
    for (int e = 0; e < 4; ++e) l.selector |= (uint32_t)(o + 3 - e) << (4 * e);
    return l;
}

// bytes of the 8-byte y:x picked by the selector's nibbles (CUDA's __byte_perm)
F128_FN uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
    return __byte_perm(x, y, s);
#else
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int e = 0; e < 4; ++e) r |= (uint32_t)((v >> (8 * ((s >> (4 * e)) & 7))) & 0xFF) << (8 * e);
    return r;
#endif
}

// mma's a0-a3 for the m16 tile of BIGMAT rows (i, 16h..16h+15) at k-step
// kk (units j = 2kk, 2kk + 1), from the entries of `matrix` (row-major, 5
// words an entry)
F128_FN void a_fragment(const uint32_t* matrix, int i, int kk, int h, const Lane& l,
                        uint32_t (&a)[4]) {
    const uint32_t* e0 = matrix + (kSide * i + 2 * kk) * kEntryWords;
    const uint32_t* e1 = e0 + kEntryWords;
    a[0] = byte_perm(e0[l.at[h][0][0]], e0[l.at[h][0][1]], l.selector);
    a[1] = byte_perm(e0[l.at[h][1][0]], e0[l.at[h][1][1]], l.selector);
    a[2] = byte_perm(e1[l.at[h][0][0]], e1[l.at[h][0][1]], l.selector);
    a[3] = byte_perm(e1[l.at[h][1][0]], e1[l.at[h][1][1]], l.selector);
}

// stage A's vector c of group G: leaf 2G + c / 16 of the tile, column i1 = c % 16
F128_FN int group_leaf(int group, int c) { return 2 * group + (c >> 4); }
F128_FN int group_column(int c) { return c & 15; }

// Stage A's B fragment word `half` (b0, b1) of n8 tile nt at k-step kk for
// a lane (column c = 8 nt + g, bytes 4t..4t+3 of unit 2kk + half): word t of
// point i1 + 16 (2kk + half) of the column's leaf; its index in the input's
// 32-bit words, the tile's first leaf leaf0
F128_FN long long input_word(long long leaf0, int group, int nt, int kk, int half, int lane) {
    const int c = 8 * nt + (lane >> 2);
    const int n = group_column(c) + kSide * (2 * kk + half);
    return ((leaf0 + group_leaf(group, c)) * kPoints + n) * 4 + (lane & 3);
}

F128_FN int mid_unit(int k2, int leaf, int unit) {
    return k2 * kSlabUnits + leaf * kRowUnits + unit;
}

// Stage B's ldmatrix.x4 row of a lane for n8 tiles 2np and 2np + 1 at
// k-step kk: matrices (leaves 16np.., unit 2kk), (16np.., 2kk + 1), (16np +
// 8.., 2kk), (16np + 8.., 2kk + 1), so that registers 0-3 are b0, b1 of
// tile 2np and b0, b1 of tile 2np + 1; in 16-byte units into mid
F128_FN int stage_b_row(int k2, int np, int kk, int lane) {
    const int j = lane >> 3;
    return mid_unit(k2, 16 * np + 8 * (j >> 1) + (lane & 7), 2 * kk + (j & 1));
}

// Where accumulator i of a lane for m16 tile h (digits 16h on) and n8 tile
// nt goes in the warp's digits (mma's c_i: row g + 8 (i >> 1), column 2t +
// (i & 1)), or -1 for digit 31, which is 0
F128_FN int digit_word(int h, int nt, int lane, int i) {
    const int d = 16 * h + (lane >> 2) + 8 * (i >> 1);
    return d < f128::kDigits ? d * kDigitPitch + 8 * nt + 2 * (lane & 3) + (i & 1) : -1;
}

// the element of vector c (a lane) from the warp's digits
F128_FN uint4 reduce(const uint32_t* digits, int c) {
    return f128::to_limbs(f128::reduce_digits(digits + c, kDigitPitch));
}

// the tile's output element e (leaf e / 256, point e % 256) in mid
F128_FN int out_unit(int e) {
    const int n = e % kPoints;
    return mid_unit(n % kSide, e / kPoints, n / kSide);
}

}  // namespace leaf256
