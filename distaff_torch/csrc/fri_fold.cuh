// K9 fri_fold: one radix-4 FRI layer folded in one launch, four rows a
// thread, with the next layer's Merkle leaf digests.
//
// Replaces the JAX package's distaff_tpu/ops/fri_jax.py::_fold_rows_impl
// (jitted as fold_rows, tiled as distaff_tpu/ops/tiles.py::_fold_tile and
// fold_rows) with the x0 and x0^-3 power series that distaff_tpu/stark/
// fri.py::reduce builds for it, and the BLAKE3 of the folded layer's rows
// (distaff_tpu/ops/blake3_jax.py::hash_rows_u32 on the layer's quartic
// rows).  For each row r < q of a layer of 4q points (the column of the
// previous fold, or the composition at the first layer):
//
//   y_j = column[r + j q]                    (quartic::transpose, in place)
//   x_j = x0 I^j, x0 = w_L^r                 (I the primitive 4th root)
//   out[r] = sum_k y_k N_k / K_k x0^-3       N_k = prod_{j != k} (sx - x_j)
//
// the row's cubic through (x_j, y_j) evaluated at special_x sx in Lagrange
// form, whose denominators are x0^3 K_k with K_k = prod_{j != k} (I^k - I^j)
// global constants (fri_jax's module docstring).  The value at sx is unique,
// so the output is the JAX package's bit for bit.  The kernel evaluates the
// sum in a shorter form.  K_k is f'(I^k) for f = x^4 - 1, so 1/K_k = I^k / 4,
// and I^2 = -1 pairs the nodes (x_2 = -x0, x_3 = -I x0); with t = sx / x0
// the sum is
//
//   out[r] = (t^2 (X + Y) + (X - Y)) / 4,
//   X = t (y0 - y2) + (y0 + y2),  Y = I t (y1 - y3) - (y1 + y3)
//
// (four multiplies a row given t and I t; the division by 4 is two
// halvings, a shift and an add each).
//
// The design:
// - Four rows a thread on a large layer: thread i folds rows i + j q/4
//   (j < 4), which are exactly the next layer's leaf row i (its
//   quartic::transpose).  Their nodes are x0 zeta^j with zeta = w_L^(q/4),
//   a 16th root of unity, so their t are t_0 zeta^-j: the host's constants
//   zeta^-j and I zeta^-j are kernel arguments like special_x.  A thread
//   makes one table lookup (1/x0 = w^(s ((4q - i) mod 4q)) from the small
//   power tables of w that K1 keeps for the LDE domain, w_L = w^s;
//   points.cuh's table_power) and runs four independent fold chains.
// - On a small layer, which fills a few SMs with one warp each, a thread's
//   time is the layer's: there four lanes fold a leaf's four rows, one row
//   each, and the first gathers the row by shuffles (rows_per_thread in
//   ops/fri_torch.py; air_probe k9 measured both at every layer).  Layers
//   of fewer than four rows take a row a thread, and no digest.
// - Leaf digests: with blake3 the leaf's thread compresses its 64-byte row
//   once (chunk start, chunk end, root: blake3.cuh's hash_block, as K3
//   hashes a 64-byte row) and writes the digest to the next tree's leaves,
//   so no K3 launch reads the layer again.  The folded column is still
//   written: the next fold and the openings read it.
// - The sixteen reads of a thread are each one coalesced 512-byte row a
//   warp (streaming: the fold reads the column once), the four stores too;
//   the digests are 32 bytes a thread.  Indices are 64-bit (the first layer
//   at 2^20 steps has 2^23 rows).
// - No register cap (96-98 registers at four rows a thread, no spills);
//   blocks of 256 threads on the large layers, 64 on the small ones
//   (block_threads).
//
// Bound on this card: bytes and operations near even.  A row moves 88
// bytes (64 read, 16 and its share of a digest written) against ~700
// 32-bit instructions (fri_torch.fri_fold_ops: 6.25 multiplies with its
// share of the thread's, 7 adds and halvings and 4 subtractions, and a
// quarter of a compression): at 2^19 rows 0.014 ms by bytes, 0.011 by
// operations.  Measured (air_probe k9 on the H100, PERF.md): 0.039 ms at
// 2^19 rows, 2.8x that bound and not set by occupancy (a 64-register cap
// spills and runs slower; no profiler counter has shown the multiply
// pipe's share); the small layers (2^15 rows and under at 2^16 steps)
// take ~0.005 ms, the latency of one thread's chain and of the leaf's
// compression.

// This header compiles as plain C++ too: the tests run fold() a thread at
// a time, and hash_leaf on the lanes' words, against the plain version and
// the plain BLAKE3.

#pragma once
#include <cstdint>

#include "blake3.cuh"
#include "field128.cuh"
#include "points.cuh"

namespace fri_fold {

using f128::u128;

constexpr int kThreads = 256;          // a block's threads on a large layer
constexpr int kSmallThreads = 64;      // on a small one
constexpr int kLeafRows = 4;           // the rows of a leaf: one quartic row

// special_x, zeta^-j (j = 1, 2, 3) and I zeta^-j (j = 0..3), zeta =
// w_L^(q/4): the host's 32 words
struct Constants {
    uint4 special_x;
    uint4 zeta_inv[kLeafRows - 1];
    uint4 i_zeta_inv[kLeafRows];
};

struct Args {
    const uint4* column;     // (4q,) the layer's evaluations
    long long q;             // rows: out[0, q)
    int rows;                // rows a thread: 4, or 1
    int lanes;               // threads a leaf: 4 / rows (q where q < 4)
    const uint4* lo;         // w^e = lo[e mod 2^log_lo] hi[e >> log_lo], e < 4q stride
    const uint4* hi;
    int log_lo;
    long long stride;        // w_L = w^stride
    Constants k;
    uint4* out;              // (q,)
    uint32_t* digests;       // (q/4, 8) BLAKE3 of the rows (out[i + j q/4], j < 4), or null
    // on a slot of a mesh, the launch's rows are the rows [start, start + q)
    // of a layer of layer_q rows (0: the launch's q, a whole layer)
    long long start, layer_q;
};

// threads of a layer
F128_FN long long threads(const Args& a) { return a.q / a.rows; }

// the spacing m of a leaf's rows i + p m (p < 4): q/4 (1 where q < 4)
F128_FN long long spacing(const Args& a) { return a.q / (a.rows * a.lanes); }

// thread g's first row: leaf g / lanes, its rows (g % lanes) rows on
F128_FN long long first_row(const Args& a, long long g) {
    return g / a.lanes + (g % a.lanes) * a.rows * spacing(a);
}

// The exponent of w in 1/x0 = w_L^(-r) at the launch's row r, the layer's
// row start + r: stride ((4 layer_q - start - r) mod 4 layer_q)
F128_FN long long inverse_exponent(const Args& a, long long r) {
    const long long global = a.start + r, q = a.layer_q ? a.layer_q : a.q;
    return global ? a.stride * (4 * q - global) : 0;
}

// x / 2 mod M (M is odd)
F128_FN u128 half(u128 x) { return (x >> 1) + ((x & 1) ? (f128::modulus() >> 1) + 1 : 0); }

// one row from its four values, t = sx / x0 and I t
F128_FN u128 fold_row(const u128 (&y)[4], u128 t, u128 it) {
    const u128 x = f128::add(f128::mul(t, f128::sub(y[0], y[2])), f128::add(y[0], y[2]));
    const u128 y_ = f128::sub(f128::mul(it, f128::sub(y[1], y[3])), f128::add(y[1], y[3]));
    const u128 sum = f128::add(f128::mul(f128::mul(t, t), f128::add(x, y_)), f128::sub(x, y_));
    return half(half(sum));
}

// Thread g (g < threads): its kRows rows first + j m (j < kRows), each out
// and its four words in `words`.
template <int kRows>
F128_FN void fold(const Args& a, long long g, uint32_t (&words)[4 * kRows]) {
    const long long m = spacing(a), first = first_row(a, g);
    u128 y[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
            y[j][k] = f128::from_limbs(points::load_stream(a.column + first + j * m + k * a.q));
    const u128 t0 = f128::mul(f128::from_limbs(a.k.special_x),
                              points::table_power(a.lo, a.hi, a.log_lo, inverse_exponent(a, first)));
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        const u128 t = j ? f128::mul(t0, f128::from_limbs(a.k.zeta_inv[j - 1])) : t0;
        const uint4 v = f128::to_limbs(
            fold_row(y[j], t, f128::mul(t0, f128::from_limbs(a.k.i_zeta_inv[j]))));
        a.out[first + j * m] = v;
        words[4 * j] = v.x;
        words[4 * j + 1] = v.y;
        words[4 * j + 2] = v.z;
        words[4 * j + 3] = v.w;
    }
}

// Leaf i's digest from its row's 16 words (out[i + p m], p < 4).
F128_FN void hash_leaf(const Args& a, long long i, uint32_t (&words)[4 * kLeafRows]) {
    uint32_t cv[8];
    blake3::hash_block(cv, words);
    uint4* dst = reinterpret_cast<uint4*>(a.digests + 8 * i);
    dst[0] = uint4{cv[0], cv[1], cv[2], cv[3]};
    dst[1] = uint4{cv[4], cv[5], cv[6], cv[7]};
}

// A block's threads: kThreads where the layer fills two waves of such
// blocks on the card's `sms` multiprocessors, else kSmallThreads, which
// spreads a small layer's few threads over more of them (air_probe k9).
F128_FN int block_threads(const Args& a, int sms) {
    return threads(a) >= 2LL * sms * kThreads ? kThreads : kSmallThreads;
}

F128_FN long long blocks(const Args& a, int block) { return (threads(a) + block - 1) / block; }

}  // namespace fri_fold
