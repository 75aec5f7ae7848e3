// K7 deep_compose: step 6 of the prover, the DEEP composition over the LDE
// domain, in one launch.
//
// Replaces the JAX package's fused step-6 dispatches:
// distaff_tpu/stark/prover.py::_compose_tiles_batched (the composition, with
// field_jax.inv_batch_scan for its inverses on an accelerator), the x and
// x^incr power series it takes, and distaff_tpu/ops/tiles.py::_wsum_tile
// (the weighted register sums A1, A2).  For each point i < n of the
// domain, x = w^i:
//
//   A1 = sum_r cc1_r lde[r, i],  A2 = sum_r cc2_r lde[r, i]
//   out[i] = ((A1 - s1) / (x - z) + (A2 - s2) / (x - zg)) (k1 + k2 x^incr)
//            + (c[i] - c(z)) kc / (x - z)
//
// written as N / d with d = (x - z)(x - zg) and
// N = ((A1 - s1)(x - zg) + (A2 - s2)(x - z)) (k1 + k2 x^incr)
//     + (c[i] - c(z)) kc (x - zg);
// out = 0 where d = 0 (x is z or zg), as the JAX package's batch inverse
// maps 0 to 0.  The inverse is unique, so the values are the JAX
// package's bit for bit.
//
// Bound on this card (2^21 points, 20 registers): bytes, 352 a point (the
// LDE's 16R and c's 16 read once, out's 16 written: 0.220 ms at 3.35
// TB/s), over the int8 product (2 x 64 x 16R byte operations a point:
// 0.043 ms at 1,979 TOP/s) and the epilogue's 32-bit instructions (two
// digit reductions and 15 multiplies a point: 0.08 ms at the SM issue
// width).  On the CUDA cores the two sums alone were 2R multiplies a
// point, 40 of 53, and bound the kernel (1.04 ms).  The design:
// - A1 and A2 are wsum_product.cuh's byte-limb product on the int8 tensor
//   cores: a tile of 128 points, A (64 x 16R bytes) built in shared memory
//   from the weights (device memory, read once a block: the wrapper takes
//   them as tensors on the card) at the block's start (above 32 registers
//   at each group's stage), each register's run of the tile's points one
//   bulk asynchronous copy into the ring of stages; persistent blocks over
//   tiles block + k grid, two an SM at R = 20.  R from 1 to 128: the
//   streamed prover's call (R = 2, weights (1, 0) and (0, 1), the NTTs of
//   K15's sums) is one m16n8k32 k-step.
// - The epilogue: each thread reduces one (sum, point) of the tile from its
//   s32 digits (f128::reduce_digits) into `sums` in shared memory; then the
//   tile's slot takes the next copies, and after every second tile each
//   thread composes one point of the pair (x and x^incr from the two pairs
//   of small power tables, c w^e = lo[e mod 1024] hi[e >> 10], the tables
//   K1 keeps for the NTT; their entries and c fetched a tile ahead), d and
//   N as above, with every slot's copies in flight.
// - Montgomery's trick over a round of kRoundPairs pairs (points per
//   inversion: 256 kRoundPairs): a thread keeps only its running product q
//   of the round's nonzero d, and writes y = N q_before (q before this
//   point's d) to out[i] as scratch (a round's y, 34 MB over the card's
//   blocks, stay in the 50 MB L2); at the round's end the block's threads
//   meet in inv_block.cuh's product tree, one field inversion (a dependent
//   chain) for the block, and each thread walks back through its round:
//   out = y / q = N / d, 1/q_before = d / q, with d recomputed from x, the
//   next point's reads issued before this one's multiplies.
// - What the card measured (tools/air_probe.py k7, PERF.md): 8192 points
//   an inversion against 2048 took (20, 2^21) from 0.59 to 0.53 ms (512:
//   0.85); bulk copies beat cp.async (0.59 ms) and two blocks an SM one
//   (0.65 ms); the copies alone take 0.27 ms, with the product and the
//   reductions 0.28 ms, and the composition's multiplies (latency-bound
//   chains, 16 warps an SM) most of the rest.
// - Points at n or beyond (a ragged last tile) are read by no copy and not
//   written.  Indices are 64-bit.
//
// Phases, each a function of (block, thread), with barriers between them
// on the card (deep_compose.cu): the ring's stages (wsum::run), keep_sum
// and fetch, forward, inv_block's tree, walk_back.  This header compiles
// as plain C++ too: the tests run the phases a block and a thread at a
// time, the product through an emulation of ldmatrix and mma, against the
// plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "inv_block.cuh"
#include "points.cuh"
#include "wsum_product.cuh"

// Points per inversion, 256 a pair; tools/air_probe.py builds other rounds.
#ifndef DEEP_ROUND_PAIRS
#define DEEP_ROUND_PAIRS 32
#endif

namespace deep_compose {

using f128::u128;

constexpr int kThreads = wsum::kThreads;
constexpr int kTile = wsum::Pair::kTile;   // 128 points a tile
constexpr long long kRoundPairs = DEEP_ROUND_PAIRS;
constexpr int kMaxRegisters = wsum::kMaxRegisters;
// shared memory of its own: two tiles' sums, (2, 2, kTile) elements; the
// inversion's product tree (2 kThreads elements) takes the same bytes
constexpr int kSumsBytes = 2 * 2 * kTile * 16;
static_assert(kSumsBytes == 2 * kThreads * 16, "deep_compose: the tree is the sums' size");

struct Scalars {
    uint4 z, zg, s1, s2, cz, k1, k2, kc;
};

struct Args {
    wsum::Source lde;        // (regs, lde.reg_stride) points, n of them composed, and w1, w2
    const uint4* c_lde;      // (n,) constraint evaluations
    const uint4* x_lo;       // x = x_lo[i mod 2^log_lo] * x_hi[i >> log_lo], x_lo[i] without x_hi
    const uint4* x_hi;
    const uint4* i_lo;       // x^incr likewise
    const uint4* i_hi;
    int log_lo;
    Scalars s;
    uint4* out;              // (n,)
    long long first;         // point i is x = root^(first + i): 0 but on a slot of a mesh
};

// Tile k of the block: its sum s = sum_of(tid), point point_of(tid) into
// sums[((k & 1) 2 + s) kTile + p]
F128_FN void keep_sum(u128* sums, long long k, const uint32_t* digits, int tid) {
    sums[((k & 1) * 2 + wsum::sum_of(tid)) * kTile + wsum::point_of(tid)] =
        wsum::reduce(digits, tid);
}

// After tile k of the block's mine: whether a pair of tiles is complete
// (its second tile, or the block's last), and whether a round is
F128_FN bool pair_done(long long k, long long mine) { return (k & 1) || k == mine - 1; }
F128_FN bool round_done(long long k, long long mine) {
    return ((k >> 1) + 1) % kRoundPairs == 0 || k == mine - 1;
}

F128_FN long long round_start(long long pair) { return pair - pair % kRoundPairs; }

// Thread tid's point of the block's pair j: point p = tid mod kTile of its
// tile 2 j + tid / kTile; -1 where that tile or point is past the end
F128_FN long long pair_point(const Args& a, long long block, long long grid, long long mine,
                             long long j, int tid) {
    const long long k = 2 * j + tid / kTile;
    if (k >= mine) return -1;
    const long long i = (block + k * grid) * kTile + tid % kTile;
    return i < a.lde.n ? i : -1;
}

// What point i's forward reads from device memory (x's and x^incr's table
// entries, c), fetched a tile ahead of it
struct Inputs {
    points::Entries x, xi;
    uint4 c;
};

F128_FN Inputs fetch(const Args& a, long long i) {
    Inputs in;
    in.x = points::table_entries(a.x_lo, a.x_hi, a.log_lo, a.first + i);
    in.xi = points::table_entries(a.i_lo, a.i_hi, a.log_lo, a.first + i);
    in.c = points::load_stream(a.c_lde + i);
    return in;
}

// d = (x - z)(x - zg), with x - z and x - zg
F128_FN u128 denominator(const Args& a, const points::Entries& x_at, u128& xz, u128& xzg) {
    const u128 x = points::entries_power(x_at, a.x_hi);
    xz = f128::sub(x, f128::from_limbs(a.s.z));
    xzg = f128::sub(x, f128::from_limbs(a.s.zg));
    return f128::mul(xz, xzg);
}

// Point i of the thread (the pair's tile tid / kTile, its sums in `sums`,
// its inputs fetched): d and N; out[i] = N q (0 where d = 0) and q *= d.
F128_FN void forward(const Args& a, const u128* sums, long long i, int tid, const Inputs& in,
                     u128& q) {
    u128 xz, xzg;
    const u128 d = denominator(a, in.x, xz, xzg);
    if (d == 0) {
        a.out[i] = f128::to_limbs(0);
        return;
    }
    const int at = (tid / kTile) * 2 * kTile + tid % kTile;
    const u128 a1 = sums[at], a2 = sums[at + kTile];
    const u128 xi = points::entries_power(in.xi, a.i_hi);
    const u128 t = f128::add(f128::mul(f128::sub(a1, f128::from_limbs(a.s.s1)), xzg),
                             f128::mul(f128::sub(a2, f128::from_limbs(a.s.s2)), xz));
    const u128 f = f128::add(f128::from_limbs(a.s.k1), f128::mul(f128::from_limbs(a.s.k2), xi));
    const u128 c = f128::from_limbs(in.c);
    const u128 num = f128::add(
        f128::mul(f, t),
        f128::mul(f128::mul(f128::sub(c, f128::from_limbs(a.s.cz)), f128::from_limbs(a.s.kc)),
                  xzg));
    a.out[i] = f128::to_limbs(f128::mul(num, q));
    q = f128::mul(q, d);
}

// What point i's backward reads: x's table entries and y = out[i]
struct Back {
    points::Entries x;
    uint4 y;
};

F128_FN Back fetch_back(const Args& a, long long i) {
    Back b;
    b.x = points::table_entries(a.x_lo, a.x_hi, a.log_lo, a.first + i);
    b.y = a.out[i];
    return b;
}

// Back through point i with inv = 1/q up to and with it: out[i] = y inv =
// N / d, and inv becomes 1/q before it (nothing where d = 0).
F128_FN void backward(const Args& a, long long i, const Back& b, u128& inv) {
    u128 xz, xzg;
    const u128 d = denominator(a, b.x, xz, xzg);
    if (d == 0) return;
    a.out[i] = f128::to_limbs(f128::mul(f128::from_limbs(b.y), inv));
    inv = f128::mul(inv, d);
}

// The thread's walk back through the round that ends at the block's pair
// j, from inv = 1/q of the round: each point's reads issued one point
// ahead of its multiplies (a point's y is not the next one's)
F128_FN void walk_back(const Args& a, long long block, long long grid, long long mine,
                       long long j, int tid, u128 inv) {
    long long at = pair_point(a, block, grid, mine, j, tid);
    Back cur;
    if (at >= 0) cur = fetch_back(a, at);
    for (long long p = j; p >= round_start(j); --p) {
        const long long next = p > round_start(j) ? pair_point(a, block, grid, mine, p - 1, tid)
                                                  : -1;
        Back ahead;
        if (next >= 0) ahead = fetch_back(a, next);
        if (at >= 0) backward(a, at, cur, inv);
        at = next;
        cur = ahead;
    }
}

}  // namespace deep_compose
