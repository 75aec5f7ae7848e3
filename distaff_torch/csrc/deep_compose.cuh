// K7 deep_compose: step 6 of the prover, the DEEP composition over the LDE
// domain, in one launch.
//
// Replaces the JAX package's fused step-6 dispatches:
// distaff_tpu/stark/prover.py::_compose_tiles_batched (the composition, with
// field_jax.inv_batch_scan for its inverses on an accelerator: K6 on this
// card until now), the x and x^incr power series it takes, and
// distaff_tpu/ops/tiles.py::_wsum_tile (the weighted register sums A1, A2).
// For each point i < n of the domain, x = w^i:
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
// Bound on this card: bytes and operations about alike (2^21 points, 20
// registers: 352 bytes and 53 multiplies a point).  The design:
// - The LDE is read where it lies, (R, D) points of 16 bytes: a thread's
//   point i of register r at r * D + i, a warp's lanes on consecutive i, so
//   each register's load is one coalesced 512-byte row a warp; the loads
//   are streaming (evict first), as nothing reads the LDE again here.  The
//   (R, 4) weights sit in shared memory and are read as broadcasts.  The
//   sums are points.cuh's weighted_sums, which K10 shares.
// - x and x^incr come from two pairs of small power tables, c w^e =
//   lo[e mod 1024] hi[e >> 10] (the tables K1 keeps for the NTT, tiles.
//   _store_factors; points.cuh's table_power): one multiply a point each,
//   no power series.
// - The eight scalars (z, zg, s1, s2, c(z), k1, k2, kc) are kernel
//   arguments.
// - The inverses are Montgomery's trick within the block on values that are
//   already in registers: a thread keeps d, N and the running product for
//   each of its kPerThread points, the block's threads meet in
//   inv_block.cuh's product tree, and one inversion a block runs while the
//   SM's other blocks do their ~50 multiplies a point.
// - A tile is kThreads x kPerThread points, a thread's point k at tile
//   offset k kThreads + tid; points at n or beyond (a partial last tile)
//   count as d = 0 and are not written.  Indices are 64-bit.
// - Each multiply is one carry chain (field128.cuh), so a thread's
//   multiplies do not overlap and the SM needs many warps: 256 threads x 2
//   points with launch bounds for 4 blocks an SM (64 registers, no
//   spills, 32 warps) took 1.03 ms at (20, 2^21) where 4 points at 2 blocks
//   (124 registers, 16 warps) took 1.27 ms (tools/air_probe.py, PERF.md).
//
// Phases, each a function of (block, thread), with barriers between them
// on the card: numerators (loads, sums, d and N, the thread's running
// products), inv_block's tree, store.  This header compiles as plain C++
// too: the tests run the phases a block and a thread at a time against the
// plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "inv_block.cuh"
#include "points.cuh"

// The tile's shape; tools/air_probe.py builds other shapes to time them.
#ifndef DEEP_THREADS
#define DEEP_THREADS 256
#endif
#ifndef DEEP_PER_THREAD
#define DEEP_PER_THREAD 2
#endif

namespace deep_compose {

using f128::u128;

constexpr int kThreads = DEEP_THREADS;
constexpr int kPerThread = DEEP_PER_THREAD;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxRegisters = 128;       // config.MAX_REGISTER_COUNT

struct Scalars {
    uint4 z, zg, s1, s2, cz, k1, k2, kc;
};

struct Args {
    const uint4* lde;        // (regs, lde_stride) points
    long long lde_stride;
    int regs;
    long long n;             // points composed: out[0, n)
    const uint4* c_lde;      // (n,) constraint evaluations
    const uint4* w1;         // (regs,) weights of A1 and A2
    const uint4* w2;
    const uint4* x_lo;       // x = x_lo[i mod 2^log_lo] * x_hi[i >> log_lo], x_lo[i] without x_hi
    const uint4* x_hi;
    const uint4* i_lo;       // x^incr likewise
    const uint4* i_hi;
    int log_lo;
    Scalars s;
    uint4* out;              // (n,)
};

// A thread's points between the phases: d, N and the running product of
// the d that are not zero, up to and with point k.
struct Lane {
    u128 d[kPerThread], num[kPerThread], prefix[kPerThread];
};

F128_FN long long point(long long block, int tid, int k) {
    return block * kTile + (long long)k * kThreads + tid;
}

// Phase 1: the thread's points' d and N, and the product of its d that are
// not zero (returned).  w1, w2: the weights (shared memory on the card).
F128_FN u128 numerators(const Args& a, const uint4* w1, const uint4* w2, long long block,
                        int tid, Lane& lane) {
    long long at[kPerThread];
    bool valid[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        at[k] = point(block, tid, k);
        valid[k] = at[k] < a.n;
    }
    const uint4* const w[2] = {w1, w2};
    u128 acc[2][kPerThread];
    points::weighted_sums<2, kPerThread>(a.lde, a.lde_stride, a.regs, w, at, valid, acc);
    const u128 z = f128::from_limbs(a.s.z), zg = f128::from_limbs(a.s.zg);
    const u128 s1 = f128::from_limbs(a.s.s1), s2 = f128::from_limbs(a.s.s2);
    const u128 cz = f128::from_limbs(a.s.cz), k1 = f128::from_limbs(a.s.k1);
    const u128 k2 = f128::from_limbs(a.s.k2), kc = f128::from_limbs(a.s.kc);
    u128 run = 1;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const long long i = at[k];
        u128 d = 0, num = 0;
        if (valid[k]) {
            const u128 x = points::table_power(a.x_lo, a.x_hi, a.log_lo, i);
            const u128 xi = points::table_power(a.i_lo, a.i_hi, a.log_lo, i);
            const u128 xz = f128::sub(x, z), xzg = f128::sub(x, zg);
            d = f128::mul(xz, xzg);
            const u128 t = f128::add(f128::mul(f128::sub(acc[0][k], s1), xzg),
                                     f128::mul(f128::sub(acc[1][k], s2), xz));
            const u128 f = f128::add(k1, f128::mul(k2, xi));
            const u128 c = f128::from_limbs(points::load_stream(a.c_lde + i));
            num = f128::add(f128::mul(f, t),
                            f128::mul(f128::mul(f128::sub(c, cz), kc), xzg));
        }
        if (d != 0) run = f128::mul(run, d);
        lane.d[k] = d;
        lane.num[k] = num;
        lane.prefix[k] = run;
    }
    return run;
}

// Phase 3: with inv_run the inverse of the thread's product, each point's
// 1/d by Montgomery's walk back (1/d_k = 1/q_k q_(k-1), 1/q_(k-1) = 1/q_k
// d_k, q the running products), and out = N / d, 0 where d = 0.
F128_FN void store(const Args& a, long long block, int tid, const Lane& lane, u128 inv_run) {
#pragma unroll
    for (int k = kPerThread - 1; k >= 0; --k) {
        const long long i = point(block, tid, k);
        const u128 d = lane.d[k];
        u128 value = 0;
        if (d != 0) {
            const u128 inv_d = k ? f128::mul(inv_run, lane.prefix[k - 1]) : inv_run;
            if (k) inv_run = f128::mul(inv_run, d);
            value = f128::mul(inv_d, lane.num[k]);
        }
        if (i < a.n) a.out[i] = f128::to_limbs(value);
    }
}

F128_FN long long blocks(const Args& a) { return (a.n + kTile - 1) / kTile; }

}  // namespace deep_compose
