// K8 poly_eval: rows of polynomial coefficients evaluated at up to
// kMaxPoints points in one launch.
//
// Replaces the JAX package's point evaluations of step 6:
// distaff_tpu/stark/prover.py::_ps_points (a power series of each point over
// a tile) and _poly_eval_tile_multi (its products with the coefficients and
// their sum), driven by _poly_eval_rows_multi.
//
// Bound on this card: bytes (each coefficient read once, for every point of
// its row at once: 20 x 2^16 coefficients at two points, 2^19 at one, 21
// and 8 MB).  What sets the time is the multiplies it issues (about one
// a coefficient and point, ~90 instructions each) and, in small calls, the
// depth of the dependent ones and the blocks in flight.  The design:
// - one launch a call: block b of a row takes the span of 2^log_span
//   coefficients from b 2^log_span, each thread 2^kLog of them at stride
//   kThreads (a warp's loads one coalesced 512-byte row), evaluated by
//   Horner in y = x^kThreads.  The card is bound by the multiplies it
//   issues here, and it issues each of the tree's below for the whole warp,
//   as costly as a Horner step: the tree adds 5 multiplies a thread to its
//   2^kLog - 1.  So a thread takes 8 coefficients (kShortLog) in a small
//   call, where the blocks in flight matter (640 blocks at (20, 2^16)),
//   and 64 (kLongLog) from kLongWork coefficients on, where the multiplies
//   do; tools/air_probe.py k8 times each choice at both sizes;
// - the block's 256 values h_t are summed as sum_t h_t x^t by a tree, level
//   k adding h_(t + 2^k) x^(2^k) into h_t for t a multiple of 2^(k+1): five
//   levels inside each warp by shuffles (four a level, one a limb), then
//   the eight warps' values through shared memory in the first warp, three
//   levels more; one barrier;
// - the block scales its value by x^(b 2^log_span), the product of the
//   squarings x^(2^(log_span + j)) at the set bits j of b, and writes it to
//   the row's partials; after __threadfence() it takes a ticket from the
//   row's counter, and the row's last block sums the row's partials (field
//   addition is exact, so their order cannot change a bit), writes the
//   value and resets the counter for the next launch; a second barrier
//   tells the block whether it is the last;
// - every power is a squaring x^(2^k), k < kSquarings, that the host
//   computes and the launch passes as a __grid_constant__ parameter (at
//   most 2 KB): no table, no copy to the card before the kernel.
// The launch order of a user's evaluations is theirs: the prover queues
// both of step 6's and brings the values to the host in one copy.
//
// Phases (Horner, the tree levels, the scale, the last block's sum) are
// functions of (block, thread) with shuffles and barriers between them on
// the card; this header compiles as plain C++ too, and the tests run it a
// block and a thread at a time, the shuffle levels as the same tree,
// against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace poly_eval {

using f128::u128;

constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kLogWarps = 3;
constexpr int kShortLog = 3;               // log2 coefficients a thread in a call under kLongWork
constexpr int kLongLog = 6;                // and from kLongWork coefficients on
constexpr long long kLongWork = 1LL << 22; // rows x len
constexpr int kBatch = 8;                  // coefficients a thread loads at a time
constexpr int kMaxPoints = 4;
constexpr int kSquarings = 32;             // x^(2^k), k < 32: rows up to 2^31 coefficients

// log2 of the coefficients a thread takes in a call over rows x len
F128_FN int log_per_thread(long long rows, long long len) {
    return rows * len >= kLongWork ? kLongLog : kShortLog;
}

struct Args {
    const uint4* in;        // (rows, len) coefficients, low degree first
    uint4* out;             // (rows, points): the values
    uint4* partial;         // (rows, points, blocks): each block's scaled value
    uint32_t* tickets;      // (rows): 0 before and after each launch
    long long len;
    int log_span;           // a block's span: kThreads 2^log_per_thread coefficients
    int blocks;             // blocks a row, ceil(len / 2^log_span)
    int points;             // <= kMaxPoints
    uint4 sq[kMaxPoints][kSquarings];   // sq[p][k] = x_p^(2^k)
};

F128_FN uint4 load_ro(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// read past L1: the partials other blocks wrote
F128_FN uint4 load_l2(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldcg(p);
#else
    return *p;
#endif
}

F128_FN u128 square(const Args& a, int p, int k) { return f128::from_limbs(a.sq[p][k]); }

// Phase 1: thread tid's h_p = sum_m c[j_m] y^m, m < 2^kLog, j_m = block
// 2^log_span + tid + m kThreads, y = x_p^kThreads, for each point
// (coefficients at len or beyond count as zero); the coefficients loaded
// kBatch at a time, from the highest.
template <int kLog>
F128_FN void horner(const Args& a, long long row, long long block, int tid,
                    u128 (&h)[kMaxPoints]) {
    constexpr int kBatches = (1 << kLog) / kBatch;
    const uint4* in = a.in + row * a.len;
    const long long first = (block << a.log_span) + tid;
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p) h[p] = 0;
#pragma unroll 1
    for (int batch = kBatches - 1; batch >= 0; --batch) {
        u128 c[kBatch];
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
            const long long j = first + (long long)(batch * kBatch + m) * kThreads;
            c[m] = j < a.len ? f128::from_limbs(load_ro(in + j)) : 0;
        }
#pragma unroll
        for (int p = 0; p < kMaxPoints; ++p) {
            if (p >= a.points) continue;
            const u128 y = square(a, p, kLogThreads);
            u128 v = c[kBatch - 1];
            if (batch != kBatches - 1) v = f128::add(f128::mul(h[p], y), v);
#pragma unroll
            for (int m = kBatch - 2; m >= 0; --m) v = f128::add(f128::mul(v, y), c[m]);
            h[p] = v;
        }
    }
}

// Tree level k: h_p += v_p x_p^(2^k), v the value of the thread 2^k places
// on at the warp's levels (k < 5), of the warp 2^(k - 5) places on at the
// block's (5 <= k < kLogThreads).
F128_FN void combine(const Args& a, int k, u128 (&h)[kMaxPoints], const u128 (&v)[kMaxPoints]) {
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p)
        if (p < a.points) h[p] = f128::add(h[p], f128::mul(v[p], square(a, p, k)));
}

// The block's value times x^(block 2^log_span): the squarings
// x^(2^(log_span + j)) at the set bits j of the block's index.
F128_FN void scale(const Args& a, long long block, u128 (&h)[kMaxPoints]) {
    for (int j = 0; (block >> j) != 0; ++j)
        if ((block >> j) & 1) {
#pragma unroll
            for (int p = 0; p < kMaxPoints; ++p)
                if (p < a.points) h[p] = f128::mul(h[p], square(a, p, a.log_span + j));
        }
}

F128_FN long long partial_at(const Args& a, long long row, int p, long long block) {
    return (row * a.points + p) * a.blocks + block;
}

// The block's value where it goes: the row's value when the row has one
// block, else the block's partial.
F128_FN void store(const Args& a, long long row, long long block, const u128 (&h)[kMaxPoints]) {
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p) {
        if (p >= a.points) continue;
        const uint4 v = f128::to_limbs(h[p]);
        if (a.blocks == 1)
            a.out[row * a.points + p] = v;
        else
            a.partial[partial_at(a, row, p, block)] = v;
    }
}

// The last block: thread tid's sum of the partials tid, tid + kThreads, ...
F128_FN void gather(const Args& a, long long row, int tid, u128 (&h)[kMaxPoints]) {
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p) {
        h[p] = 0;
        if (p < a.points)
            for (long long b = tid; b < a.blocks; b += kThreads)
                h[p] = f128::add(h[p],
                                 f128::from_limbs(load_l2(a.partial + partial_at(a, row, p, b))));
    }
}

F128_FN void add_into(const Args& a, u128 (&h)[kMaxPoints], const u128 (&v)[kMaxPoints]) {
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p)
        if (p < a.points) h[p] = f128::add(h[p], v[p]);
}

}  // namespace poly_eval
