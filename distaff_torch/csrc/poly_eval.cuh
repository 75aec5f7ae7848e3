// K8 poly_eval: rows of polynomial coefficients evaluated at a few points,
// one pass of the reduction: each block turns kSpan = 4096 coefficients of
// a row into one coefficient of a polynomial in x^kSpan, so a row of L
// coefficients takes ceil(log_4096 L) launches (2 for the 2^16 trace
// polynomials and for the 2^19 constraint polynomial).
//
// Replaces the JAX package's point evaluations of step 6:
// distaff_tpu/stark/prover.py::_ps_points (a power series of each point over
// a tile) and _poly_eval_tile_multi (its products with the coefficients and
// their sum), driven by _poly_eval_rows_multi; on this card they were ~136
// K2 launches and two host syncs a proof.
//
// Bound on this card: bytes (each coefficient read once, for every point of
// its row at once) and latency: the work is small (20 x 2^16 coefficients
// at two points, 2^19 at one), so the depth of the dependent multiplies
// sets the time.  The design keeps that depth short:
// - a thread takes kChunk = 16 coefficients of its row at stride kThreads
//   (a warp's loads are one coalesced 512-byte row) and evaluates them by
//   Horner in y = x^kThreads: 16 dependent multiplies, not 4096;
// - the block's 256 values h_t are summed as sum_t h_t x^t by a tree in
//   shared memory, level k adding h_(t + 2^k) x^(2^k) into h_t for t a
//   multiple of 2^(k+1): 8 levels of one multiply;
// - every power is a square of a square, x^(2^k), from a host table of
//   each point's squarings (the pass's offset picks x^(4096^pass));
// - up to kMaxPoints points share one read of the coefficients (the first
//   pass); later passes have one point a row, row b's point b mod P.
// So the depth of a pass is about 24 multiplies, and a 2^16 row two passes.
// The launch order of a user's evaluations is theirs: the prover queues
// both of step 6's and brings the values to the host in one copy.
//
// Phases (Horner, each tree level, store) are functions of (block, thread)
// with barriers between them on the card; this header compiles as plain
// C++ too, and the tests run it a block and a thread at a time against the
// plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace poly_eval {

using f128::u128;

constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr int kLogChunk = 4;
constexpr int kChunk = 1 << kLogChunk;
constexpr int kLogSpan = kLogThreads + kLogChunk;
constexpr long long kSpan = 1LL << kLogSpan;
constexpr int kMaxPoints = 4;

struct Args {
    const uint4* in;     // (rows, len) coefficients, low degree first
    uint4* out;          // (rows, points, out_len): block (c, b) writes out[(b points + p) out_len + c]
    const uint4* sq;     // (slots, sq_len): sq[s sq_len + k] = x_s^(2^k)
    long long len, out_len;
    int points;          // points a row, <= kMaxPoints
    int row_period;      // row b's first point slot is (b mod row_period) points
    int sq_len, sq_off;  // this pass's x is x_s^(2^sq_off)
};

F128_FN uint4 load_ro(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// x^(2^k) of this pass for point p of row `row`
F128_FN u128 power(const Args& a, long long row, int p, int k) {
    const long long slot = (row % a.row_period) * a.points + p;
    return f128::from_limbs(load_ro(a.sq + slot * a.sq_len + a.sq_off + k));
}

// Phase 1: thread tid's Horner sum h = sum_m c[j_m] y^m, j_m = chunk kSpan +
// tid + m kThreads, y = x^kThreads, for each point; into buf[p kThreads + tid].
// Coefficients at len or beyond count as zero (a partial last chunk).
F128_FN void horner(const Args& a, long long chunk, long long row, int tid, u128* buf) {
    u128 h[kMaxPoints], y[kMaxPoints];
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p) {
        h[p] = 0;
        y[p] = p < a.points ? power(a, row, p, kLogThreads) : 0;
    }
    const long long first = chunk * kSpan + tid;
    const uint4* in = a.in + row * a.len;
    for (int m = kChunk - 1; m >= 0; --m) {
        const long long j = first + (long long)m * kThreads;
        const u128 c = j < a.len ? f128::from_limbs(load_ro(in + j)) : 0;
#pragma unroll
        for (int p = 0; p < kMaxPoints; ++p)
            if (p < a.points) h[p] = f128::add(f128::mul(h[p], y[p]), c);
    }
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p)
        if (p < a.points) buf[p * kThreads + tid] = h[p];
}

// Tree level k: h_t += h_(t + 2^k) x^(2^k) for t a multiple of 2^(k+1).
F128_FN void reduce(const Args& a, long long row, int tid, int level, u128* buf) {
    if (tid & ((2 << level) - 1)) return;
    for (int p = 0; p < a.points; ++p) {
        u128* h = buf + p * kThreads + tid;
        *h = f128::add(*h, f128::mul(h[1 << level], power(a, row, p, level)));
    }
}

// Phase 3: the block's value for each point, sum_t h_t x^t.
F128_FN void store(const Args& a, long long chunk, long long row, int tid, const u128* buf) {
    if (tid < a.points)
        a.out[(row * a.points + tid) * a.out_len + chunk] = f128::to_limbs(buf[tid * kThreads]);
}

}  // namespace poly_eval
