// K11 syn_div: step 4's three synthetic divisions and their sum in one
// call (three launches).
//
// Replaces the JAX package's distaff_tpu/stark/prover.py::_syn_div_dev (by
// x - 1 and by x - b), _syn_div_expanded_dev (by (x^d - 1)/(x - e)),
// _incl_suffix_sums and the sum of the three (prover.py:568-572), with
// the scans and series they run on (distaff_tpu/ops/tiles.py::_suf_tile,
// suffix_sums, _ps_tile, _scale_tile; math/field_jax.py::cumsum,
// power_series_dev).  For the rows (a, f, t) of the batched iNTT's output
// and 0 <= i < n:
//
//   out[i] = A[i+1] + b^-(i+1) F[i+1] + (i <= n - d ? R[i+d-1] - e R[i+d] : 0)
//   A[k] = sum_{j>=k} a_j,  F[k] = sum_{j>=k} f_j b^j,
//   R[k] = sum_{q>=0, k+qd<n} t_{k+qd},  A[n] = F[n] = R[n] = 0.
//
// Modular sums are exact in any order, so the output is the JAX package's
// bit for bit.
//
// Bound on this card: bytes (three columns read, one written: 64 bytes an
// element against about 5 multiplies).  The design:
// - A tile is kThreads x kPerThread consecutive elements, kPerThread a
//   thread.  Launch 1 writes each tile's totals of a_j and f_j b^j; launch
//   2, one block, turns them in place into the sums of the tiles after
//   each (each thread a chunk of tiles); launch 3 runs each tile's suffix
//   scans from its carry and stores out.  A block scans its threads' sums
//   with a ping-pong Hillis-Steele scan in shared memory, both scans at
//   once.
// - b^j and b^-(j+1) come from two pairs of small power tables (tiles.
//   _store_factors: b's with c = 1, 1/b's with c = 1/b), one multiply a
//   lookup (points.cuh's table_power); j < n, so no exponent is reduced.
//   No power series is built.
// - R[k] is read where it lies, at most n/d terms at stride d (8 in a
//   proof); a thread's kPerThread + 1 values of R cover its elements.
// - Indices are 64-bit (n_ev = 2^23 at 2^20 steps: 8192 tiles).
//
// This header compiles as plain C++ too: the tests run each launch's
// phases a block at a time (every thread of a phase before the next phase)
// against the plain version, with a small tile (-DSYN_DIV_THREADS,
// -DSYN_DIV_PER_THREAD) so that many tiles carry.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "points.cuh"

#ifndef SYN_DIV_THREADS
#define SYN_DIV_THREADS 256
#endif
#ifndef SYN_DIV_PER_THREAD
#define SYN_DIV_PER_THREAD 4
#endif

namespace syn_div {

using f128::u128;

constexpr int kThreads = SYN_DIV_THREADS;
constexpr int kPerThread = SYN_DIV_PER_THREAD;
constexpr long long kTile = (long long)kThreads * kPerThread;

F128_FN constexpr int log2_of(int v) { return v > 1 ? 1 + log2_of(v / 2) : 0; }
constexpr int kLogThreads = log2_of(kThreads);
static_assert((1 << kLogThreads) == kThreads, "kThreads must be a power of two");
constexpr int kScanOut = kLogThreads & 1;      // the buffer the last scan step writes

struct Args {
    const uint4* a;          // a_j, divided by x - 1
    const uint4* f;          // f_j, divided by x - b
    const uint4* t;          // t_j, divided by (x^d - 1)/(x - e)
    long long n, d;
    const uint4* b_lo;       // b^j = b_lo[j mod 2^log_lo] b_hi[j >> log_lo] (b_hi may be null)
    const uint4* b_hi;
    const uint4* binv_lo;    // b^-(j+1) likewise
    const uint4* binv_hi;
    int log_lo;
    uint4 neg_e;             // -e
    uint4* totals;           // (2, tiles): each tile's sums of a_j and f_j b^j, then
                             // (after launch 2) the sums of the tiles after it
    uint4* out;
};

// A block's scan of its threads' two sums: v[buffer][sum][thread].
struct ScanBuffer {
    uint4 v[2][2][kThreads];
};

// A thread's elements: a_i and w_i = f_i b^i (0 at and past n).
struct Column {
    u128 a[kPerThread], w[kPerThread];
};

F128_FN long long tiles(const Args& g) { return (g.n + kTile - 1) / kTile; }

F128_FN long long first(long long tile, int tid) { return tile * kTile + (long long)tid * kPerThread; }

// Launches 1 and 3, first phase: the thread's elements and their two sums
// into buffer 0.
F128_FN void load(const Args& g, long long tile, int tid, Column& c, ScanBuffer& s) {
    const long long i0 = first(tile, tid);
    u128 sa = 0, sw = 0;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const long long i = i0 + e;
        c.a[e] = c.w[e] = 0;
        if (i < g.n) {
            c.a[e] = f128::from_limbs(points::load_ro(g.a + i));
            c.w[e] = f128::mul(f128::from_limbs(points::load_ro(g.f + i)),
                               points::table_power(g.b_lo, g.b_hi, g.log_lo, i));
        }
        sa = f128::add(sa, c.a[e]);
        sw = f128::add(sw, c.w[e]);
    }
    s.v[0][0][tid] = f128::to_limbs(sa);
    s.v[0][1][tid] = f128::to_limbs(sw);
}

// Scan step k < kLogThreads (every launch): buffer k & 1 to the other,
// v[tid] += v[tid + 2^k].  After the last, buffer kScanOut holds each
// thread's inclusive suffix sums over the block's threads.
F128_FN void scan_step(ScanBuffer& s, int k, int tid) {
    const int from = k & 1, off = 1 << k;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        u128 v = f128::from_limbs(s.v[from][x][tid]);
        if (tid + off < kThreads) v = f128::add(v, f128::from_limbs(s.v[from][x][tid + off]));
        s.v[from ^ 1][x][tid] = f128::to_limbs(v);
    }
}

// The sums of the threads after tid (exclusive suffix), sum x.
F128_FN u128 after(const ScanBuffer& s, int x, int tid) {
    return tid + 1 < kThreads ? f128::from_limbs(s.v[kScanOut][x][tid + 1]) : 0;
}

// Launch 1, last phase: the tile's two totals.
F128_FN void store_totals(const Args& g, const ScanBuffer& s, long long tile, int tid) {
    if (tid != 0) return;
    g.totals[tile] = s.v[kScanOut][0][0];
    g.totals[tiles(g) + tile] = s.v[kScanOut][1][0];
}

// Launch 2 (one block): thread tid's chunk of tiles and its sums into
// buffer 0, ...
F128_FN long long chunk(const Args& g) { return (tiles(g) + kThreads - 1) / kThreads; }

F128_FN void chunk_sums(const Args& g, ScanBuffer& s, int tid) {
    const long long nt = tiles(g), lo = tid * chunk(g);
    const long long hi = lo + chunk(g) < nt ? lo + chunk(g) : nt;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        u128 v = 0;
        for (long long t = lo; t < hi; ++t) v = f128::add(v, f128::from_limbs(g.totals[x * nt + t]));
        s.v[0][x][tid] = f128::to_limbs(v);
    }
}

// ... then, after the scan, each tile's total replaced by the sum of the
// tiles after it.
F128_FN void chunk_carries(const Args& g, const ScanBuffer& s, int tid) {
    const long long nt = tiles(g), lo = tid * chunk(g);
    const long long hi = lo + chunk(g) < nt ? lo + chunk(g) : nt;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        u128 carry = after(s, x, tid);
        for (long long t = hi - 1; t >= lo; --t) {
            const u128 v = f128::from_limbs(g.totals[x * nt + t]);
            g.totals[x * nt + t] = f128::to_limbs(carry);
            carry = f128::add(carry, v);
        }
    }
}

// R[k]: the stride-d suffix sum of t from k (0 for k >= n).
F128_FN u128 stride_sum(const Args& g, long long k) {
    u128 s = 0;
    for (; k < g.n; k += g.d) s = f128::add(s, f128::from_limbs(points::load_ro(g.t + k)));
    return s;
}

// Launch 3, last phase: the thread's outputs, from the sums of the tiles
// after this one and of the threads after this one, element by element
// from the last.
F128_FN void finish(const Args& g, const Column& c, const ScanBuffer& s, long long tile, int tid) {
    const long long nt = tiles(g), i0 = first(tile, tid);
    u128 sa = f128::add(after(s, 0, tid), f128::from_limbs(g.totals[tile]));
    u128 sw = f128::add(after(s, 1, tid), f128::from_limbs(g.totals[nt + tile]));
    // R[i + d - 1 + e] for e <= kPerThread, where some element has i <= n - d
    u128 r[kPerThread + 1];
    const bool divides = i0 <= g.n - g.d;
#pragma unroll
    for (int e = 0; e <= kPerThread; ++e) r[e] = divides ? stride_sum(g, i0 + g.d - 1 + e) : 0;
    const u128 neg_e = f128::from_limbs(g.neg_e);
#pragma unroll
    for (int e = kPerThread - 1; e >= 0; --e) {
        const long long i = i0 + e;
        if (i < g.n) {
            u128 v = f128::add(sa, f128::mul(points::table_power(g.binv_lo, g.binv_hi,
                                                                 g.log_lo, i), sw));
            if (i <= g.n - g.d) v = f128::add(v, f128::add(r[e], f128::mul(neg_e, r[e + 1])));
            g.out[i] = f128::to_limbs(v);
        }
        sa = f128::add(sa, c.a[e]);
        sw = f128::add(sw, c.w[e]);
    }
}

}  // namespace syn_div
