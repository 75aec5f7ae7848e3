// K11 syn_div: step 4's three synthetic divisions and their sum in one
// single-pass launch that reads each column once.
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
//   R[k] = t_k + R[k+d],  A[k] = F[k] = R[k] = 0 for k >= n.
//
// Modular sums are exact in any order, so the output is the JAX package's
// bit for bit.
//
// The design: a chained scan in one pass (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA, 2016), run from
// the end of the columns.
// - A tile is kThreads x kPerThread consecutive elements.  A block claims
//   its tile by an atomic ticket in descending tile order, so every tile
//   it waits on is already running: nothing can deadlock.  It loads a, f
//   and t striped, so that each warp's reads are coalesced, into shared
//   memory; each thread then sums its kPerThread consecutive elements
//   (f_j b^j by Horner, times one power of b from b's small power tables:
//   points.cuh's table_power, tiles._store_factors), and the block scans
//   those sums with warp shuffles on the limbs in registers, then across
//   the warps.
// - It publishes the aggregate of its two sums, computes and publishes its
//   R (below), then looks back over the tiles after it, a warp's 32 tiles
//   at a time, adding aggregates until it meets a tile that has published
//   its inclusive sums; it then publishes its own inclusive sums.  Each descriptor's values are written before its
//   status word, which is stored with release semantics (st.release.gpu) and
//   read with acquire (ld.acquire.gpu, once the word is seen set by relaxed
//   polls: an acquire invalidates the SM's L1); a status is set once a
//   value and the values are never written again, so neither is read torn.
//   Values written in the launch are read from L2 (ld.global.cg).
// - R: the tile computes R over its own range from t and from the R that
//   the tiles d elements ahead have published (their tickets came earlier),
//   and writes it to a scratch column that later tiles read, mostly from L2.
//   Where d is smaller than a tile, the stride-d chain runs inside the tile
//   (doubling steps in shared memory) from the R of the next tile.
// - Out is computed blocked, each thread's elements from the last, into
//   shared memory, and stored striped; the division by x - b as its
//   recurrence b^-i F[i] = f_i + b b^-(i+1) F[i+1], from one lookup of
//   b^-(i+1) a thread.  So a, f and t are each read once and out written
//   once, every access of a warp coalesced, with 3 multiplies an element.
// - Indices are 64-bit (n = 2^23 at 2^20 steps: 8192 tiles).  The status
//   words and the ticket are zeroed by one cudaMemsetAsync before the
//   launch (syn_div.cu).
//
// Bound on this card: bytes (three columns read, one written: 64 bytes an
// element, against 3 multiplies); the R scratch (16 bytes written and read
// again an element) is not counted.  What sets the time (air_probe k11 on
// the H100, PERF.md): at n = 2^19, where every tile is resident at once,
// the R chain's n/d = 8 dependent levels (a third of it); from 2^21 the
// epilogue's dependent multiplies and the loads and scans, each a third;
// the look-back a sixth at most.
//
// This header compiles as plain C++ too: the tests run the blocks' phases a
// block at a time (each phase for every thread before the next), their
// warp shuffles as the same steps over arrays of lanes, with small tiles
// (-DSYN_DIV_THREADS, -DSYN_DIV_PER_THREAD) so that many tiles carry.

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
constexpr int kTile = kThreads * kPerThread;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
static_assert(kThreads % kLanes == 0 && kWarps <= kLanes, "whole warps, at most 32");

// a tile's status word
constexpr uint32_t kEmpty = 0, kAggregate = 1, kInclusive = 2;

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
    uint4 b;                 // b
    uint4 neg_e;             // -e
    uint32_t* flags;         // (2 tiles + 1): status words, R-ready words, the ticket; zero
    uint4* sums;             // (tiles, 4): aggregates of a and w, inclusive sums of a and w
    uint4* r;                // (n,) R
    uint4* out;
};

F128_FN long long tiles(const Args& g) { return (g.n + kTile - 1) / kTile; }

F128_FN uint32_t* status(const Args& g, long long tile) { return g.flags + tile; }
F128_FN uint32_t* r_ready(const Args& g, long long tile) { return g.flags + tiles(g) + tile; }
F128_FN uint32_t* ticket(const Args& g) { return g.flags + 2 * tiles(g); }

constexpr int kSlots = kTile + kTile / 8;

// Shared memory index of element x of the tile: one slot of padding every
// 8, so that neither striped nor blocked (kPerThread 4 or 8) accesses
// conflict.
F128_FN int slot(long long x) { return (int)(x + (x >> 3)); }

// A block's shared memory (dynamic: above 48 KB at the card's tile).
struct Shared {
    uint4 a[kSlots];                     // a_i (0 at and past n), then out_i
    uint4 f[kSlots];                     // f_i (0 at and past n)
    uint4 v[kSlots];                     // t_i, then R: see store_r
    uint4 warp_sums[2][kWarps];          // each warp's sums, then those of the warps after it
    uint4 carry[2];                      // the sums of the tiles after this one
    uint4 first;                         // R[s + d - 1] where d >= kTile
    long long tile;
};

F128_FN long long start(long long tile) { return tile * kTile; }

// ---- memory order of the descriptors --------------------------------------------------------------

F128_FN uint32_t load_relaxed(const uint32_t* p) {
#ifdef __CUDA_ARCH__
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
#else
    return *p;
#endif
}

F128_FN uint32_t load_acquire(const uint32_t* p) {
#ifdef __CUDA_ARCH__
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
#else
    return *p;
#endif
}

F128_FN void store_release(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
#else
    *p = v;
#endif
}

// values that other blocks wrote in this launch: from L2, never from L1
F128_FN uint4 load_l2(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldcg(p);
#else
    return *p;
#endif
}

#ifndef __CUDA_ARCH__
// the phases the tests ran out of order: a wait that found its word unset
inline int host_unready = 0;
#endif

// The word at p once it is at least `want`: the card spins on relaxed
// loads (an acquire invalidates the SM's L1 each time) and then reads it
// once with acquire; the CPU tests run the phases in an order where it is
// set, and count it if not.
F128_FN uint32_t wait_for(const uint32_t* p, uint32_t want) {
#ifdef __CUDA_ARCH__
    while (load_relaxed(p) < want) __nanosleep(32);
#else
    if (*p < want) ++host_unready;
#endif
    return load_acquire(p);
}

// ---- phases -------------------------------------------------------------------------------------

// Load, striped (coalesced): a_i, f_i and t_i into shared memory.
F128_FN void load(const Args& g, Shared& s, long long tile, int tid) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int x = e * kThreads + tid;
        const long long i = start(tile) + x;
        const uint4 zero = {0, 0, 0, 0};
        s.a[slot(x)] = i < g.n ? points::load_stream(g.a + i) : zero;
        s.f[slot(x)] = i < g.n ? points::load_stream(g.f + i) : zero;
        s.v[slot(x)] = i < g.n ? points::load_stream(g.t + i) : zero;
    }
}

// A thread's sums of its kPerThread consecutive elements i0 + e (blocked):
// of a_i, and of f_i b^i as b^i0 times sum_e f_(i0+e) b^e, by Horner.
F128_FN void thread_sums(const Args& g, const Shared& s, long long tile, int tid,
                         u128 (&sum)[2]) {
    const u128 b = f128::from_limbs(g.b);
    const int x0 = tid * kPerThread;
    const long long i0 = start(tile) + x0;
    sum[0] = 0;
    u128 horner = 0;
#pragma unroll
    for (int e = kPerThread - 1; e >= 0; --e) {
        sum[0] = f128::add(sum[0], f128::from_limbs(s.a[slot(x0 + e)]));
        const u128 f = f128::from_limbs(s.f[slot(x0 + e)]);
        horner = e == kPerThread - 1 ? f : f128::add(f128::mul(horner, b), f);
    }
    sum[1] = i0 < g.n ? f128::mul(horner, points::table_power(g.b_lo, g.b_hi, g.log_lo, i0)) : 0;
}

// One step of an inclusive suffix scan over `count` lanes: the lane's
// value plus the value `off` lanes up (read with __shfl_down_sync), where
// there is one.
F128_FN u128 suffix_step(u128 v, u128 up, int lane, int off, int count) {
    return lane + off < count ? f128::add(v, up) : v;
}

// After the warps' scans: lane 0's inclusive sums are the warp's.
F128_FN void store_warp_sums(Shared& s, const u128 (&inclusive)[2], int warp) {
    s.warp_sums[0][warp] = f128::to_limbs(inclusive[0]);
    s.warp_sums[1][warp] = f128::to_limbs(inclusive[1]);
}

// Publish: the tile's aggregate, or for the last tile its inclusive sums.
F128_FN void publish_aggregate(const Args& g, long long tile, const u128 (&total)[2]) {
    const bool last = tile == tiles(g) - 1;
    g.sums[4 * tile + (last ? 2 : 0)] = f128::to_limbs(total[0]);
    g.sums[4 * tile + (last ? 3 : 1)] = f128::to_limbs(total[1]);
    store_release(status(g, tile), last ? kInclusive : kAggregate);
}

// A look-back lane's tile p: its status, once it has one, and the sums it
// then holds (inclusive or aggregate).
F128_FN uint32_t peek(const Args& g, long long p, u128 (&v)[2]) {
    const uint32_t st = wait_for(status(g, p), kAggregate);
    const int at = st == kInclusive ? 2 : 0;
    v[0] = f128::from_limbs(load_l2(g.sums + 4 * p + at));
    v[1] = f128::from_limbs(load_l2(g.sums + 4 * p + at + 1));
    return st;
}

F128_FN void publish_inclusive(const Args& g, Shared& s, long long tile, const u128 (&total)[2],
                               const u128 (&carry)[2]) {
    s.carry[0] = f128::to_limbs(carry[0]);
    s.carry[1] = f128::to_limbs(carry[1]);
    if (tile == tiles(g) - 1) return;
    g.sums[4 * tile + 2] = f128::to_limbs(f128::add(total[0], carry[0]));
    g.sums[4 * tile + 3] = f128::to_limbs(f128::add(total[1], carry[1]));
    store_release(status(g, tile), kInclusive);
}

// R: the elements of R that the tile reads from the tiles after it,
// [r_from, r_to): those the out of its elements reads (R[i + d - 1],
// R[i + d]) and those its own chain starts from (R[k + d q] just past the
// tile).
F128_FN long long r_from(const Args& g, long long tile) {
    const long long s = start(tile);
    return s + kTile > s + g.d - 1 ? s + kTile : s + g.d - 1;
}

F128_FN long long r_to(const Args& g, long long tile) {
    const long long end = start(tile) + g.d + kTile;
    return end < g.n ? end : g.n;
}

// One thread waits for the tiles that hold [r_from, r_to) to have written
// their R (the block's barrier then orders the others' reads after it).
F128_FN void wait_r(const Args& g, long long tile) {
    const long long lo = r_from(g, tile), hi = r_to(g, tile);
    if (lo >= hi) return;
    for (long long p = lo / kTile; p <= (hi - 1) / kTile; ++p) wait_for(r_ready(g, p), 1);
}

// R[m] for m past the tile (0 past n)
F128_FN u128 r_after(const Args& g, long long m) {
    return m < g.n ? f128::from_limbs(load_l2(g.r + m)) : 0;
}

// Where d < kTile, doubling step `off` (d, 2d, 4d, ... < kTile) of the
// stride-d suffix sums of t within the tile: first each thread reads the
// values `off` up of its striped elements, ...
F128_FN void chain_read(const Shared& s, int off, int tid, u128 (&up)[kPerThread]) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int x = e * kThreads + tid;
        up[e] = x + off < kTile ? f128::from_limbs(s.v[slot(x + off)]) : 0;
    }
}

// ... then, after a barrier, adds them.
F128_FN void chain_add(Shared& s, int tid, const u128 (&up)[kPerThread]) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int x = e * kThreads + tid;
        s.v[slot(x)] = f128::to_limbs(f128::add(f128::from_limbs(s.v[slot(x)]), up[e]));
    }
}

// The tile's R, striped: each element's in-tile stride sum (t itself where
// d >= kTile) plus the R at the first element of its stride past the
// tile, into the scratch column.  Where d < kTile, v[x] becomes R[s + x];
// where d >= kTile, v[x] becomes the R[s + x + d] it read (what out reads)
// and `first` R[s + d - 1].
F128_FN void store_r(const Args& g, Shared& s, long long tile, int tid) {
    const bool ahead = g.d >= kTile;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int x = e * kThreads + tid;
        const long long k = start(tile) + x;
        const long long past = k + g.d * ((kTile - x + g.d - 1) / g.d);
        const u128 r_past = r_after(g, past);
        const uint4 own = f128::to_limbs(f128::add(f128::from_limbs(s.v[slot(x)]), r_past));
        if (k < g.n) g.r[k] = own;
        s.v[slot(x)] = ahead ? f128::to_limbs(r_past) : own;
        if (ahead && g.d == kTile && x == kTile - 1) s.first = own;
    }
    if (ahead && g.d > kTile && tid == 0) s.first = f128::to_limbs(r_after(g, start(tile) + g.d - 1));
}

// R[m] for the out of one of the tile's elements (m = i + d - 1 or i + d)
F128_FN u128 r_for_out(const Args& g, const Shared& s, long long tile, long long m) {
    long long x = m - start(tile);
    if (g.d >= kTile) {
        x -= g.d;
        return f128::from_limbs(x < 0 ? s.first : s.v[slot(x)]);
    }
    return x < kTile ? f128::from_limbs(s.v[slot(x)]) : r_after(g, m);
}

// Finish, blocked: the thread's outputs, element by element from the
// last, from the sums of the tiles after this one and of the elements
// after its own in the tile (`after`), into a.  The division by x - b runs
// as its recurrence: with G_i = b^-(i+1) F[i+1], G_(i-1) = f_i + b G_i,
// from the thread's last element's G (one table lookup).
F128_FN void finish(const Args& g, Shared& s, long long tile, int tid, const u128 (&after)[2]) {
    const int x0 = tid * kPerThread;
    const long long last = start(tile) + x0 + kPerThread - 1;
    const u128 b = f128::from_limbs(g.b), neg_e = f128::from_limbs(g.neg_e);
    u128 sa = f128::add(after[0], f128::from_limbs(s.carry[0]));
    u128 gi = last < g.n ? f128::mul(points::table_power(g.binv_lo, g.binv_hi, g.log_lo, last),
                                     f128::add(after[1], f128::from_limbs(s.carry[1])))
                         : 0;
    // R[i + d - 1] of the element after i in the loop, which is R[i + d];
    // where that element took no R term, i = n - d and R[i + d] = R[n] = 0
    u128 r_up = 0;
#pragma unroll
    for (int e = kPerThread - 1; e >= 0; --e) {
        const int x = x0 + e;
        const long long i = start(tile) + x;
        const u128 a = f128::from_limbs(s.a[slot(x)]);
        if (i < g.n) {
            u128 v = f128::add(sa, gi);
            if (i <= g.n - g.d) {
                const u128 r_d = e == kPerThread - 1 ? r_for_out(g, s, tile, i + g.d) : r_up;
                r_up = r_for_out(g, s, tile, i + g.d - 1);
                v = f128::add(v, f128::add(r_up, f128::mul(neg_e, r_d)));
            }
            s.a[slot(x)] = f128::to_limbs(v);
        }
        sa = f128::add(sa, a);
        gi = f128::add(f128::from_limbs(s.f[slot(x)]), f128::mul(b, gi));
    }
}

// Store, striped (coalesced): out from a.
F128_FN void store_out(const Args& g, const Shared& s, long long tile, int tid) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
        const int x = e * kThreads + tid;
        const long long i = start(tile) + x;
        if (i < g.n) g.out[i] = s.a[slot(x)];
    }
}

}  // namespace syn_div
