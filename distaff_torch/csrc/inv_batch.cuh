// K6 inv_batch's passes and its block tree: Montgomery's trick with one
// inversion a block.
//
// A block owns per_thread x kThreads consecutive elements; thread t's
// element k is at (block per_thread + k) kThreads + t, so that a warp's
// loads and stores are coalesced.  Zeros count as ones and map back to
// zero, with no branch around a multiply.
//   - forward: the thread's running product, the product up to and
//     including each element (its prefix) stored in `out` as scratch;
//   - the block tree (invert_total): the threads' products meet in a
//     butterfly of warp shuffles, then the warps' products in warp 0, and
//     one thread inverts the block's product (f128::inv); each thread
//     forms the product of every other thread's meanwhile, so that one
//     multiply follows the inversion: three barriers in all;
//   - backward: last element first, inv(a_k) = inv(q_k) q_(k-1) and
//     inv(q_(k-1)) = inv(q_k) a_k, two independent multiplies.
// Three multiplies an element and a few a thread, one inversion a block.
// A thread keeps one product and few registers, so that many warps hide
// the latency of each other's multiplies and loads (its loops unrolled by
// 4, the loads ahead of the multiplies).  The passes are bound by the
// multiplies' instructions and latency, not by the scratch's bytes: a
// build that kept a thread's first 8 prefixes in shared memory was no
// faster (PERF.md).
//
// The passes are functions of (block, thread), plain C++ on the host too
// (field128.cuh's qualifiers vanish), so the CPU tests run them a thread at
// a time with the tree's shuffles over an array of lanes.

#pragma once
#include <cstdint>

#include "field128.cuh"

#ifndef K6_THREADS
#define K6_THREADS 256
#endif

namespace inv_batch {

using f128::u128;

constexpr int kThreads = K6_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // the passes' loops unrolled by

struct Args {
    const uint4* a;
    uint4* out;                          // the prefixes until the backward pass overwrites them
    long long n;
    long long per_thread;                // a thread's elements
};

// index of the k-th element of thread tid of block b
F128_FN long long element(const Args& g, long long b, int tid, long long k) {
    return (b * g.per_thread + k) * kThreads + tid;
}

// the thread's elements below n
F128_FN long long count(const Args& g, long long b, int tid) {
    const long long first = element(g, b, tid, 0);
    if (first >= g.n) return 0;
    const long long count = (g.n - 1 - first) / kThreads + 1;
    return count < g.per_thread ? count : g.per_thread;
}

// a zero counts as one in the products
F128_FN u128 factor(uint4 v) {
    const u128 x = f128::from_limbs(v);
    return x == 0 ? (u128)1 : x;
}

// the forward pass over the thread's `count` elements: their product
F128_FN u128 forward(const Args& g, long long b, int tid, long long count) {
    u128 q = 1;
#pragma unroll kUnroll
    for (long long k = 0; k < count; ++k) {
        q = f128::mul(q, factor(g.a[element(g, b, tid, k)]));
        g.out[element(g, b, tid, k)] = f128::to_limbs(q);
    }
    return q;
}

// the backward pass, inv_q the inverse of the thread's product
F128_FN void backward(const Args& g, long long b, int tid, long long count, u128 inv_q) {
#pragma unroll kUnroll
    for (long long k = count - 1; k >= 0; --k) {
        const long long i = element(g, b, tid, k);
        const uint4 v = g.a[i];
        const u128 before = k ? f128::from_limbs(g.out[element(g, b, tid, k - 1)]) : (u128)1;
        const u128 inverse = f128::mul(inv_q, before);
        inv_q = f128::mul(inv_q, factor(v));
        g.out[i] = f128::to_limbs(f128::from_limbs(v) == 0 ? 0 : inverse);
    }
}

#ifdef __CUDACC__
__device__ __forceinline__ u128 shfl_xor(u128 v, int mask) {
    uint4 l = f128::to_limbs(v);
    l.x = __shfl_xor_sync(0xFFFFFFFFu, l.x, mask);
    l.y = __shfl_xor_sync(0xFFFFFFFFu, l.y, mask);
    l.z = __shfl_xor_sync(0xFFFFFFFFu, l.z, mask);
    l.w = __shfl_xor_sync(0xFFFFFFFFu, l.w, mask);
    return f128::from_limbs(l);
}

// The inverse of `total` (nonzero) for each thread of the block; every
// thread must call it (three barriers).  Up: a butterfly of shuffles leaves
// the warp's product in every lane, and beside it the product of the other
// lanes' (the partners of every level); warp 0 does the same over the
// warps' products and keeps, for each warp, the product of the others'.
// One thread inverts the block's product between two barriers (inside a
// diverged warp, ahead of a shuffle, the same inversion took ~2 us longer:
// tools/air_probe.py k6); the inverse of a thread's product is that times
// every other thread's, one multiply.  `shared` holds kWarps + 1 elements.
__device__ __forceinline__ u128 invert_total(u128 total, uint4* shared) {
    constexpr int kBlockLevels = kWarps == 1 ? 0 : kWarps == 2 ? 1 : kWarps == 4 ? 2 : 3;
    static_assert(kWarps == 1 << kBlockLevels, "K6: 32, 64, 128 or 256 threads");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    u128 v = total, others = 1;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
        const u128 partner = shfl_xor(v, 1 << l);
        v = f128::mul(v, partner);
        others = l ? f128::mul(others, partner) : partner;
    }
    if (lane == 0) shared[warp] = f128::to_limbs(v);
    __syncthreads();
    if (warp == 0) {
        u128 w = f128::from_limbs(shared[lane % kWarps]), other_warps = 1;
#pragma unroll
        for (int l = 0; l < kBlockLevels; ++l) {
            const u128 partner = shfl_xor(w, 1 << l);
            w = f128::mul(w, partner);
            other_warps = l ? f128::mul(other_warps, partner) : partner;
        }
        __syncwarp();
        if (lane < kWarps) shared[lane] = f128::to_limbs(other_warps);
        if (lane == 0) shared[kWarps] = f128::to_limbs(w);
    }
    __syncthreads();
    if (threadIdx.x == 0)
        shared[kWarps] = f128::to_limbs(f128::inv(f128::from_limbs(shared[kWarps])));
    others = f128::mul(others, f128::from_limbs(shared[warp]));
    __syncthreads();
    return f128::mul(f128::from_limbs(shared[kWarps]), others);
}
#endif

}  // namespace inv_batch
