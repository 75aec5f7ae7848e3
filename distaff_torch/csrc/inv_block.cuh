// Montgomery's trick across the threads of a block, for K7 deep_compose:
// each thread brings the product of its own elements
// (zeros counted as ones, so the product is never zero) and gets back that
// product's inverse, for one field inversion a block.
//
// The threads' products go into a binary tree in shared memory, in heap
// order: thread t's product is leaf kThreads + t, node j the product of its
// children 2j and 2j + 1, node 1 the block's product.  log2(kThreads)
// levels go up, one thread inverts the root (field128.cuh's inv, Kaliski's
// inverse, as K6's), and log2(kThreads) levels come down, the inverse of a
// node giving its children's: 1/L = R/(LR) and 1/R = L/(LR), written over
// the children in place.  One multiply a node up and two down: about 3 a
// thread, and one inversion a block.
//
// Each level is a function of (tree, thread, level) with a barrier between
// levels on the card, so the host build of a kernel runs the same levels a
// thread at a time (no warp shuffles).  This header compiles as plain C++
// too (field128.cuh's qualifiers vanish; the barriers are the card's only).

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace inv_block {

using f128::u128;

// Up the tree, level 0 first: node j = product of its children, for the
// threads / 2^(level+1) nodes j of the level.
F128_FN void up(u128* tree, int threads, int tid, int level) {
    const int first = threads >> (level + 1);
    if (tid < first) {
        const int j = first + tid;
        tree[j] = f128::mul(tree[2 * j], tree[2 * j + 1]);
    }
}

// The root's inverse in place (one thread).
F128_FN void invert_root(u128* tree) { tree[1] = f128::inv(tree[1]); }

// Down the tree, the top level (log2(threads) - 1) first: the children of
// each node of the level from its inverse.
F128_FN void down(u128* tree, int threads, int tid, int level) {
    const int first = threads >> (level + 1);
    if (tid < first) {
        const int j = first + tid;
        const u128 inv = tree[j], left = tree[2 * j], right = tree[2 * j + 1];
        tree[2 * j] = f128::mul(inv, right);
        tree[2 * j + 1] = f128::mul(inv, left);
    }
}

template <int N> struct Log2 { static constexpr int value = 1 + Log2<N / 2>::value; };
template <> struct Log2<1> { static constexpr int value = 0; };

#ifdef __CUDACC__
// The inverse of `total` (nonzero) for each of the block's kThreads threads;
// `tree` is 2 * kThreads elements of shared memory.  Every thread of the
// block must call it (barriers).
template <int kThreads>
__device__ __forceinline__ u128 inverse_of_total(u128* tree, u128 total) {
    constexpr int kLevels = Log2<kThreads>::value;
    static_assert((1 << kLevels) == kThreads, "inv_block: threads a power of two");
    const int tid = threadIdx.x;
    tree[kThreads + tid] = total;
    __syncthreads();
    for (int level = 0; level < kLevels; ++level) {
        up(tree, kThreads, tid, level);
        __syncthreads();
    }
    if (tid == 0) invert_root(tree);
    __syncthreads();
    for (int level = kLevels - 1; level >= 0; --level) {
        down(tree, kThreads, tid, level);
        __syncthreads();
    }
    return tree[kThreads + tid];
}
#endif

}  // namespace inv_block
