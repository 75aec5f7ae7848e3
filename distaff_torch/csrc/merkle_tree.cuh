// K13 merkle_tree: every internal node of a BLAKE3 Merkle tree in one
// launch, each block hashing a bottom subtree level by level in shared
// memory, and the last block of each group of subtrees to finish going on
// to hash the group's parent subtree, up to the root.
//
// Replaces the JAX package's distaff_tpu/crypto/merkle_dev.py::
// _build_flat_nodes (all of a tree's levels in one dispatch) and
// ::_build_subtree_nodes (fixed-size subtrees, each hashed to its root).  A
// node is the BLAKE3 of its two children's 64 bytes: one block flagged
// chunk start, chunk end and root (blake3.cuh's hash_block; reference
// merkle.rs node hash).  The output is the flat layout of crypto/merkle.
// MerkleTree: row 0 zero, the root at row 1, node i's children at rows 2i
// and 2i+1 (the leaves below row n), as (n, 8) words.
//
// The design:
// - A plan cuts the tree's log2(n) levels into stages, from the leaves up:
//   stage s hashes levels[s] levels above a level of m_s nodes (m_0 = n,
//   m_{s+1} = m_s >> levels[s]) in subtrees of 2^levels[s] input nodes, so
//   stage s has m_{s+1} subtrees, whose roots are stage s + 1's inputs.
//   The host picks the plan per tree (ops/blake3_torch.tree_plan): one
//   stage where one block has a thread for each node of the first level,
//   else bottom subtrees small enough that the first stage has a block an
//   SM, but of 2^8 leaves at least, and the levels above in as few stages
//   as kMaxLevels allows.
// - The launch has a block for each subtree of stage 0.  A block that has
//   written its subtree's root makes it visible (__threadfence) and takes a
//   ticket from its group's counter: the 2^levels[s+1] subtrees of stage s
//   below one subtree of stage s + 1 are a group.  The block that takes a
//   group's last ticket goes on to hash the group's subtree of stage s + 1,
//   reading its siblings' roots through L2 (ld.global.cg: never a stale L1
//   line), and so on up to the root; the others end.  No block waits for
//   another, so every schedule of the blocks finishes.
// - The counters are an int32 scratch of one word a group (the groups of
//   every stage above the first, stage by stage: counter_base).  The last
//   block of a group sets its counter back to 0, so the next tree finds them
//   all 0 without a memset.  This holds because the trees that share a
//   scratch run one after another: the wrapper keeps one scratch a device
//   and enqueues every tree on its leaves' stream, the current stream.
// - Within a subtree, a level's nodes go to shared memory besides their rows
//   of the flat array, and the next level reads only shared memory, after
//   one __syncthreads() a level.  Two buffers alternate (the odd levels'
//   2^(L-1) nodes and the even levels' 2^(L-2), L the plan's largest stage:
//   48 KB at L = 11, dynamic shared memory sized to the plan), so one
//   barrier a level keeps reads and writes apart.  The first level of stage
//   0 reads each pair of leaves as four 16-byte loads of 64 contiguous bytes.
// - Bank conflicts: a pair of children is 64 bytes, so at a stride of 16
//   words a warp's 16-byte loads of one quarter of each pair would fall on
//   the same four banks of every other thread (4-way).  The buffers are
//   XOR-swizzled instead: 16-byte slot u is stored at u ^ ((u >> 3) & 3),
//   which permutes the slots within each 128-byte row.  The eight lanes of
//   a 16-byte access phase then hit eight different slots of the row of 32
//   banks, both when they read their children (slots 4p + j, four rows)
//   and when they write their node (slots 2p + h, two rows whose swizzles
//   differ in their lowest bit).
// - A block has 2^(levels[0] - 1) threads, at most 256: one node a thread
//   on the first level (four at 2^11).  The compression runs on both integer
//   pipes (blake3.cuh's FmaAdds): its adds issue as IMAD on the FMA pipe,
//   which leaves 483 of the kernel's 818 integer instructions on the
//   integer-only pipe, 590 of 713 before.
//
// Bound on this card: (n - 1) compressions of at least 680 integer
// instructions against 32 bytes read and 32 written a leaf, about even at
// the SMs' instruction rate and 3.35 TB/s (0.043 ms at 2^21 leaves, by
// operations).  Measured on the H100 (PERF.md): 0.0996 ms at 2^21 leaves
// and 1.184 ms at 2^25, 82% of the integer-only pipe's rate for 483
// instructions a compression; the xors and rotates hold that pipe (a
// rotate moved to the FMA pipe as IMAD.WIDE and IMAD was slower,
// tools/air_probe.py k13).  Small trees are latency: 0.006 ms at 2^5 leaves,
// 0.013 ms at 2^13.
//
// This header compiles as plain C++ too: the tests run the kernel's blocks
// on the CPU in any order, each stage a level at a time, against the plain
// version and the JAX package's trees.

#pragma once
#include <cstdint>

#include "blake3.cuh"
#include "field128.cuh"

namespace merkle_tree {

constexpr int kThreads = 256;       // a block's threads at most
constexpr int kMaxLevels = 11;      // a stage's subtree: at most 2^11 input nodes
constexpr int kMaxStages = 40;      // a stage hashes one level at least

struct Args {
    const uint4* leaves;            // (n, 2): the leaf digests as two 16-byte slots
    uint4* nodes;                   // (n, 2): the flat node array
    int* counters;                  // a ticket counter a group, 0 between trees
    long long n;                    // leaves: a power of two, at least 2
    int stages;
    int levels[kMaxStages];         // the levels each stage hashes, from the leaves up
    long long inputs[kMaxStages];   // m_s: stage s's input nodes
    long long counter_base[kMaxStages];   // the counter of stage s's group 0 (s >= 1)
};

// a's plan from levels[0 .. stages): false unless each is in [1, kMaxLevels]
// and they sum to log2 n
inline bool set_plan(Args& a, int stages, const int* levels) {
    if (a.n < 2 || (a.n & (a.n - 1)) || stages < 1 || stages > kMaxStages) return false;
    a.stages = stages;
    long long m = a.n, base = 0;
    for (int s = 0; s < stages; ++s) {
        if (levels[s] < 1 || levels[s] > kMaxLevels || (m >> levels[s]) < 1) return false;
        a.levels[s] = levels[s];
        a.inputs[s] = m;
        a.counter_base[s] = base;
        if (s > 0) base += m >> levels[s];
        m >>= levels[s];
    }
    return m == 1;
}

// the launch's blocks (stage 0's subtrees), and its threads a block
F128_FN long long blocks(const Args& a) { return a.n >> a.levels[0]; }

F128_FN int block_threads(const Args& a) {
    const int first = 1 << (a.levels[0] - 1);
    return first < kThreads ? first : kThreads;
}

// the nodes of the odd and the even levels' buffers at the plan's largest
// stage of L levels (none where L = 1: its only level is a root)
F128_FN int odd_nodes(int largest) { return largest > 1 ? 1 << (largest - 1) : 0; }
F128_FN int even_nodes(int largest) { return largest > 2 ? 1 << (largest - 2) : 0; }

F128_FN int largest_stage(const Args& a) {
    int largest = 0;
    for (int s = 0; s < a.stages; ++s) largest = a.levels[s] > largest ? a.levels[s] : largest;
    return largest;
}

// the 16-byte slot where a shared buffer keeps its slot u (see above)
F128_FN int slot(int u) { return u ^ ((u >> 3) & 3); }

// a subtree's nodes at its level l (1 <= l <= levels)
F128_FN int level_nodes(int levels, int level) { return 1 << (levels - level); }

// Row 0 of the flat array is zero (the JAX package's layout): block 0's
// first thread writes it.
F128_FN void clear_row0(const Args& a, long long block, int thread) {
    if (block == 0 && thread == 0) {
        const uint4 zero = {0, 0, 0, 0};
        a.nodes[0] = zero;
        a.nodes[1] = zero;
    }
}

// a 16-byte slot that another block of the launch wrote: read through L2
F128_FN uint4 load_l2(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldcg(p);
#else
    return *p;
#endif
}

// Node p of level l of subtree g of stage s: its children from the stage's
// input level (l = 1: the leaves, or the roots of stage s - 1 at rows
// [m_s, 2 m_s)) or from `below`, the buffer of level l - 1; the node to
// `above` (but at the subtree's top level) and to its row of the flat
// array.  The subtree's root is node 0 of its top level.
F128_FN void node(const Args& a, int s, long long g, int level, int p, const uint4* below,
                  uint4* above) {
    const int levels = a.levels[s];
    const long long m = a.inputs[s];
    uint4 c[4];
    if (level == 1) {
        const long long pair = (g << (levels - 1)) + p;
        if (s == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) c[j] = a.leaves[4 * pair + j];
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) c[j] = load_l2(a.nodes + 2 * m + 4 * pair + j);
        }
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = below[slot(4 * p + j)];
    }
    uint32_t msg[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        msg[4 * j] = c[j].x;
        msg[4 * j + 1] = c[j].y;
        msg[4 * j + 2] = c[j].z;
        msg[4 * j + 3] = c[j].w;
    }
    uint32_t cv[8];
    blake3::hash_block(cv, msg);
    const uint4 lo = {cv[0], cv[1], cv[2], cv[3]};
    const uint4 hi = {cv[4], cv[5], cv[6], cv[7]};
    if (level < levels) {
        above[slot(2 * p)] = lo;
        above[slot(2 * p + 1)] = hi;
    }
    const long long row = (m >> level) + (g << (levels - level)) + p;
    a.nodes[2 * row] = lo;
    a.nodes[2 * row + 1] = hi;
}

// Subtree g of stage s (s + 1 < stages) has its root written: its group's
// ticket, from the thread that wrote the root.  True for the group's last
// ticket, which sets the counter back to 0: the caller then hashes subtree
// g >> levels[s + 1] of stage s + 1.
F128_FN bool arrive(const Args& a, int s, long long g) {
    const int group_levels = a.levels[s + 1];
    int* counter = a.counters + a.counter_base[s + 1] + (g >> group_levels);
#ifdef __CUDA_ARCH__
    __threadfence();
    const int ticket = atomicAdd(counter, 1);
#else
    const int ticket = (*counter)++;
#endif
    if (ticket != (1 << group_levels) - 1) return false;
    *counter = 0;
#ifdef __CUDA_ARCH__
    __threadfence();
#endif
    return true;
}

}  // namespace merkle_tree
