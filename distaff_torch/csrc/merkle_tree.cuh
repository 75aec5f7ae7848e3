// K13 merkle_tree: every internal node of a BLAKE3 Merkle tree in one to
// three launches of one kernel, each block hashing a subtree of up to 2^11
// nodes level by level in shared memory.
//
// Replaces the JAX package's distaff_tpu/crypto/merkle_dev.py::
// _build_flat_nodes (all of a tree's levels in one dispatch) and
// ::_build_subtree_nodes (fixed-size subtrees, each hashed to its root), in
// place of K3's launch a level (137 launches a 2^16 proof).  A node is the
// BLAKE3 of its two children's 64 bytes: one block flagged chunk start,
// chunk end and root (blake3.cuh's hash_block; reference merkle.rs node
// hash).  The output is the flat layout of crypto/merkle.MerkleTree: row 0
// zero, the root at row 1, node i's children at rows 2i and 2i+1 (the
// leaves below row n), as (n, 8) words.
//
// The design:
// - A launch takes one level of m nodes (the leaves, or the roots that the
//   launch before wrote) and hashes `levels` levels above it: block b owns
//   the subtree over input nodes [b 2^levels, (b + 1) 2^levels) and writes
//   its 2^(levels - l) nodes of each level l into their slice of the flat
//   array, which is contiguous, so the stores stay coalesced.  With
//   subtrees of 2^11 a tree of up to 2^11 leaves takes one launch, up to
//   2^22 two (the 2^16 proof's trees) and 2^25 three (the 2^20 proof's
//   trace tree).  The host plans the launches (ops/blake3_torch.
//   tree_launches); all are enqueued on the leaves' stream, with no host
//   sync between them.
// - The first level reads each pair of children as four 16-byte loads of
//   64 contiguous bytes (a warp's loads cover whole 128-byte lines, which
//   L1 keeps for the next of the four).  Each level's nodes also go to
//   shared memory, and the next level reads only shared memory, after one
//   __syncthreads() a level.  Two buffers alternate (2^10 and 2^9 nodes:
//   48 KB, the static limit): a level reads the one the level below wrote
//   and writes the other, so one barrier a level keeps reads and writes
//   apart.
// - Bank conflicts: a pair of children is 64 bytes, so at a stride of 16
//   words a warp's 16-byte loads of one quarter of each pair would fall on
//   the same four banks of every other thread (4-way).  The buffers are
//   XOR-swizzled instead: 16-byte slot u is stored at u ^ ((u >> 3) & 3),
//   which permutes the slots within each 128-byte row.  The eight lanes of
//   a 16-byte access phase then hit eight different slots of the row of 32
//   banks, both when they read their children (slots 4p + j, four rows)
//   and when they write their node (slots 2p + h, two rows whose swizzles
//   differ in their lowest bit).  Padding (one slot every 64 bytes) would
//   also free the reads but leave the writes 2-way and cost a quarter more
//   shared memory, which the 48 KB of two buffers at 2^11 do not have.
// - 256 threads a block at most: the first level of a 2^11 subtree is four
//   nodes a thread, so a block has work for its warps, and several blocks
//   an SM hide the levels near a subtree's root, where most threads wait
//   at the barrier.  The state and message stay in registers (blake3.cuh).
//
// Bound on this card: (n - 1) compressions of at least 680 integer
// instructions against 32 bytes read and 32 written a leaf, about even at
// the SMs' instruction rate and 3.35 TB/s (0.043 ms at 2^21 leaves, by
// operations).  Measured on the H100 (PERF.md): 0.11 ms at 2^21 leaves and
// 1.38 ms at 2^25, 38-50% of the bound, as K3 over rows; the top levels of
// a launch are latency, ~0.6 us a level where few threads are left (a tree
// of 2^5 leaves takes 0.006 ms).  Other launch plans and block sizes were
// slower on the large trees (tools/air_probe.py k13).
//
// This header compiles as plain C++ too: the tests run node() block by
// block, one level at a time, against the plain version.

#pragma once
#include <cstdint>

#include "blake3.cuh"
#include "field128.cuh"

namespace merkle_tree {

constexpr int kThreads = 256;                   // a block's threads at most
constexpr int kMaxLevels = 11;                  // a block's subtree: at most 2^11 input nodes
constexpr int kBufferA = 1 << (kMaxLevels - 1); // nodes of the odd levels' buffer
constexpr int kBufferB = 1 << (kMaxLevels - 2); // nodes of the even levels'

struct Args {
    const uint4* in;    // the launch's input level: m nodes of two 16-byte slots
    uint4* nodes;       // (n, 2): the flat node array
    long long m;        // input nodes: a power of two, at least 2
    int levels;         // levels hashed: each block's subtree has 2^levels input nodes
};

// the launch's blocks, and its threads a block
F128_FN long long blocks(const Args& a) { return a.m >> a.levels; }

F128_FN int block_threads(const Args& a) {
    const int first = 1 << (a.levels - 1);
    return first < kThreads ? first : kThreads;
}

// a block's nodes at level l (1 <= l <= levels)
F128_FN int level_nodes(const Args& a, int level) { return 1 << (a.levels - level); }

// the 16-byte slot where a shared buffer keeps its slot u (see above)
F128_FN int slot(int u) { return u ^ ((u >> 3) & 3); }

// The launch that writes the root also clears row 0 (the JAX package's
// flat array has zeros there), from block 0's first thread.
F128_FN void clear_row0(const Args& a, long long block, int thread) {
    if ((a.m >> a.levels) == 1 && block == 0 && thread == 0) {
        const uint4 zero = {0, 0, 0, 0};
        a.nodes[0] = zero;
        a.nodes[1] = zero;
    }
}

// Node p of level l of block b: its children from the input level (l = 1)
// or from `below`, the buffer of level l - 1; the node to `above` (but at
// the launch's top level) and to its row of the flat array.
F128_FN void node(const Args& a, long long b, int level, int p, const uint4* below,
                  uint4* above) {
    uint4 c[4];
    if (level == 1) {
        const uint4* pair = a.in + 4 * ((b << (a.levels - 1)) + p);
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = pair[j];
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = below[slot(4 * p + j)];
    }
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m[4 * j] = c[j].x;
        m[4 * j + 1] = c[j].y;
        m[4 * j + 2] = c[j].z;
        m[4 * j + 3] = c[j].w;
    }
    uint32_t cv[8];
    blake3::hash_block(cv, m);
    const uint4 lo = {cv[0], cv[1], cv[2], cv[3]};
    const uint4 hi = {cv[4], cv[5], cv[6], cv[7]};
    if (level < a.levels) {
        above[slot(2 * p)] = lo;
        above[slot(2 * p + 1)] = hi;
    }
    const long long row = (a.m >> level) + ((long long)b << (a.levels - level)) + p;
    a.nodes[2 * row] = lo;
    a.nodes[2 * row + 1] = hi;
}

}  // namespace merkle_tree
