// K13 merkle_tree on the card: the kernel of merkle_tree.cuh (design and
// bound there) and its one launch a tree.

#include <cuda_runtime.h>
#include <cstdint>

#include "merkle_tree.cuh"

namespace {

using merkle_tree::kThreads;

// Block b hashes subtree b of stage 0, one barrier a level; a thread takes
// nodes p, p + blockDim.x, ... of each level.  Then the thread that wrote
// the root (thread 0) takes its group's ticket, and the block goes on with
// the group's subtree of the next stage where the ticket was the last.
__global__ void __launch_bounds__(kThreads)
    merkle_tree_kernel(const __grid_constant__ merkle_tree::Args a) {
    extern __shared__ uint4 buffers[];
    uint4* odd = buffers;
    uint4* even = buffers + 2 * merkle_tree::odd_nodes(merkle_tree::largest_stage(a));
    long long g = blockIdx.x;
    merkle_tree::clear_row0(a, g, threadIdx.x);
    for (int s = 0;; ++s) {
        const int levels = a.levels[s];
        for (int level = 1; level <= levels; ++level) {
            const uint4* below = (level & 1) ? even : odd;
            uint4* above = (level & 1) ? odd : even;
            for (int p = threadIdx.x; p < merkle_tree::level_nodes(levels, level);
                 p += blockDim.x)
                merkle_tree::node(a, s, g, level, p, below, above);
            if (level < levels) __syncthreads();
        }
        if (s + 1 == a.stages) return;
        if (!__syncthreads_or(threadIdx.x == 0 && merkle_tree::arrive(a, s, g))) return;
        g >>= a.levels[s + 1];
    }
}

}  // namespace

// The flat (n, 8) node array `nodes` of the tree over the (n, 8) leaf
// digests `leaves` in one launch, under the plan levels[0 .. stages) (they
// sum to log2 n, each in [1, 11]); `counters` holds at least the plan's
// groups (the subtrees of every stage above the first), all 0, and is left
// so.
extern "C" int distaff_merkle_tree(const void* leaves, void* nodes, void* counters, long long n,
                                   int stages, const int* levels, void* stream) {
    merkle_tree::Args a{(const uint4*)leaves, (uint4*)nodes, (int*)counters, n, 0, {}, {}, {}};
    if (!merkle_tree::set_plan(a, stages, levels) || (stages > 1 && counters == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long blocks = merkle_tree::blocks(a);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const int largest = merkle_tree::largest_stage(a);
    const size_t shared =
        2 * sizeof(uint4) * (merkle_tree::odd_nodes(largest) + merkle_tree::even_nodes(largest));
    merkle_tree_kernel<<<(unsigned)blocks, merkle_tree::block_threads(a), shared,
                         (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
