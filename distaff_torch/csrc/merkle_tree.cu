// K13 merkle_tree on the card: the kernel of merkle_tree.cuh (design and
// bound there) and one launch of it.

#include <cuda_runtime.h>
#include <cstdint>

#include "merkle_tree.cuh"

namespace {

using merkle_tree::kBufferA;
using merkle_tree::kBufferB;
using merkle_tree::kThreads;

// Block b hashes its subtree's levels bottom up, one barrier a level; a
// thread takes nodes p, p + blockDim.x, ... of each level.
__global__ void __launch_bounds__(kThreads)
    merkle_tree_kernel(const __grid_constant__ merkle_tree::Args a) {
    __shared__ uint4 odd[2 * kBufferA];
    __shared__ uint4 even[2 * kBufferB];
    const long long b = blockIdx.x;
    merkle_tree::clear_row0(a, b, threadIdx.x);
    for (int level = 1; level <= a.levels; ++level) {
        const uint4* below = (level & 1) ? even : odd;
        uint4* above = (level & 1) ? odd : even;
        for (int p = threadIdx.x; p < merkle_tree::level_nodes(a, level); p += blockDim.x)
            merkle_tree::node(a, b, level, p, below, above);
        if (level < a.levels) __syncthreads();
    }
}

}  // namespace

// One launch: `levels` levels above the m nodes at `in` ((m, 8) words: the
// leaves, or rows [m, 2m) of `nodes`), written into the flat (n, 8) array
// `nodes`; m a power of two, 1 <= levels <= 11, 2^levels <= m.
extern "C" int distaff_merkle_tree(const void* in, void* nodes, long long m, int levels,
                                   void* stream) {
    if (m < 2 || (m & (m - 1)) || levels < 1 || levels > merkle_tree::kMaxLevels ||
        (m >> levels) < 1)
        return (int)cudaErrorInvalidValue;
    const merkle_tree::Args a{(const uint4*)in, (uint4*)nodes, m, levels};
    const long long blocks = merkle_tree::blocks(a);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    merkle_tree_kernel<<<(unsigned)blocks, merkle_tree::block_threads(a), 0,
                         (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
