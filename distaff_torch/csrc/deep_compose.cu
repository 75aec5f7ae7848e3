// K7 deep_compose on the card: the kernel of deep_compose.cuh (design and
// bound there) on wsum_product.cuh's ring and tensor-core product, and its
// launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "per_device.cuh"
#include "deep_compose.cuh"

#ifndef DEEP_MIN_BLOCKS
#define DEEP_MIN_BLOCKS 2
#endif

namespace {

using namespace deep_compose;

// The block's tiles through wsum::run: each tile's sums kept (its reads
// for the pair's composition issued at the pair's first tile), then, with
// the ring's copies in flight, each pair of tiles composed (forward), each
// round inverted and walked back.
__global__ void __launch_bounds__(kThreads, DEEP_MIN_BLOCKS)
deep_compose_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(128) uint8_t shared[];
    const wsum::Ring l = wsum::ring(a.lde.regs, kSumsBytes);
    u128* const sums = (u128*)(shared + wsum::extra_at(l));
    const int tid = threadIdx.x;
    u128 q = 1;
    long long i = -1;                    // the thread's point of its current pair
    Inputs in;
    wsum::run(
        a.lde, l, shared,
        [&](long long k, long long mine, const uint32_t* digits) {
            keep_sum(sums, k, digits, tid);
            if ((k & 1) == 0) {
                i = pair_point(a, blockIdx.x, gridDim.x, mine, k >> 1, tid);
                if (i >= 0) in = fetch(a, i);
            }
        },
        [&](long long k, long long mine) {
            if (!pair_done(k, mine)) return;
            if (i >= 0) forward(a, sums, i, tid, in, q);
            if (!round_done(k, mine)) return;
            __syncthreads();             // the tree takes the sums' bytes
            walk_back(a, blockIdx.x, gridDim.x, mine, k >> 1, tid,
                      inv_block::inverse_of_total<kThreads>(sums, q));
            q = 1;
        });
}

}  // namespace

// out[i] for i < n; scalars: the host's 32 words of z, zg, s1, s2, c(z), k1,
// k2, kc (four little-endian limbs each); x_hi and i_hi may be null.  As
// many blocks as fit the card at once, at most one a tile.
extern "C" int distaff_deep_compose(const void* lde, long long lde_stride, int regs,
                                    long long n, const void* c_lde, const void* w1,
                                    const void* w2, const void* x_lo, const void* x_hi,
                                    const void* i_lo, const void* i_hi, int log_lo,
                                    const uint32_t* scalars, void* out, long long first,
                                    void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || lde_stride < n || log_lo < 0 ||
        log_lo > 30 || first < 0)
        return (int)cudaErrorInvalidValue;
    Args a{{(const uint4*)lde, lde_stride, regs, n, (const uint4*)w1, (const uint4*)w2},
           (const uint4*)c_lde, (const uint4*)x_lo, (const uint4*)x_hi, (const uint4*)i_lo,
           (const uint4*)i_hi, log_lo, {}, (uint4*)out, first};
    std::memcpy(&a.s, scalars, sizeof(a.s));
    const long long tiles = wsum::tiles(a.lde);
    if (tiles == 0) return (int)cudaSuccess;
    static std::atomic<int> limit_set[per_device::kMaxDevices];
    const cudaError_t configured =
        per_device::shared_limit(limit_set, deep_compose_kernel, wsum::kSharedBytes);
    if (configured != cudaSuccess) return (int)configured;
    const int bytes = wsum::shared_bytes(wsum::ring(regs, kSumsBytes));
    cudaError_t err;
    const long long blocks = wsum::grid_of(deep_compose_kernel, tiles, bytes, &err);
    if (blocks == 0) return (int)err;
    deep_compose_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
