// K7 deep_compose on the card: the kernel of deep_compose.cuh (design and
// bound there) and its launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "deep_compose.cuh"

#ifndef DEEP_MIN_BLOCKS
#define DEEP_MIN_BLOCKS 4
#endif

namespace {

using deep_compose::kMaxRegisters;
using deep_compose::kThreads;

__global__ void __launch_bounds__(kThreads, DEEP_MIN_BLOCKS)
deep_compose_kernel(deep_compose::Args a) {
    __shared__ uint4 weights[2 * kMaxRegisters];
    __shared__ f128::u128 tree[2 * kThreads];
    for (int r = threadIdx.x; r < a.regs; r += kThreads) {
        weights[r] = a.w1[r];
        weights[kMaxRegisters + r] = a.w2[r];
    }
    __syncthreads();
    deep_compose::Lane lane;
    const f128::u128 run = deep_compose::numerators(a, weights, weights + kMaxRegisters,
                                                    blockIdx.x, threadIdx.x, lane);
    const f128::u128 inv_run = inv_block::inverse_of_total<kThreads>(tree, run);
    deep_compose::store(a, blockIdx.x, threadIdx.x, lane, inv_run);
}

}  // namespace

// out[i] for i < n; scalars: the host's 32 words of z, zg, s1, s2, c(z), k1,
// k2, kc (four little-endian limbs each); x_hi and i_hi may be null
extern "C" int distaff_deep_compose(const void* lde, long long lde_stride, int regs,
                                    long long n, const void* c_lde, const void* w1,
                                    const void* w2, const void* x_lo, const void* x_hi,
                                    const void* i_lo, const void* i_hi, int log_lo,
                                    const uint32_t* scalars, void* out, void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || lde_stride < n || log_lo < 0 ||
        log_lo > 30)
        return (int)cudaErrorInvalidValue;
    deep_compose::Args a{(const uint4*)lde, lde_stride, regs, n, (const uint4*)c_lde,
                         (const uint4*)w1, (const uint4*)w2, (const uint4*)x_lo,
                         (const uint4*)x_hi, (const uint4*)i_lo, (const uint4*)i_hi, log_lo,
                         {}, (uint4*)out};
    std::memcpy(&a.s, scalars, sizeof(a.s));
    const long long blocks = deep_compose::blocks(a);
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    deep_compose_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
