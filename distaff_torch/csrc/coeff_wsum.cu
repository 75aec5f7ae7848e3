// K15 coeff_wsum on the card: the kernel of coeff_wsum.cuh (design and
// bound there) and one launch of it.

#include <cuda_runtime.h>
#include <cstdint>

#include "coeff_wsum.cuh"

namespace {

using coeff_wsum::kMaxRegisters;
using coeff_wsum::kThreads;

__global__ void __launch_bounds__(kThreads)
    coeff_wsum_kernel(const __grid_constant__ coeff_wsum::Args a) {
    __shared__ uint4 weights[2 * kMaxRegisters];
    for (int r = threadIdx.x; r < a.regs; r += kThreads) {
        weights[r] = a.w1[r];
        weights[kMaxRegisters + r] = a.w2[r];
    }
    __syncthreads();
    coeff_wsum::points_of(a, blockIdx.x, threadIdx.x, weights, weights + kMaxRegisters);
}

}  // namespace

// out (2, n) <- the sums of the regs rows of polys (reg_stride apart, in
// 16-byte units) weighted by w1 and w2 ((regs, 4) each)
extern "C" int distaff_coeff_wsum(const void* polys, long long reg_stride, int regs,
                                  long long n, const void* w1, const void* w2, void* out,
                                  void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || (regs > 1 && reg_stride < n))
        return (int)cudaErrorInvalidValue;
    const coeff_wsum::Args a{(const uint4*)polys, reg_stride, regs, n, (const uint4*)w1,
                             (const uint4*)w2, (uint4*)out};
    const long long blocks = coeff_wsum::blocks(a);
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    coeff_wsum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
