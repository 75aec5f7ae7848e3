// K10 boundary_columns on the card: the kernel of boundary_columns.cuh
// (design and bound there) and its launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "boundary_columns.cuh"

namespace {

using boundary_columns::kMaxRegisters;
using boundary_columns::kThreads;

__global__ void __launch_bounds__(kThreads, 4)
boundary_columns_kernel(boundary_columns::Args a) {
    __shared__ uint4 weights[4 * kMaxRegisters];
    boundary_columns::stage_weights(a, weights, threadIdx.x);
    __syncthreads();
    const uint4* const w[4] = {weights, weights + kMaxRegisters, weights + 2 * kMaxRegisters,
                               weights + 3 * kMaxRegisters};
    const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (k < a.n) boundary_columns::column(a, w, k);
}

}  // namespace

// out[0, n) the first-step column, out[n, 2n) the last-step one; weights
// (4, regs) limbs; constants: the host's 16 words of c1i, c2i, c1f, c2f;
// xb_hi may be null
extern "C" int distaff_boundary_columns(const void* lde, long long reg_stride,
                                        long long point_stride, int regs, long long n,
                                        const void* weights, const void* xb_lo,
                                        const void* xb_hi, int log_lo,
                                        const uint32_t* constants, void* out, void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || point_stride < 1 || reg_stride < 0 ||
        log_lo < 0 || log_lo > 30)
        return (int)cudaErrorInvalidValue;
    boundary_columns::Args a{(const uint4*)lde, reg_stride, point_stride, regs, n,
                             (const uint4*)weights, (const uint4*)xb_lo, (const uint4*)xb_hi,
                             log_lo, {}, (uint4*)out};
    std::memcpy(a.c, constants, sizeof(a.c));
    const long long blocks = boundary_columns::blocks(a);
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    boundary_columns_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
