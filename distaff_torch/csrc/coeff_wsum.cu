// K15 coeff_wsum on the card: the kernel of coeff_wsum.cuh (design and
// bound there) on wsum_product.cuh's ring and tensor-core product, and one
// launch of it.

#include <cuda_runtime.h>
#include <cstdint>

#include "per_device.cuh"
#include "coeff_wsum.cuh"

namespace {

using namespace coeff_wsum;

__global__ void __launch_bounds__(kThreads, 2)
coeff_wsum_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(128) uint8_t shared[];
    const wsum::Ring l = wsum::ring(a.polys.regs, 0);
    wsum::run(
        a.polys, l, shared,
        [&](long long k, long long, const uint32_t* digits) {
            store(a, blockIdx.x + k * gridDim.x, digits, threadIdx.x);
        },
        [](long long, long long) {});
}

}  // namespace

// out (2, n) <- the sums of the regs rows of polys (reg_stride apart, in
// 16-byte units) weighted by w1 and w2 ((regs, 4) each).  As many blocks as
// fit the card at once, at most one a tile.
extern "C" int distaff_coeff_wsum(const void* polys, long long reg_stride, int regs,
                                  long long n, const void* w1, const void* w2, void* out,
                                  void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || (regs > 1 && reg_stride < n))
        return (int)cudaErrorInvalidValue;
    const Args a{{(const uint4*)polys, reg_stride, regs, n, (const uint4*)w1, (const uint4*)w2},
                 (uint4*)out};
    const long long tiles = wsum::tiles(a.polys);
    if (tiles == 0) return (int)cudaSuccess;
    static std::atomic<int> limit_set[per_device::kMaxDevices];
    const cudaError_t configured =
        per_device::shared_limit(limit_set, coeff_wsum_kernel, wsum::kSharedBytes);
    if (configured != cudaSuccess) return (int)configured;
    const int bytes = wsum::shared_bytes(wsum::ring(regs, 0));
    cudaError_t err;
    const long long blocks = wsum::grid_of(coeff_wsum_kernel, tiles, bytes, &err);
    if (blocks == 0) return (int)err;
    coeff_wsum_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
