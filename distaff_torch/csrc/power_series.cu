// K12 power_series on the card: the kernel of power_series.cuh (design and
// bound there) and its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "power_series.cuh"

namespace {

using power_series::kThreads;
using power_series::kTile;

__global__ void __launch_bounds__(kThreads) power_series_kernel(power_series::Args a) {
    __shared__ uint4 table[kTile];
    __shared__ uint4 prefix;
    power_series::start(a, table, &prefix, blockIdx.x, threadIdx.x);
    __syncthreads();
    const int steps = power_series::steps(a);
    for (int k = 0; k < steps; ++k) {
        power_series::double_step(a, table, k, threadIdx.x);
        __syncthreads();
    }
    power_series::store(a, table, &prefix, blockIdx.x, threadIdx.x);
}

}  // namespace

// out[0, n) = c x^i; factors: c, then x^(2^k) for k < count - 1, with
// 2^(count - 1) >= n
extern "C" int distaff_power_series(const void* factors, int count, long long n, void* out,
                                    void* stream) {
    if (n < 1 || count < 1 || count > power_series::kMaxFactors ||
        (count - 1 < 63 && n > (1LL << (count - 1))))
        return (int)cudaErrorInvalidValue;
    const power_series::Args a{(const uint4*)factors, count, n, (uint4*)out};
    const long long blocks = power_series::blocks(a);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    power_series_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
