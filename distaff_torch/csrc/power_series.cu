// K12 power_series on the card: the kernel of power_series.cuh (design and
// bound there) and its launch over a list of tables.

#include <cuda_runtime.h>
#include <cstdint>

#include "power_series.cuh"

namespace {

using power_series::kLanes;
using power_series::kThreads;
using power_series::u128;

__device__ __forceinline__ u128 shfl_xor(u128 v, int mask) {
    const unsigned long long lo = __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)v, mask);
    const unsigned long long hi =
        __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)(v >> 64), mask);
    return ((u128)hi << 64) | lo;
}

__global__ void __launch_bounds__(kThreads)
    power_series_kernel(const __grid_constant__ power_series::Args a) {
    __shared__ uint4 low[kLanes], high[kLanes];
    const power_series::Table& t = a.table[power_series::table_of(a, blockIdx.x)];
    const long long b = blockIdx.x - t.first_block;
    const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    if (warp == 0) {
        low[lane] = f128::to_limbs(power_series::power(a, t, 0, lane));
    } else if (warp == 1) {
        u128 p = power_series::prefix_factor(a, t, b, lane);
        const u128 h = power_series::power(a, t, 5, lane);
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) p = f128::mul(p, shfl_xor(p, d));
        high[lane] = f128::to_limbs(f128::mul(p, h));
    }
    __syncthreads();
    power_series::store(a, t, b, low, high, threadIdx.x);
}

}  // namespace

// Tables k < tables in one launch: out[out_offsets[k] + i] = c x^i for i <
// rows[k], from factors[factor_offsets[k] ...] = c, then x^(2^j) for j <
// counts[k] - 1, with 2^(counts[k] - 1) >= rows[k].
extern "C" int distaff_power_series(const void* factors, void* out, int tables,
                                    const long long* factor_offsets, const int* counts,
                                    const long long* rows, const long long* out_offsets,
                                    void* stream) {
    power_series::Args a{(const uint4*)factors, (uint4*)out, 0, {}};
    const long long blocks =
        power_series::set_tables(a, tables, factor_offsets, counts, rows, out_offsets);
    if (blocks < 1 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    power_series_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
