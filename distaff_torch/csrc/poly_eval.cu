// K8 poly_eval on the card: the kernel of poly_eval.cuh (design and bound
// there) and its launch, one a call of up to kMaxPoints points.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "poly_eval.cuh"

namespace {

using namespace poly_eval;

__device__ __forceinline__ void shuffle_down(const Args& a, const u128 (&h)[kMaxPoints],
                                             u128 (&v)[kMaxPoints], int delta) {
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p) {
        v[p] = 0;
        if (p < a.points) {
            uint4 l = f128::to_limbs(h[p]);
            l.x = __shfl_down_sync(0xFFFFFFFFu, l.x, delta);
            l.y = __shfl_down_sync(0xFFFFFFFFu, l.y, delta);
            l.z = __shfl_down_sync(0xFFFFFFFFu, l.z, delta);
            l.w = __shfl_down_sync(0xFFFFFFFFu, l.w, delta);
            v[p] = f128::from_limbs(l);
        }
    }
}

// lane 0's values into the warp's column of warp_values
__device__ __forceinline__ void store_warp(const Args& a, const u128 (&h)[kMaxPoints],
                                           uint4 (&warp_values)[kMaxPoints][kWarps], int warp) {
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p)
        if (p < a.points) warp_values[p][warp] = f128::to_limbs(h[p]);
}

template <int kLog>
__global__ void __launch_bounds__(kThreads) poly_eval_kernel(const __grid_constant__ Args a) {
    __shared__ uint4 warp_values[kMaxPoints][kWarps];
    __shared__ int last;
    const long long block = blockIdx.x, row = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    u128 h[kMaxPoints], v[kMaxPoints];
    horner<kLog>(a, row, block, tid, h);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        shuffle_down(a, h, v, 1 << k);
        if ((lane & ((2 << k) - 1)) == 0) combine(a, k, h, v);
    }
    if (lane == 0) store_warp(a, h, warp_values, warp);
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int p = 0; p < kMaxPoints; ++p)
            h[p] = p < a.points && lane < kWarps ? f128::from_limbs(warp_values[p][lane]) : 0;
#pragma unroll
        for (int k = 0; k < kLogWarps; ++k) {
            shuffle_down(a, h, v, 1 << k);
            if ((lane & ((2 << k) - 1)) == 0) combine(a, 5 + k, h, v);
        }
        if (lane == 0) {
            scale(a, block, h);
            store(a, row, block, h);
            if (a.blocks > 1) {
                __threadfence();
                last = atomicAdd(a.tickets + row, 1u) == (unsigned)a.blocks - 1;
            }
        }
    }
    if (a.blocks == 1) return;
    __syncthreads();
    if (!last) return;
    // the row's last block: every other block's partial is written (warp
    // 0's reads of warp_values ended before the barrier above)
    __threadfence();
    gather(a, row, tid, h);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        shuffle_down(a, h, v, 1 << k);
        if ((lane & ((2 << k) - 1)) == 0) add_into(a, h, v);
    }
    if (lane == 0) store_warp(a, h, warp_values, warp);
    __syncthreads();
    if (tid < a.points) {
        u128 sum = 0;
        for (int w = 0; w < kWarps; ++w)
            sum = f128::add(sum, f128::from_limbs(warp_values[tid][w]));
        a.out[row * a.points + tid] = f128::to_limbs(sum);
    }
    if (tid == 0) a.tickets[row] = 0;
}

}  // namespace

// rows of `len` coefficients at `points` points into out (rows, points);
// partial (rows, points, ceil(len / 2^(kLogThreads + kShortLog))) scratch
// (unused when a row is one span), tickets (rows) zero; squarings: the
// host's points x kSquarings x 4 words of x_p^(2^k)
extern "C" int distaff_poly_eval(const void* in, void* out, void* partial, void* tickets,
                                 long long len, long long rows, int points,
                                 const uint32_t* squarings, void* stream) {
    if (len < 1 || len > (1LL << (kSquarings - 1)) || rows < 1 || rows > 65535 ||
        points < 1 || points > kMaxPoints)
        return (int)cudaErrorInvalidValue;
    const int log = log_per_thread(rows, len);
    const int log_span = kLogThreads + log;
    Args a{(const uint4*)in, (uint4*)out, (uint4*)partial, (uint32_t*)tickets, len, log_span,
           (int)((len + (1LL << log_span) - 1) >> log_span), points, {}};
    std::memcpy(a.sq, squarings, sizeof(uint4) * kSquarings * points);
    const dim3 grid((unsigned)a.blocks, (unsigned)rows);
    if (log == kLongLog)
        poly_eval_kernel<kLongLog><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    else
        poly_eval_kernel<kShortLog><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
