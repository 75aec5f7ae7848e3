// K9 fri_fold on the card: the kernel of fri_fold.cuh (design and bound
// there) and its launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "per_device.cuh"
#include "fri_fold.cuh"

namespace {

using fri_fold::kThreads;

// Thread g: its kRows rows, then with digests the leaf's first thread
// gathers the leaf row from the other 4 / kRows - 1 lanes and hashes it.
// No register cap: ptxas' count, and the block sizes, come from air_probe
// k9's measurements (PERF.md).
template <int kRows>
__global__ void __launch_bounds__(kThreads)
    fri_fold_kernel(const __grid_constant__ fri_fold::Args a) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = g < fri_fold::threads(a);
    uint32_t own[4 * kRows];
    if (active) fri_fold::fold<kRows>(a, g, own);
    if (!a.digests) return;                  // the same for every thread
    constexpr int kLanes = fri_fold::kLeafRows / kRows;
    uint32_t words[4 * fri_fold::kLeafRows];
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
#pragma unroll
        for (int w = 0; w < 4 * kRows; ++w)
            words[4 * kRows * l + w] = l ? __shfl_down_sync(0xFFFFFFFFu, own[w], l) : own[w];
    if (active && g % kLanes == 0) fri_fold::hash_leaf(a, g / kLanes, words);
}

}  // namespace

// out[r] for r < q from the column of 4q points, `rows` rows a thread (4,
// or 1: then four lanes a leaf, or q lanes where q < 4); constants: the
// host's 32 words of special_x, zeta^-j (j = 1..3) and I zeta^-j (j =
// 0..3); hi may be null; digests (q/4, 8) words or null (q must then be
// at least 4)
extern "C" int distaff_fri_fold(const void* column, long long q, int rows, const void* lo,
                                const void* hi, int log_lo, long long stride,
                                const uint32_t* constants, void* out, void* digests,
                                long long start, long long layer_q, void* stream) {
    if (q < 1 || stride < 1 || log_lo < 0 || log_lo > 30 || (rows != 1 && rows != 4) ||
        (q % 4 && (rows != 1 || digests)) || start < 0 || (layer_q && start + q > layer_q) ||
        ((start || layer_q) && digests))
        return (int)cudaErrorInvalidValue;
    fri_fold::Args a{(const uint4*)column, q, rows,
                     (int)(q % 4 ? q : fri_fold::kLeafRows / rows), (const uint4*)lo,
                     (const uint4*)hi, log_lo, stride, {}, (uint4*)out, (uint32_t*)digests,
                     start, layer_q};
    std::memcpy(&a.k, constants, sizeof(a.k));
    static std::atomic<int> sm_counts[per_device::kMaxDevices];
    int sms = 0;
    const cudaError_t e = per_device::sm_count(sm_counts, &sms);
    if (e != cudaSuccess) return (int)e;
    const int block = fri_fold::block_threads(a, sms);
    const long long blocks = fri_fold::blocks(a, block);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    if (rows == 4)
        fri_fold_kernel<4><<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(a);
    else
        fri_fold_kernel<1><<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
