// K16 leaf256 on the card: the kernel of leaf256.cuh (design and bound
// there) on wsum_product.cuh's ldmatrix and u8 mma, and one launch of it.

#include <cuda_runtime.h>
#include <cstdint>

#include "per_device.cuh"
#include "leaf256.cuh"
#include "wsum_product.cuh"

namespace {

using namespace leaf256;

// cp.async of one matrix's entries (kMatrixBytes) into shared memory, one commit group
__device__ __forceinline__ void copy_matrix(const uint4* src, uint8_t* dst) {
    for (int u = threadIdx.x; u < kMatrixBytes / 16; u += kThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(wsum::shared_address(dst + 16 * u)), "l"(src + u)
                     : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One matrix applied to a warp's 32 vectors, rows i (both m16 tiles):
// the digits into the warp's area, and lane c's element of vector c back
__device__ __forceinline__ uint4 apply(const uint32_t* matrix, int i, const Lane& ln,
                                       const uint32_t (&b)[kKSteps][4][2], uint32_t* digits,
                                       int lane) {
    int acc[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[2][4];
        a_fragment(matrix, i, kk, 0, ln, a[0]);
        a_fragment(matrix, i, kk, 1, ln, a[1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            wsum::mma_u8(acc[0][nt], a[0], b[kk][nt][0], b[kk][nt][1]);
            wsum::mma_u8(acc[1][nt], a[1], b[kk][nt][0], b[kk][nt][1]);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i2 = 0; i2 < 4; i2 += 2) {
                const int at = digit_word(h, nt, lane, i2);
                if (at >= 0)
                    *(uint2*)(digits + at) = make_uint2((uint32_t)acc[h][nt][i2],
                                                        (uint32_t)acc[h][nt][i2 + 1]);
            }
    __syncwarp();
    const uint4 v = reduce(digits, lane);
    __syncwarp();
    return v;
}

__global__ void __launch_bounds__(kThreads, 1)
leaf256_kernel(const uint4* __restrict__ x, const uint4* __restrict__ entries,
               uint4* __restrict__ out, long long leaves) {
    extern __shared__ __align__(16) uint8_t shared[];
    const uint32_t* const mat_a = (const uint32_t*)(shared + kStageAAt);
    uint4* const mid = (uint4*)(shared + kMidAt);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint32_t* const digits = (uint32_t*)(shared + kDigitsAt) + warp * kDigitWords;
    const long long leaf0 = (long long)blockIdx.x * kTile;
    const long long rest = leaves - leaf0;
    const int valid = rest < kTile ? (int)rest : kTile;
    const Lane ln = lane_of(lane);

    copy_matrix(entries, shared + kStageAAt);
    copy_matrix(entries + kMatrixBytes / 16, shared + kStageBAt);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");     // W is in; C[0] may be in flight
    __syncthreads();

    // stage A: A[b, i1, k2] of the warp's two groups into mid
    const uint32_t* const words = (const uint32_t*)x;
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
        const int group = warp + kWarps * s;
        uint32_t b[kKSteps][4][2];
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    b[kk][nt][half] = group_leaf(group, 8 * nt + (lane >> 2)) < valid
                        ? __ldg(words + input_word(leaf0, group, nt, kk, half, lane)) : 0u;
#pragma unroll 1
        for (int k2 = 0; k2 < kSide; ++k2)
            mid[mid_unit(k2, group_leaf(group, lane), group_column(lane))] =
                apply(mat_a, k2, ln, b, digits, lane);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // stage B: X[b, 16 k1 + k2] for each k2 into slab k2 of mid, C[k2 + 1] copied meanwhile
#pragma unroll 1
    for (int k2 = 0; k2 < kSide; ++k2) {
        if (k2 + 1 < kSide)
            copy_matrix(entries + (2 + k2) * (kMatrixBytes / 16),
                        shared + kStageBAt + ((k2 + 1) & 1) * kMatrixBytes);
        uint32_t b[kKSteps][4][2];
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                uint32_t r[4];
                wsum::ldmatrix_x4(r, wsum::shared_address(mid + stage_b_row(k2, np, kk, lane)));
                b[kk][2 * np][0] = r[0];
                b[kk][2 * np][1] = r[1];
                b[kk][2 * np + 1][0] = r[2];
                b[kk][2 * np + 1][1] = r[3];
            }
        __syncthreads();           // every warp holds slab k2: its units take the outputs
        const uint32_t* const mat_b =
            (const uint32_t*)(shared + kStageBAt + (k2 & 1) * kMatrixBytes);
#pragma unroll 1
        for (int r = 0; r < 2; ++r) {
            const int k1 = 2 * warp + r;
            mid[mid_unit(k2, lane, k1)] = apply(mat_b, k1, ln, b, digits, lane);
        }
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
    }

    for (int e = threadIdx.x; e < valid * kPoints; e += kThreads)
        out[leaf0 * kPoints + e] = mid[out_unit(e)];
}

}  // namespace

// out (leaves, 256) <- the natural-order 256-point NTT of each leaf of x,
// at the root whose stage matrices `entries` holds (ops/mxu_ntt.
// kernel_entries: (17, 256, 5) words).  A block a tile of 32 leaves.
extern "C" int distaff_leaf256(const void* x, const void* entries, void* out, long long leaves,
                               void* stream) {
    if (leaves < 0 || (leaves + kTile - 1) / kTile > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    if (leaves == 0) return (int)cudaSuccess;
    static std::atomic<int> limit_set[per_device::kMaxDevices];
    const cudaError_t configured =
        per_device::shared_limit(limit_set, leaf256_kernel, kSharedBytes);
    if (configured != cudaSuccess) return (int)configured;
    leaf256_kernel<<<(unsigned)((leaves + kTile - 1) / kTile), kThreads, kSharedBytes,
                     (cudaStream_t)stream>>>((const uint4*)x, (const uint4*)entries,
                                             (uint4*)out, leaves);
    return (int)cudaGetLastError();
}
