// K11 syn_div on the card: the single-pass kernel of syn_div.cuh (design
// and bound there), its warp shuffles and look-back, and the call that
// zeroes its descriptors and launches it with its shared memory (55.3 KB
// at the tile of 1024: four blocks an SM).

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "per_device.cuh"
#include "syn_div.cuh"

namespace {

using namespace syn_div;

__device__ __forceinline__ u128 shfl_down(u128 v, int off) {
    uint4 l = f128::to_limbs(v);
    l.x = __shfl_down_sync(0xFFFFFFFFu, l.x, off);
    l.y = __shfl_down_sync(0xFFFFFFFFu, l.y, off);
    l.z = __shfl_down_sync(0xFFFFFFFFu, l.z, off);
    l.w = __shfl_down_sync(0xFFFFFFFFu, l.w, off);
    return f128::from_limbs(l);
}

// inclusive suffix sums of both values over the warp's first `count` lanes
__device__ __forceinline__ void warp_suffix(u128 (&v)[2], int lane, int count) {
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
        if (off >= count) break;
#pragma unroll
        for (int x = 0; x < 2; ++x)
            v[x] = suffix_step(v[x], shfl_down(v[x], off), lane, off, count);
    }
}

// the sums of the lanes after this one (0 from the last of `count`)
__device__ __forceinline__ void warp_after(const u128 (&v)[2], int lane, int count,
                                           u128 (&after)[2]) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        const u128 up = shfl_down(v[x], 1);
        after[x] = lane + 1 < count ? up : 0;
    }
}

// Warp 0's look-back: lane l peeks at tile base + l, for windows of 32
// tiles from the one after `tile`, until a window holds an inclusive tile;
// lane 0 ends with the sums of every tile after `tile` (aggregates up to
// the first inclusive tile, and its inclusive sums).
__device__ __forceinline__ void look_back(const Args& g, long long tile, int lane,
                                          u128 (&carry)[2]) {
    carry[0] = carry[1] = 0;
    const long long nt = tiles(g);
    for (long long base = tile + 1; base < nt; base += kLanes) {
        const long long p = base + lane;
        u128 v[2] = {0, 0};
        const uint32_t st = p < nt ? peek(g, p, v) : kEmpty;
        const unsigned inclusive = __ballot_sync(0xFFFFFFFFu, st == kInclusive);
        if (inclusive && lane > __ffs(inclusive) - 1) v[0] = v[1] = 0;
        warp_suffix(v, lane, kLanes);
        carry[0] = f128::add(carry[0], v[0]);
        carry[1] = f128::add(carry[1], v[1]);
        if (inclusive) break;
    }
}

__global__ void __launch_bounds__(kThreads) syn_div_kernel(const __grid_constant__ Args g) {
    extern __shared__ __align__(16) uint8_t shared[];
    Shared& s = *reinterpret_cast<Shared*>(shared);
    const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
    if (tid == 0) s.tile = tiles(g) - 1 - (long long)atomicAdd(ticket(g), 1u);
    __syncthreads();
    const long long tile = s.tile;
    load(g, s, tile, tid);
    __syncthreads();
    // the thread's sums, the warp's scan of them, then the block's
    u128 sum[2], after[2];
    thread_sums(g, s, tile, tid, sum);
    warp_suffix(sum, lane, kLanes);
    warp_after(sum, lane, kLanes, after);
    if (lane == 0) store_warp_sums(s, sum, warp);
    __syncthreads();
    u128 total[2];
    if (warp == 0) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
            total[x] = lane < kWarps ? f128::from_limbs(s.warp_sums[x][lane]) : 0;
        u128 warps_after[2];
        warp_suffix(total, lane, kWarps);
        warp_after(total, lane, kWarps, warps_after);
        if (lane < kWarps) {
            s.warp_sums[0][lane] = f128::to_limbs(warps_after[0]);
            s.warp_sums[1][lane] = f128::to_limbs(warps_after[1]);
        }
        if (lane == 0) publish_aggregate(g, tile, total);
    }
    // R over the tile, published before the look-back so that the tiles d
    // behind wait for no look-back (air_probe k11 measured R before the
    // sums slower: it holds back the aggregates): its stride chain inside
    // the tile where d < kTile, from the R of the tiles after it
    if (tid == 0) wait_r(g, tile);
    __syncthreads();
    for (long long off = g.d; off < kTile; off *= 2) {
        u128 up[kPerThread];
        chain_read(s, (int)off, tid, up);
        __syncthreads();
        chain_add(s, tid, up);
        __syncthreads();
    }
    store_r(g, s, tile, tid);
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        store_release(r_ready(g, tile), 1);
    }
    if (warp == 0) {
        u128 carry[2];
        look_back(g, tile, lane, carry);
        if (lane == 0) publish_inclusive(g, s, tile, total, carry);
    }
    __syncthreads();
    after[0] = f128::add(after[0], f128::from_limbs(s.warp_sums[0][warp]));
    after[1] = f128::add(after[1], f128::from_limbs(s.warp_sums[1][warp]));
    finish(g, s, tile, tid, after);
    __syncthreads();
    store_out(g, s, tile, tid);
}

}  // namespace

// out[0, n) from the rows a, f, t of polys (row r at r row_stride
// elements); the power tables of b and of 1/b (his may be null); b and
// neg_e: the host's 4 words of b and -e; scratch: flags (2 tiles + 1
// words, zeroed here), sums (tiles x 4 elements) and r (n elements)
extern "C" int distaff_syn_div(const void* polys, long long row_stride, long long n, long long d,
                               const void* b_lo, const void* b_hi, const void* binv_lo,
                               const void* binv_hi, int log_lo, const uint32_t* b,
                               const uint32_t* neg_e, void* flags, void* sums, void* r,
                               void* out, void* stream) {
    if (n < 1 || d < 1 || d > n || row_stride < n || log_lo < 0 || log_lo > 30)
        return (int)cudaErrorInvalidValue;
    const uint4* p = (const uint4*)polys;
    Args g{p, p + row_stride, p + 2 * row_stride, n, d,
           (const uint4*)b_lo, (const uint4*)b_hi, (const uint4*)binv_lo,
           (const uint4*)binv_hi, log_lo, {}, {}, (uint32_t*)flags, (uint4*)sums, (uint4*)r,
           (uint4*)out};
    std::memcpy(&g.b, b, sizeof(g.b));
    std::memcpy(&g.neg_e, neg_e, sizeof(g.neg_e));
    const long long nt = tiles(g);
    if (nt > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    static std::atomic<int> limit_set[per_device::kMaxDevices];
    const cudaError_t configured =
        per_device::shared_limit(limit_set, syn_div_kernel, (int)sizeof(Shared));
    if (configured != cudaSuccess) return (int)configured;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(flags, 0, (2 * nt + 1) * sizeof(uint32_t), s);
    if (e != cudaSuccess) return (int)e;
    syn_div_kernel<<<(unsigned)nt, kThreads, sizeof(Shared), s>>>(g);
    return (int)cudaGetLastError();
}
