// K10 boundary_columns on the card: the kernel of boundary_columns.cuh
// (design and bound there) on wsum_product.cuh's tensor-core product, and
// its launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "per_device.cuh"
#include "boundary_columns.cuh"

namespace {

using namespace boundary_columns;

using wsum::shared_address;

// A block runs the stages (tile, group) of its tiles blockIdx.x +
// t gridDim.x.  Before each stage's product it issues the copies of the
// stage stages - 1 places on (one group, empty past the last stage) into
// the slot that the stage before consumed; a tile's digits go into the slot
// of its last stage once every warp's product is done.
__global__ void __launch_bounds__(kThreads)
boundary_columns_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) uint8_t shared[];
    const Layout l = layout(a.regs);
    uint8_t* const a_s = shared;
    uint8_t* const b_s = shared + l.a_bytes;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long last = tiles(a);
    Cursor in{blockIdx.x, 0, 0}, at = in;
    auto issue = [&]() {
        if (in.tile < last) {
            const int count = copies(a, l, in.g);
            uint8_t* const stage = b_s + in.slot * l.slot_bytes;
            for (int i = tid; i < count; i += kThreads) {
                int dst;
                const uint4* src = stage_copy(a, l, in.tile, in.g, i, dst);
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                             :: "r"(shared_address(stage + dst)), "l"(src)
                             : "memory");
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        advance(in, l, gridDim.x);
    };

    if (l.groups == 1) build_a(a, l, 0, a_s, tid);
    for (int i = 0; i < l.stages - 1; ++i) issue();
    int acc[2][4][4] = {};
    for (; at.tile < last; advance(at, l, gridDim.x)) {
        issue();
        wsum::wait_copies(l.stages - 1);
        __syncthreads();
        if (l.groups > 1) {
            build_a(a, l, at.g, a_s, tid);
            __syncthreads();
        }
        wsum::product(l.pitch, group_regs(a, l, at.g), shared_address(a_s),
                      shared_address(b_s + at.slot * l.slot_bytes), warp & 3, warp >> 2, lane,
                      acc, PointB{l.pitch});
        if (at.g == l.groups - 1) {
            uint32_t* const digits = (uint32_t*)(b_s + at.slot * l.slot_bytes);
            __syncthreads();
            wsum::store_digits<kSums>(acc, digits, warp & 3, warp >> 2, lane);
            __syncthreads();
            const u128 value = sum_value(a, digits, tid);
            uint4 v = f128::to_limbs(value);
            v.x = __shfl_down_sync(0xFFFFFFFFu, v.x, 1);
            v.y = __shfl_down_sync(0xFFFFFFFFu, v.y, 1);
            v.z = __shfl_down_sync(0xFFFFFFFFu, v.z, 1);
            v.w = __shfl_down_sync(0xFFFFFFFFu, v.w, 1);
            if ((tid & 1) == 0) finish(a, at.tile, tid, value, f128::from_limbs(v));
        }
        __syncthreads();
    }
}

}  // namespace

// out[0, n) the first-step column, out[n, 2n) the last-step one; weights:
// the host's 4 x regs x 4 words of w1i, w2i, w1f, w2f; constants: its 16
// words of c1i, c2i, c1f, c2f; xb_hi may be null.  As many blocks as fit
// the card at once, at most one a tile.
extern "C" int distaff_boundary_columns(const void* lde, long long reg_stride,
                                        long long point_stride, int regs, long long n,
                                        const uint32_t* weights, const void* xb_lo,
                                        const void* xb_hi, int log_lo,
                                        const uint32_t* constants, void* out, long long first,
                                        void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || point_stride < 1 || reg_stride < 0 ||
        log_lo < 0 || log_lo > 30 || first < 0)
        return (int)cudaErrorInvalidValue;
    Args a{(const uint4*)lde, reg_stride, point_stride, regs, n, (const uint4*)xb_lo,
           (const uint4*)xb_hi, log_lo, {}, (uint4*)out, {}, first};
    std::memcpy(a.c, constants, sizeof(a.c));
    for (int s = 0; s < kSums; ++s)
        std::memcpy(a.w + s * kMaxRegisters, weights + 4 * s * regs, sizeof(uint4) * regs);
    if (tiles(a) == 0) return (int)cudaSuccess;
    static std::atomic<int> limit_set[per_device::kMaxDevices];
    const cudaError_t configured =
        per_device::shared_limit(limit_set, boundary_columns_kernel, kSharedBytes);
    if (configured != cudaSuccess) return (int)configured;
    const int bytes = shared_bytes(layout(regs));
    cudaError_t err;
    const long long blocks = wsum::grid_of(boundary_columns_kernel, tiles(a), bytes, &err);
    if (blocks == 0) return (int)err;
    boundary_columns_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
