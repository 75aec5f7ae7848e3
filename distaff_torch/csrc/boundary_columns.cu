// K10 boundary_columns on the card: the kernel of boundary_columns.cuh
// (design and bound there), its tensor-core product and its launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "boundary_columns.cuh"

namespace {

using namespace boundary_columns;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t address) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(address)
                 : "memory");
}

// c += a b over one m16n8k32 tile: unsigned bytes, s32 sums
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wait until at most `pending` (< kMaxStages) groups of copies are in flight
__device__ __forceinline__ void wait_copies(int pending) {
    switch (pending) {
#define WAIT_CASE(k) \
    case k: asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); break;
        WAIT_CASE(0) WAIT_CASE(1) WAIT_CASE(2) WAIT_CASE(3)
        WAIT_CASE(4) WAIT_CASE(5) WAIT_CASE(6) default: WAIT_CASE(7)
#undef WAIT_CASE
    }
}

// Warp (s, h)'s digit sums over one stage: for each 32-byte k-step, its
// two m16 tiles of A and four n8 tiles of B, 8 mma.
__device__ __forceinline__ void product(const Layout& l, int count, uint32_t a_s, uint32_t b_s,
                                        int s, int h, int lane, int (&acc)[2][4][4]) {
    for (int kk = 0; kk < ksteps(count); ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[mt], a_s + a_offset(l, 32 * s + 16 * mt, kk, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, b_s + b_offset(l, 32 * h + 16 * np, kk, lane));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                mma_u8(acc[mt][2 * np], a[mt], b[0], b[1]);
                mma_u8(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
        }
    }
}

// The accumulators into the digits' stage, and to zero for the next tile
__device__ __forceinline__ void store_digits(int (&acc)[2][4][4], uint32_t* digits, int s, int h,
                                             int lane) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int at = digit_word(s, h, mt, nt, lane, i);
                if (at >= 0) digits[at] = (uint32_t)acc[mt][nt][i];
                acc[mt][nt][i] = 0;
            }
}

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
        wait_copies(l.stages - 1);
        __syncthreads();
        if (l.groups > 1) {
            build_a(a, l, at.g, a_s, tid);
            __syncthreads();
        }
        product(l, group_regs(a, l, at.g), shared_address(a_s),
                shared_address(b_s + at.slot * l.slot_bytes), warp & 3, warp >> 2, lane, acc);
        if (at.g == l.groups - 1) {
            uint32_t* const digits = (uint32_t*)(b_s + at.slot * l.slot_bytes);
            __syncthreads();
            store_digits(acc, digits, warp & 3, warp >> 2, lane);
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
                                        const uint32_t* constants, void* out, void* stream) {
    if (regs < 1 || regs > kMaxRegisters || n < 0 || point_stride < 1 || reg_stride < 0 ||
        log_lo < 0 || log_lo > 30)
        return (int)cudaErrorInvalidValue;
    Args a{(const uint4*)lde, reg_stride, point_stride, regs, n, (const uint4*)xb_lo,
           (const uint4*)xb_hi, log_lo, {}, (uint4*)out, {}};
    std::memcpy(a.c, constants, sizeof(a.c));
    for (int s = 0; s < kSums; ++s)
        std::memcpy(a.w + s * kMaxRegisters, weights + 4 * s * regs, sizeof(uint4) * regs);
    if (tiles(a) == 0) return (int)cudaSuccess;
    static const cudaError_t configured = cudaFuncSetAttribute(
        boundary_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
    if (configured != cudaSuccess) return (int)configured;
    const int bytes = shared_bytes(layout(regs));
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boundary_columns_kernel,
                                                            kThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long fit = (long long)per_sm * sms;
    const long long blocks = tiles(a) < fit ? tiles(a) : fit;
    boundary_columns_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
