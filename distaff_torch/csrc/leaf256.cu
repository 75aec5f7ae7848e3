// K16 leaf256 on the card: the kernel of leaf256.cuh (design and bound
// there) on the u8 mma.sync, and one launch of it.

#include <cuda_runtime.h>
#include <cstdint>

#include "per_device.cuh"
#include "leaf256.cuh"

namespace {

using namespace leaf256;

// c += a b over one m16n8k32 tile: unsigned bytes, s32 sums.  Not volatile,
// so that the compiler may interleave the chains and the reductions.
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over one m16n8k16 tile (a0, a1: one plane of the matrix)
__device__ __forceinline__ void mma16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

// kstep's products on the card: c += a b over one m16n8k32 or m16n8k16
// (callable from kstep's host side too, where it is never run)
struct Products {
    int (&c)[4];
    F128_FN void k32(const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
#ifdef __CUDA_ARCH__
        mma(c, a, b0, b1);
#endif
    }
    F128_FN void k16(uint32_t a0, uint32_t a1, uint32_t b0) {
#ifdef __CUDA_ARCH__
        mma16(c, a0, a1, b0);
#endif
    }
};

// matrix m's A fragments for this lane, eight 16-byte loads
__device__ __forceinline__ void load_fragments(const uint4* __restrict__ frags, int m, int lane,
                                               uint32_t (&a)[kKSteps][4]) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
        const uint4 w = __ldg(frags + fragment_unit(m, kk, lane));
        a[kk][0] = w.x;
        a[kk][1] = w.y;
        a[kk][2] = w.z;
        a[kk][3] = w.w;
    }
}

// limbs 0-3 parked in shared memory (volatile: the compiler keeps no copy)
__device__ __forceinline__ void park(uint4* at, uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "r"((uint32_t)__cvta_generic_to_shared(at)), "r"(x), "r"(y), "r"(z), "r"(w)
                 : "memory");
}
__device__ __forceinline__ uint4 unpark(const uint4* at) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"((uint32_t)__cvta_generic_to_shared(at)) : "memory");
    return v;
}

// The matrix applied to the warp's eight vectors, whose planes p a lane
// holds: the lane's four elements (accumulators 0-3), each reduced as its
// digits come out, a limb (four mma chains) at a time.  In each k-step the
// four digits' first halves go before their second halves, so that an
// even digit's two m16n8k16 do not follow one another.  reduced: the
// elements below M, else below 2^128.  parked: the lane's parking units.
__device__ __forceinline__ void apply(const uint32_t (&a)[kKSteps][4], const uint32_t (&p)[kSide],
                                      bool reduced, uint4 (&y)[4], uint4* parked) {
    Digits s[4] = {};
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
        int acc[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int dd = 0; dd < 4; ++dd) {
                    const int d = 4 * k + dd;
                    if (d < f128::kDigits && live(d, kk)) {
                        Products op{acc[dd]};
                        kstep(op, a[kk], p, d, kk, h);
                    }
                }
#pragma unroll
        for (int i = 0; i < 4; ++i)
            take(s[i], k, acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
        if (k < 4) park(parked + 32 * k, s[0].limb[k], s[1].limb[k], s[2].limb[k], s[3].limb[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint4 l = unpark(parked + 32 * k);
        s[0].limb[k] = l.x;
        s[1].limb[k] = l.y;
        s[2].limb[k] = l.z;
        s[3].limb[k] = l.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = finish(s[i], reduced);
}

// threadIdx.x, read where it is used: ptxas recomputes the lane's offsets
// in each tile instead of keeping them (or spilling them) across the loops
__device__ __forceinline__ int thread_index() {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
leaf256_kernel(const uint4* __restrict__ x, const uint4* __restrict__ frags,
               uint4* __restrict__ out, long long leaves) {
    extern __shared__ __align__(16) uint4 mid[];
    const long long leaf0 = (long long)blockIdx.x * kTile;
    const long long rest = leaves - leaf0;
    const int valid = rest < kTile ? (int)rest : kTile;
    uint32_t a[kKSteps][4], p[kSide];
    uint4 v[4], y[4];

    // stage A: W applied to the warp's n8 tiles of vectors (leaf, i1), its
    // fragments loaded a tile (from L1): held across the tiles they cost
    // registers that spill (tools/air_probe.py k16, "W once")
#pragma unroll 1
    for (int r = 0; r < kATiles; ++r) {
        const int warp = thread_index() >> 5, lane = thread_index() & 31;
        const int leaf = a_leaf(warp, r), h = a_half(warp, r);
        const uint4* const src = x + (leaf0 + leaf) * kPoints;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = leaf < valid ? __ldg(src + a_point(h, lane, j)) : make_uint4(0, 0, 0, 0);
        load_fragments(frags, 0, lane, a);
        planes(v, p);
        apply(a, p, false, y, mid + park_unit(warp, lane));
#pragma unroll
        for (int i = 0; i < 4; ++i) mid[a_store(leaf, h, lane, i)] = y[i];
    }
    __syncthreads();

    // stage B: C[k2] applied to the tile's leaves, each slab read and written
    // by one warp; a matrix loaded once
#pragma unroll 1
    for (int t = 0; t < kBTiles; ++t) {
        const int warp = thread_index() >> 5, lane = thread_index() & 31;
        const int k2 = b_k2(warp, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = mid[b_load(k2, lane, j)];
        load_fragments(frags, 1 + k2, lane, a);
        planes(v, p);
        apply(a, p, true, y, mid + park_unit(warp, lane));
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) mid[b_store(k2, lane, i)] = y[i];
    }
    __syncthreads();

    for (int e = thread_index(); e < valid * kPoints; e += kThreads)
        out[leaf0 * kPoints + e] = mid[out_slot(e)];
}

// the kernel's shared-memory limit, set once a device
cudaError_t configure() {
    static std::atomic<int> limit_set[per_device::kMaxDevices];
    return per_device::shared_limit(limit_set, leaf256_kernel, kSharedBytes);
}

}  // namespace

// out (leaves, 256) <- the natural-order 256-point NTT of each leaf of x,
// at the root whose stage matrices' A fragments `frags` holds (ops/
// mxu_ntt.kernel_entries: (17, 8, 32, 4) words).  A block a tile of kTile
// leaves.
extern "C" int distaff_leaf256(const void* x, const void* frags, void* out, long long leaves,
                               void* stream) {
    if (leaves < 0 || (leaves + kTile - 1) / kTile > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    if (leaves == 0) return (int)cudaSuccess;
    const cudaError_t configured = configure();
    if (configured != cudaSuccess) return (int)configured;
    leaf256_kernel<<<(unsigned)((leaves + kTile - 1) / kTile), kThreads, kSharedBytes,
                     (cudaStream_t)stream>>>((const uint4*)x, (const uint4*)frags,
                                             (uint4*)out, leaves);
    return (int)cudaGetLastError();
}

// *blocks <- the blocks of K16 resident on an SM of the current card, by
// its registers and shared memory, *warps <- its warps a block
extern "C" int distaff_leaf256_blocks_per_sm(int* blocks, int* warps) {
    *warps = kWarps;
    const cudaError_t configured = configure();
    if (configured != cudaSuccess) return (int)configured;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, leaf256_kernel, kThreads,
                                                              kSharedBytes);
}
