// Weighted register sums as one unsigned-byte matrix product on the int8
// tensor cores, shared by K10 boundary_columns (four sums), K7 deep_compose
// and K15 coeff_wsum (two sums each).
//
// Split into bytes, w v = sum_d 2^(8d) sum_q w_(d-q) v_q, so the sums S_s =
// sum_r w_(s,r) v_r of a point have 31 digits each, D_(s,d) = sum_r sum_q
// byte(w_(s,r), d - q) byte(v_r, q), and for a tile of points all of them
// are one product D = A B:
// - A (32 kSums x 16R bytes) is the Toeplitz expansion of the (kSums, R)
//   weights: row 32 s + d, column 16 r + q holds byte d - q of w_(s,r) (0
//   outside 0 <= d - q < 16; row 32 s + 31 is all 0);
// - B (16R x kTile) is the tile's values, 16 bytes a register, a point's K
//   contiguous (mma's "col" operand);
// - each digit is a sum of at most 16 R 255^2 < 2^27 byte products (R <=
//   128): exact in the s32 sums of mma.sync.m16n8k32.row.col.s32.u8.u8.s32.
// f128::reduce_digits then takes each (point, sum) from its digits to the
// field once, in place of R modular multiplies and adds a sum.
//
// A block is eight warps, warp w computes sum w mod kSums over the 32
// points 32 (w / kSums) on of a tile of kTile = 256 / kSums points: per
// 32-byte k-step (two registers) it loads its two m16 tiles of A and four
// n8 tiles of B with ldmatrix.x4 and issues 8 mma.  A row's pitch is an
// odd number of 16-byte units (no bank conflicts).  Registers go in groups
// of at most kMaxGroup; above that A is rebuilt for each group and the
// digit sums accumulate across the groups.
//
// K10 stages B point-major (its slice has a point stride, boundary_columns.
// cuh).  K7 and K15 read each register's points at stride 1, so a
// (register, tile) run of kTile points is one contiguous copy: the Ring
// below stages a group's runs register-major, register r's point p at 16 (r
// kTile + p) in the stage, where an ldmatrix row (8 points of one register)
// is 128 contiguous bytes, as ldmatrix takes it (each lane gives its own row
// address).  On the card each run is one bulk asynchronous copy
// (cp.async.bulk, a 1-D TMA copy: no tensor map) completing on the slot's
// mbarrier; with -DWSUM_CP_ASYNC, 16-byte cp.async copies as K10's ring
// (tools/air_probe.py times both).  A block keeps the copies of the next
// stages - 1 stages in flight while it multiplies and reduces this one's,
// and of all `stages` while its epilogue runs on from the reduced sums (K7's
// composition), over the tiles block + k grid (persistent, grid-strided
// blocks).
//
// This header compiles as plain C++ too (the card's part is under
// __CUDACC__): the tests build A and lay out the stages with these
// functions and run the product through an emulation of ldmatrix and
// mma.m16n8k32 on the fragment addresses below.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace wsum {

constexpr int kThreads = 256;           // eight warps
constexpr int kMaxGroup = 32;           // registers a group
constexpr int kSharedBytes = 232448;    // shared memory a block can have on the H100 (227 KB)
constexpr int kSharedPerSM = 233472;    // an SM's (228 KB)
constexpr int kReserved = 1024;         // the runtime's share of it a block
#ifndef WSUM_MAX_STAGES
#define WSUM_MAX_STAGES 8
#endif
constexpr int kMaxStages = WSUM_MAX_STAGES;   // B stages: the copies of up to 7 in flight
constexpr int kMaxRegisters = 128;      // config.MAX_REGISTER_COUNT

// The tile of a product of kSums sums: its points, A's rows, and the
// digits' stage (kDigits rows of kDigitPitch words a sum, kSumGap words
// between two sums: 31 kDigitPitch + kSumGap = 16 mod 32, so that the two
// sums of a point lie 16 banks apart)
template <int kSums>
struct Shape {
    static constexpr int kTile = kThreads / kSums;
    static constexpr int kRows = 32 * kSums;
    static constexpr int kDigitPitch = kTile + 8;
    static constexpr int kSumGap = 24;
    static constexpr int kDigitBytes = kSums * (f128::kDigits * kDigitPitch + kSumGap) * 4;

    // word of sum s's digit d at point p in the digits' stage
    static F128_FN int digit_at(int s, int d, int p) {
        return s * (f128::kDigits * kDigitPitch + kSumGap) + d * kDigitPitch + p;
    }

    // Where accumulator i of lane `lane` of warp (s, h) for m16 tile mt and
    // n8 tile nt (points 32 h + 8 nt on) goes in the digits' stage (mma's
    // c_i: row (lane >> 2) + 8 (i >> 1), column 2 (lane & 3) + (i & 1)), or
    // -1 for the digit d = 31, which is 0.
    static F128_FN int digit_word(int s, int h, int mt, int nt, int lane, int i) {
        const int d = 16 * mt + (lane >> 2) + 8 * (i >> 1);
        return d < f128::kDigits ? digit_at(s, d, 32 * h + 8 * nt + 2 * (lane & 3) + (i & 1))
                                 : -1;
    }
};

// registers a group, groups of at most kMaxGroup as even as can be
F128_FN int groups_of(int regs) { return (regs + kMaxGroup - 1) / kMaxGroup; }
F128_FN int group_of(int regs) { return (regs + groups_of(regs) - 1) / groups_of(regs); }

// the registers of group g
F128_FN int group_regs(int regs, int group, int g) {
    const int rest = regs - g * group;
    return rest < group ? rest : group;
}

// 32-byte k-steps of a group of `count` registers
F128_FN int ksteps(int count) { return (count + 1) / 2; }

// A row's bytes: a group's 16-byte units, rounded up to a k-step, plus one
// so that the pitch is an odd number of units
F128_FN int pitch_of(int group) { return 16 * (2 * ksteps(group) + 1); }

F128_FN uint32_t byte_of(uint4 w, int e) {
    const uint32_t limb = e < 4 ? w.x : e < 8 ? w.y : e < 12 ? w.z : w.w;
    return (limb >> (8 * (e & 3))) & 0xFF;
}

// A for a group of `count` registers into a_s: row 32 s + d, column 16 r +
// q holds byte d - q of w[s][r], 0 where there is no such byte or
// register; thread tid writes its share of the words.  w[s]: the group's
// weights of sum s (a kernel parameter or device memory).
template <int kSums>
F128_FN void build_a(const uint4* const* w, int count, int pitch, uint8_t* a_s, int tid) {
    const int words = pitch / 4;
    for (int i = tid; i < Shape<kSums>::kRows * words; i += kThreads) {
        const int row = i / words, col = 4 * (i % words);
        const int s = row >> 5, d = row & 31, r = col >> 4, q = col & 15;
        uint32_t word = 0;
        if (r < count) {
            const uint4 v = w[s][r];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int e = d - q - b;
                if (e >= 0 && e < 16) word |= byte_of(v, e) << (8 * b);
            }
        }
        *(uint32_t*)(a_s + row * pitch + col) = word;
    }
}

// ldmatrix.x4: lane l gives the row address (l & 7) of matrix l >> 3, and
// receives in register j the word at bytes 4 (l & 3) of row l >> 2 of
// matrix j.  A's m16 tile at rows row0, k-step kk: matrices (rows 0-7,
// bytes 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31), mma's a0-a3; the
// offset in bytes into A of lane `lane`'s row.
F128_FN int a_offset(int pitch, int row0, int kk, int lane) {
    const int j = lane >> 3;
    return (row0 + (lane & 7) + 8 * (j & 1)) * pitch + 32 * kk + 16 * (j >> 1);
}

// ------------------------------------------------------------------------------------------------
// The ring of K7 and K15: register-major stages of (register, tile) runs
// ------------------------------------------------------------------------------------------------

using Pair = Shape<2>;
constexpr int kRunBytes = Pair::kTile * 16;   // a register's run of a tile
constexpr int kBarrierBytes = 128;            // the slots' mbarriers, first in shared memory

// The values: register r's point i at base[r reg_stride + i]; the weights
// of the two sums, each (regs,) in device memory
struct Source {
    const uint4* base;
    long long reg_stride;    // in 16-byte units
    int regs;
    long long n;             // points
    const uint4* w1;
    const uint4* w2;
};

// Shared memory: kBarrierBytes of mbarriers, the kernel's own `extra`
// bytes, A (Pair::kRows rows of `pitch` bytes), then a ring of `stages`
// slots of a group's runs (2 ksteps(group) runs of kRunBytes, an odd
// group's last run unused: A's columns there are 0).  The tile's digits go
// over the slot just consumed where a stage is at least their size (R >=
// 17), else in an area of their own after the ring, so that small groups
// keep many stages in flight.  Two blocks share an SM where two slots a
// block fit in half of it (kSharedPerSM, less kReserved a block), else one
// block takes as many as fit in kSharedBytes; at most kMaxStages.
struct Ring {
    int groups, group, pitch, extra, a_bytes, stage_bytes, digit_bytes, slot_bytes, stages;
};

F128_FN Ring ring(int regs, int extra) {
    Ring l;
    l.groups = groups_of(regs);
    l.group = group_of(regs);
    l.pitch = pitch_of(l.group);
    l.extra = extra;
    l.a_bytes = Pair::kRows * l.pitch;
    l.stage_bytes = 2 * ksteps(l.group) * kRunBytes;
    l.digit_bytes = l.stage_bytes >= Pair::kDigitBytes ? 0 : Pair::kDigitBytes;
    l.slot_bytes = l.stage_bytes;
    const int fixed = kBarrierBytes + extra + l.a_bytes + l.digit_bytes;
    l.stages = (kSharedPerSM / 2 - kReserved - fixed) / l.slot_bytes;
    if (l.stages < 2) l.stages = (kSharedBytes - fixed) / l.slot_bytes;
    if (l.stages > kMaxStages) l.stages = kMaxStages;
    return l;
}

F128_FN int shared_bytes(const Ring& l) {
    return kBarrierBytes + l.extra + l.a_bytes + l.digit_bytes + l.stages * l.slot_bytes;
}

// offsets into shared memory: the kernel's extra bytes, A, the ring's
// first slot, the digits' own area
F128_FN int extra_at(const Ring&) { return kBarrierBytes; }
F128_FN int a_at(const Ring& l) { return kBarrierBytes + l.extra; }
F128_FN int ring_at(const Ring& l) { return a_at(l) + l.a_bytes; }
F128_FN int digits_at(const Ring& l, int slot) {
    return l.digit_bytes ? ring_at(l) + l.stages * l.slot_bytes : ring_at(l) + slot * l.slot_bytes;
}

F128_FN long long tiles(const Source& s) { return (s.n + Pair::kTile - 1) / Pair::kTile; }

// the tiles of block `block` in a grid of `grid`: block + k grid, k < mine
F128_FN long long block_tiles(long long tiles, long long block, long long grid) {
    return tiles > block ? (tiles - block - 1) / grid + 1 : 0;
}

// A block's stages (its k-th tile, group g), in order, and each stage's
// slot in the ring and the parity of that slot's use
struct Cursor {
    long long k;
    int g, slot;
    uint32_t parity;
};

F128_FN void advance(Cursor& c, const Ring& l) {
    if (++c.g == l.groups) {
        c.g = 0;
        ++c.k;
    }
    if (++c.slot == l.stages) {
        c.slot = 0;
        c.parity ^= 1;
    }
}

// A for group g of the two sums
F128_FN void build_a(const Source& s, const Ring& l, int g, uint8_t* a_s, int tid) {
    const uint4* const w[2] = {s.w1 + g * l.group, s.w2 + g * l.group};
    build_a<2>(w, group_regs(s.regs, l.group, g), l.pitch, a_s, tid);
}

// points of tile t that lie below n (a ragged last tile has fewer): its
// runs' length
F128_FN int run_points(const Source& s, long long t) {
    const long long rest = s.n - t * Pair::kTile;
    return rest < Pair::kTile ? (int)rest : Pair::kTile;
}

// register r of group g's run of tile t: its first value, and its place
// in the stage (in bytes)
F128_FN const uint4* run_source(const Source& s, const Ring& l, long long t, int g, int r) {
    return s.base + (long long)(g * l.group + r) * s.reg_stride + t * Pair::kTile;
}

F128_FN int run_offset(int r) { return r * kRunBytes; }

// B's two n8 tiles at points p0 and p0 + 8, k-step kk (registers 2 kk and
// 2 kk + 1): matrices (register 2 kk, p0), (2 kk + 1, p0), (2 kk, p0 + 8),
// (2 kk + 1, p0 + 8), b0 and b1 of each; the offset in bytes into a
// register-major stage of lane `lane`'s row
struct RunB {
    F128_FN int operator()(int p0, int kk, int lane) const {
        const int j = lane >> 3;
        return ((2 * kk + (j & 1)) * Pair::kTile + p0 + (lane & 7) + 8 * (j >> 1)) * 16;
    }
};

// the epilogue's (sum, point) of thread tid: the warp on one sum, 32
// consecutive points (conflict-free digit reads, coalesced stores)
F128_FN int sum_of(int tid) { return tid / Pair::kTile; }
F128_FN int point_of(int tid) { return tid % Pair::kTile; }

// thread tid's sum, from the tile's digits
F128_FN f128::u128 reduce(const uint32_t* digits, int tid) {
    return f128::reduce_digits(digits + Pair::digit_at(sum_of(tid), 0, point_of(tid)),
                               Pair::kDigitPitch);
}

#ifdef __CUDACC__
// ------------------------------------------------------------------------------------------------
// the card's part
// ------------------------------------------------------------------------------------------------

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

// wait until at most `pending` (< 8) groups of cp.async copies are in flight
__device__ __forceinline__ void wait_copies(int pending) {
    switch (pending) {
#define WAIT_CASE(k) \
    case k: asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); break;
        WAIT_CASE(0) WAIT_CASE(1) WAIT_CASE(2) WAIT_CASE(3)
        WAIT_CASE(4) WAIT_CASE(5) WAIT_CASE(6) default: WAIT_CASE(7)
#undef WAIT_CASE
    }
}

// Warp (s, h)'s digit sums over one stage of `count` registers: for each
// 32-byte k-step, its two m16 tiles of A and four n8 tiles of B, 8 mma.
// b_offset(p0, kk, lane): B's layout (K10's PointB, the ring's RunB).
template <class BOffset>
__device__ __forceinline__ void product(int pitch, int count, uint32_t a_s, uint32_t b_s, int s,
                                        int h, int lane, int (&acc)[2][4][4],
                                        const BOffset& b_offset) {
    for (int kk = 0; kk < ksteps(count); ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[mt], a_s + a_offset(pitch, 32 * s + 16 * mt, kk, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, b_s + b_offset(32 * h + 16 * np, kk, lane));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                mma_u8(acc[mt][2 * np], a[mt], b[0], b[1]);
                mma_u8(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
        }
    }
}

// The accumulators into the digits' stage, and to zero for the next tile
template <int kSums>
__device__ __forceinline__ void store_digits(int (&acc)[2][4][4], uint32_t* digits, int s, int h,
                                             int lane) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int at = Shape<kSums>::digit_word(s, h, mt, nt, lane, i);
                if (at >= 0) digits[at] = (uint32_t)acc[mt][nt][i];
                acc[mt][nt][i] = 0;
            }
}

// The ring's copies of one stage (block tile t, group g) into a slot: the
// bulk copy of each register's run by lane r of warp 0, on the slot's
// mbarrier (lane 0 arms it with the stage's bytes first); or, with
// WSUM_CP_ASYNC, 16-byte cp.async copies by every thread, one commit group
// a stage (empty past the last stage: pass t < 0).
__device__ __forceinline__ void copy_stage(const Source& s, const Ring& l, long long t, int g,
                                           uint8_t* stage, uint64_t* bar) {
#ifdef WSUM_CP_ASYNC
    (void)bar;
    if (t >= 0) {
        const int points = run_points(s, t), count = group_regs(s.regs, l.group, g);
        for (int i = threadIdx.x; i < points * count; i += kThreads) {
            const int r = i / points, p = i % points;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(shared_address(stage + run_offset(r) + 16 * p)),
                            "l"(run_source(s, l, t, g, r) + p)
                         : "memory");
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
    const int lane = threadIdx.x & 31;
    if (t < 0 || threadIdx.x >= 32) return;
    const int count = group_regs(s.regs, l.group, g);
    const uint32_t bytes = 16u * run_points(s, t), b = shared_address(bar);
    if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(b), "r"(bytes * count) : "memory");
    __syncwarp();
    if (lane < count) {
        uint64_t policy;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
            "[%0], [%1], %2, [%3], %4;\n"
            :: "r"(shared_address(stage + run_offset(lane))), "l"(run_source(s, l, t, g, lane)),
               "r"(bytes), "r"(b), "l"(policy)
            : "memory");
    }
#endif
}

// Until the stage at cursor c is in its slot, for every thread
__device__ __forceinline__ void wait_stage(const Ring& l, const Cursor& c, uint64_t* bars) {
#ifdef WSUM_CP_ASYNC
    (void)c;
    (void)bars;
    wait_copies(l.stages - 1);      // the groups of the stages after this one may be in flight
    __syncthreads();
#else
    (void)l;
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n"
        :: "r"(shared_address(bars + c.slot)), "r"(c.parity)
        : "memory");
#endif
}

// The two weighted sums of the block's tiles block + k grid (k < mine).
// For each tile, once its digits are in the stage `digits`,
// reduce(k, mine, digits) runs on every thread of the block; then the
// tile's slot is free, the copies of the stage `stages` on go into it, and
// then(k, mine) runs (it may use barriers), with every slot's copies in
// flight.  `shared`: the block's dynamic shared memory, laid out as
// ring(s.regs, extra) says.
template <class Reduce, class Then>
__device__ __forceinline__ void run(const Source& s, const Ring& l, uint8_t* shared,
                                    Reduce&& reduce, Then&& then) {
    uint64_t* const bars = (uint64_t*)shared;
    uint8_t* const a_s = shared + a_at(l);
    uint8_t* const b_s = shared + ring_at(l);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long mine = block_tiles(tiles(s), blockIdx.x, gridDim.x);
    if (tid == 0) {
        for (int i = 0; i < l.stages; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(shared_address(bars + i)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (l.groups == 1) build_a(s, l, 0, a_s, tid);
    __syncthreads();
    Cursor in{0, 0, 0, 0}, at = in;
    auto issue = [&]() {
        copy_stage(s, l, in.k < mine ? blockIdx.x + in.k * gridDim.x : -1, in.g,
                   b_s + in.slot * l.slot_bytes, bars + in.slot);
        advance(in, l);
    };
    for (int i = 0; i < l.stages; ++i) issue();
    int acc[2][4][4] = {};
    for (; at.k < mine; advance(at, l)) {
        wait_stage(l, at, bars);
        if (l.groups > 1) {
            build_a(s, l, at.g, a_s, tid);
            __syncthreads();
        }
        product(l.pitch, group_regs(s.regs, l.group, at.g), shared_address(a_s),
                shared_address(b_s + at.slot * l.slot_bytes), warp & 1, warp >> 1, lane, acc,
                RunB());
        const bool last = at.g == l.groups - 1;
        if (last) {
            uint32_t* const digits = (uint32_t*)(shared + digits_at(l, at.slot));
            __syncthreads();
            store_digits<2>(acc, digits, warp & 1, warp >> 1, lane);
            __syncthreads();
            reduce(at.k, mine, (const uint32_t*)digits);
        }
        __syncthreads();
        issue();
        if (last) then(at.k, mine);
    }
}

// Blocks for a launch of `kernel` over `tiles` tiles with `bytes` of
// shared memory a block: as many as fit the card at once, at most one a
// tile; 0 on an error (in *err).
template <class Kernel>
inline long long grid_of(Kernel kernel, long long tiles, int bytes, cudaError_t* err) {
    int device = 0, sms = 0, per_sm = 0;
    *err = cudaGetDevice(&device);
    if (*err == cudaSuccess)
        *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (*err == cudaSuccess)
        *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    if (*err != cudaSuccess) return 0;
    if (per_sm < 1) {
        *err = cudaErrorInvalidConfiguration;
        return 0;
    }
    const long long fit = (long long)per_sm * sms;
    return tiles < fit ? tiles : fit;
}
#endif

}  // namespace wsum
