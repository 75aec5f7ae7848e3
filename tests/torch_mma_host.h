// The card's int8 tensor-core product on the CPU, for the tests that build
// the port's kernel headers with g++ (tests/test_torch_fri.py for K10,
// test_torch_deep.py for K7, test_torch_stream.py for K15,
// test_torch_mxu_ntt.py for K16): ldmatrix.x4,
// mma.m16n8k32.row.col.s32.u8.u8.s32 and (K16's even digits)
// mma.m16n8k16.row.col.s32.u8.u8.s32 as the PTX ISA gives their fragments,
// a warp's product and its digits' store for the 32 lanes at once (as
// csrc/wsum_product.cuh's product and store_digits run them), and the ring
// of K7 and K15 (wsum::run) a block at a time.

#pragma once
#include <cstring>
#include <vector>

#include "wsum_product.cuh"

namespace mma_host {

// ldmatrix.x4: lane l's register j is the word at bytes 4 (l & 3) of the
// row whose address lane 8 j + (l >> 2) gave
inline void ldmatrix_x4(const uint8_t* base, const int (&offset)[32], uint32_t (&r)[32][4]) {
    for (int l = 0; l < 32; ++l)
        for (int j = 0; j < 4; ++j)
            std::memcpy(&r[l][j], base + offset[8 * j + (l >> 2)] + 4 * (l & 3), 4);
}

// mma.m16n8k32.row.col.s32.u8.u8.s32 with the PTX ISA's fragments: lane
// l = 4 g + t holds A's rows g (a0, a2) and g + 8 (a1, a3) at bytes 4 t (a0,
// a1) and 16 + 4 t (a2, a3), B's column g at bytes 4 t (b0) and 16 + 4 t
// (b1), C's rows g (c0, c1) and g + 8 (c2, c3) at columns 2 t and 2 t + 1
inline void mma(int32_t (&c)[32][4], const uint32_t (&a)[32][4], uint32_t (&b)[32][4], int half) {
    uint8_t A[16][32], B[8][32];
    for (int l = 0; l < 32; ++l) {
        const int g = l >> 2, t = l & 3;
        for (int e = 0; e < 4; ++e) {
            A[g][4 * t + e] = a[l][0] >> (8 * e);
            A[g + 8][4 * t + e] = a[l][1] >> (8 * e);
            A[g][16 + 4 * t + e] = a[l][2] >> (8 * e);
            A[g + 8][16 + 4 * t + e] = a[l][3] >> (8 * e);
            B[g][4 * t + e] = b[l][2 * half] >> (8 * e);
            B[g][16 + 4 * t + e] = b[l][2 * half + 1] >> (8 * e);
        }
    }
    for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i) {
            const int row = (l >> 2) + 8 * (i >> 1), col = 2 * (l & 3) + (i & 1);
            int32_t sum = 0;
            for (int k = 0; k < 32; ++k) sum += A[row][k] * B[col][k];
            c[l][i] += sum;
        }
}

// mma.m16n8k16.row.col.s32.u8.u8.s32: lane l = 4 g + t holds A's rows g
// (a0) and g + 8 (a1) at bytes 4 t, B's column g at bytes 4 t (b0), C as
// mma's
inline void mma16(int32_t (&c)[32][4], const uint32_t (&a)[32][2], const uint32_t (&b)[32]) {
    uint8_t A[16][16], B[8][16];
    for (int l = 0; l < 32; ++l) {
        const int g = l >> 2, t = l & 3;
        for (int e = 0; e < 4; ++e) {
            A[g][4 * t + e] = a[l][0] >> (8 * e);
            A[g + 8][4 * t + e] = a[l][1] >> (8 * e);
            B[g][4 * t + e] = b[l] >> (8 * e);
        }
    }
    for (int l = 0; l < 32; ++l)
        for (int i = 0; i < 4; ++i) {
            const int row = (l >> 2) + 8 * (i >> 1), col = 2 * (l & 3) + (i & 1);
            int32_t sum = 0;
            for (int k = 0; k < 16; ++k) sum += A[row][k] * B[col][k];
            c[l][i] += sum;
        }
}

// a warp's accumulators, [m16 tile][n8 tile][lane][c_i]
typedef int32_t Acc[2][4][32][4];

// warp (s, h)'s product over a stage of `count` registers, wsum::product
// for the 32 lanes at once; b_offset: the stage's B layout
template <class BOffset>
void product(int pitch, int count, const uint8_t* a_s, const uint8_t* b_s, int s, int h,
             Acc& acc, const BOffset& b_offset) {
    for (int kk = 0; kk < wsum::ksteps(count); ++kk) {
        uint32_t a[2][32][4], b[32][4];
        int offset[32];
        for (int mt = 0; mt < 2; ++mt) {
            for (int lane = 0; lane < 32; ++lane)
                offset[lane] = wsum::a_offset(pitch, 32 * s + 16 * mt, kk, lane);
            ldmatrix_x4(a_s, offset, a[mt]);
        }
        for (int np = 0; np < 2; ++np) {
            for (int lane = 0; lane < 32; ++lane) offset[lane] = b_offset(32 * h + 16 * np, kk, lane);
            ldmatrix_x4(b_s, offset, b);
            for (int mt = 0; mt < 2; ++mt) {
                mma(acc[mt][2 * np], a[mt], b, 0);
                mma(acc[mt][2 * np + 1], a[mt], b, 1);
            }
        }
    }
}

// warp (s, h)'s accumulators into the digits' stage and to zero,
// wsum::store_digits for the 32 lanes at once
template <int kSums>
void store_digits(Acc& acc, uint32_t* digits, int s, int h) {
    for (int mt = 0; mt < 2; ++mt)
        for (int nt = 0; nt < 4; ++nt)
            for (int lane = 0; lane < 32; ++lane)
                for (int i = 0; i < 4; ++i) {
                    const int word = wsum::Shape<kSums>::digit_word(s, h, mt, nt, lane, i);
                    if (word >= 0) digits[word] = (uint32_t)acc[mt][nt][lane][i];
                    acc[mt][nt][lane][i] = 0;
                }
}

// wsum::run for the blocks of a grid of `grid`, one after another, each
// phase for all threads of the block before the next: the ring's copies
// (all `stages` slots at the block's start, then each slot's next stage
// once its tile is reduced), A at the block's start (each group's stage
// above kMaxGroup registers), the eight warps' products, the digits, then
// reduce(block, k, mine, digits, shared) and then(block, k, mine, shared)
// for the block's k-th tile.  `extra`: the kernel's own shared bytes.
template <class Reduce, class Then>
void run(const wsum::Source& s, int extra, long long grid, Reduce&& reduce, Then&& then) {
    const wsum::Ring l = wsum::ring(s.regs, extra);
    std::vector<uint8_t> shared(wsum::shared_bytes(l));
    uint8_t* const a_s = shared.data() + wsum::a_at(l);
    uint8_t* const b_s = shared.data() + wsum::ring_at(l);
    std::vector<Acc> acc(8);
    for (long long block = 0; block < grid; ++block) {
        const long long mine = wsum::block_tiles(wsum::tiles(s), block, grid);
        wsum::Cursor in{0, 0, 0, 0}, at = in;
        auto issue = [&]() {
            if (in.k < mine) {
                const long long t = block + in.k * grid;
                for (int r = 0; r < wsum::group_regs(s.regs, l.group, in.g); ++r)
                    std::memcpy(b_s + in.slot * l.slot_bytes + wsum::run_offset(r),
                                wsum::run_source(s, l, t, in.g, r), 16 * wsum::run_points(s, t));
            }
            wsum::advance(in, l);
        };
        if (l.groups == 1)
            for (int tid = 0; tid < wsum::kThreads; ++tid) wsum::build_a(s, l, 0, a_s, tid);
        for (int i = 0; i < l.stages; ++i) issue();
        std::memset(acc.data(), 0, acc.size() * sizeof(Acc));
        for (; at.k < mine; wsum::advance(at, l)) {
            if (l.groups > 1)
                for (int tid = 0; tid < wsum::kThreads; ++tid) wsum::build_a(s, l, at.g, a_s, tid);
            for (int w = 0; w < 8; ++w)
                product(l.pitch, wsum::group_regs(s.regs, l.group, at.g), a_s,
                        b_s + at.slot * l.slot_bytes, w & 1, w >> 1, acc[w], wsum::RunB());
            const bool last = at.g == l.groups - 1;
            if (last) {
                uint32_t* const digits = (uint32_t*)(shared.data() + wsum::digits_at(l, at.slot));
                for (int w = 0; w < 8; ++w) store_digits<2>(acc[w], digits, w & 1, w >> 1);
                reduce(block, at.k, mine, (const uint32_t*)digits, shared.data());
            }
            issue();
            if (last) then(block, at.k, mine, shared.data());
        }
    }
}

}  // namespace mma_host
