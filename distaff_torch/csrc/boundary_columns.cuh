// K10 boundary_columns: step 3's two boundary columns over the evaluation
// domain in one launch, the weighted register sums as one unsigned-byte
// matrix product on the int8 tensor cores.
//
// Replaces the JAX package's distaff_tpu/stark/prover.py::
// _evaluate_boundaries_device with the weighted register sums it runs
// (distaff_tpu/ops/tiles.py::_wsum_tile, weighted_register_sum) and its
// x^b power series.  For each point k < n of D_ev, x = r_ev^k, reading the
// LDE's stride slice lde[r, k stride]:
//
//   i[k] = sum_r w1i_r lde[r] + c1i + x^b (sum_r w2i_r lde[r] + c2i)
//   f[k] = sum_r w1f_r lde[r] + c1f + x^b (sum_r w2f_r lde[r] + c2f)
//
// with the weights and constants of evaluator.boundary_weight_vectors and
// b = b_degree_adj: the combined first- and last-step boundary
// constraints, bit for bit the JAX package's (integer field arithmetic).
//
// The product: the four sums of a tile of 64 points as one unsigned-byte
// matrix product on the int8 tensor cores, A (128 x 16R bytes, the
// weights' Toeplitz byte expansion) by B (the tile's value bytes), then one
// f128::reduce_digits a (point, sum), as wsum_product.cuh sets out (shared
// with K7 and K15): in place of 4R modular multiplies and adds on the CUDA
// cores; the same mma the distaff_tpu/ops/mxu_ntt.py "bigmat" asks of the
// TPU's matrix unit (_bigmat, _matrices, its one _reduce_digits).
//
// Bound on this card at (20, 2^19), point stride 4: the larger of (a) the
// slice's 16R bytes a point read once and the two 16-byte outputs
// written, at 3.35 TB/s (0.055 ms); (b) the int8 product, 2 x 128 x 16R
// byte operations a point, at 1,979 TOP/s (0.022 ms); (c) the epilogue's
// 32-bit instructions (four digit reductions, x^b's table multiply, the
// two x^b products, six adds) at the SM issue width (0.013 ms).  So it is
// bound by bytes; but a 16-byte value every 64 bytes is a poor pattern
// for the card's memory: PyTorch's own copy of the stride-4 slice takes
// about five times (a) (tools/air_probe.py k10 times K10 beside that copy,
// and K10 without its product or epilogue).  The design, for each:
// - (a) The slice is read where it lies, at any point stride, by cp.async
//   (16 bytes a thread, L1 bypassed) into a ring of slots in shared memory:
//   a block loops over tiles (grid-strided, two blocks an SM at R = 20)
//   and keeps the copies of the next stages - 1 tiles in flight while it
//   multiplies and reduces this one's: with one block an SM, however deep
//   its ring, the copies, product and epilogue ran in turn between its
//   barriers.  TMA would take the copies off the threads, but its
//   element strides stop at 8 and the point stride is 2, 4 or more, so
//   cp.async is the general path.
// - (b) Eight warps, warp w computes sum w & 3 over half w >> 2 of the
//   tile's points: per 32-byte k-step it loads its two m16 tiles of A and
//   four n8 tiles of B with ldmatrix.x4 (pitches an odd number of 16-byte
//   units: no bank conflicts) and issues 8 mma.  A is built in shared
//   memory from the (4, R) weights at the start of each block; the
//   weights, like the constants, travel in the __grid_constant__ kernel
//   parameter (at most 8 KB): no upload before the launch.  Above
//   kMaxGroup registers the block loops over register groups and rebuilds
//   A for each (A is 128 x 16R bytes: 40 KB at R = 20, 256 KB at R = 128);
//   the digit sums accumulate across the groups.  wgmma would buy nothing:
//   (b) is under (a).
// - (c) The s32 digit tiles are staged to shared memory over the slot just
//   consumed, and each thread takes one (point, sum): one reduce_digits and
//   its constant; a pair of threads then makes a column's value, x^b from
//   the two small power tables of r_ev^b (tiles._store_factors), one
//   multiply and an add.  The constants are kernel arguments.  Indices are
//   64-bit; the loop keeps its tile, group and slot as counters.
//
// This header compiles as plain C++ too: the tests build A and stage B with
// the same functions, run the product through an emulation of ldmatrix and
// mma.m16n8k32 on the fragment addresses below, and run the epilogue as the
// card does, a block at a time.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "points.cuh"
#include "wsum_product.cuh"

namespace boundary_columns {

using f128::u128;

using Shape = wsum::Shape<4>;           // w1i, w2i, w1f, w2f
constexpr int kThreads = wsum::kThreads;  // eight warps: warp w computes sum w & 3 at half w >> 2
constexpr int kSums = 4;
constexpr int kTile = Shape::kTile;     // 64 points a tile: a (point, sum) a thread in the epilogue
constexpr int kRows = Shape::kRows;     // A's rows: sum s, digit d at 32 s + d
constexpr int kDigitPitch = Shape::kDigitPitch;
constexpr int kMaxGroup = wsum::kMaxGroup;
constexpr int kSharedBytes = wsum::kSharedBytes;
constexpr int kSharedPerSM = wsum::kSharedPerSM;
constexpr int kReserved = wsum::kReserved;
constexpr int kMaxStages = 8;           // B stages: the copies of up to 7 tiles in flight
constexpr int kMaxRegisters = wsum::kMaxRegisters;

struct Args {
    const uint4* lde;        // the point k of register r at r reg_stride + k point_stride
    long long reg_stride;
    long long point_stride;
    int regs;
    long long n;             // points: out[0, n) and out[n, 2n)
    const uint4* xb_lo;      // x^b = xb_lo[k mod 2^log_lo] xb_hi[k >> log_lo]
    const uint4* xb_hi;
    int log_lo;
    uint4 c[4];              // c1i, c2i, c1f, c2f
    uint4* out;              // (2, n): i, then f
    uint4 w[kSums * kMaxRegisters];   // w_(s,r) at s kMaxRegisters + r: w1i, w2i, w1f, w2f
    long long first;         // point k is x^b at first + k: 0 but on a slot of a mesh
};

// Shared memory: A (kRows rows of `pitch` bytes), then a ring of `stages`
// slots, each a tile's B stage (kTile points of `pitch` bytes) and, once
// its product is done, the tile's digits (kDigits rows of kDigitPitch words
// a sum, kSumGap words between sums).  Two blocks share an SM where two
// slots a block fit in half of it (kSharedPerSM, less kReserved a block),
// else one block takes as many as fit in kSharedBytes; at most kMaxStages.
// The registers go in `groups` groups of `group` (the last may be
// shorter); a row of A or B holds a group's 16-byte units, rounded up to a
// 32-byte k-step, plus one unit so that the pitch is an odd number of
// units.
struct Layout {
    int groups, group, pitch, a_bytes, stage_bytes, slot_bytes, stages;
};

F128_FN Layout layout(int regs) {
    Layout l;
    l.groups = wsum::groups_of(regs);
    l.group = wsum::group_of(regs);
    l.pitch = wsum::pitch_of(l.group);
    l.a_bytes = kRows * l.pitch;
    l.stage_bytes = kTile * l.pitch;
    l.slot_bytes = l.stage_bytes > Shape::kDigitBytes ? l.stage_bytes : Shape::kDigitBytes;
    l.stages = (kSharedPerSM / 2 - kReserved - l.a_bytes) / l.slot_bytes;
    if (l.stages < 2) l.stages = (kSharedBytes - l.a_bytes) / l.slot_bytes;
    if (l.stages > kMaxStages) l.stages = kMaxStages;
    return l;
}

F128_FN int shared_bytes(const Layout& l) { return l.a_bytes + l.stages * l.slot_bytes; }

F128_FN long long tiles(const Args& a) { return (a.n + kTile - 1) / kTile; }

// A block's stages (tile, group), in order: its tiles first + t stride, each
// group of registers of each tile, the stage's slot in the ring of B stages
struct Cursor {
    long long tile;
    int g, slot;
};

F128_FN void advance(Cursor& c, const Layout& l, long long stride) {
    if (++c.g == l.groups) {
        c.g = 0;
        c.tile += stride;
    }
    if (++c.slot == l.stages) c.slot = 0;
}

// registers in group g
F128_FN int group_regs(const Args& a, const Layout& l, int g) {
    return wsum::group_regs(a.regs, l.group, g);
}

// A for group g into a_s (wsum::build_a over the group's weights of the four
// sums, from the kernel parameter)
F128_FN void build_a(const Args& a, const Layout& l, int g, uint8_t* a_s, int tid) {
    const uint4* const w[kSums] = {a.w + g * l.group, a.w + kMaxRegisters + g * l.group,
                                   a.w + 2 * kMaxRegisters + g * l.group,
                                   a.w + 3 * kMaxRegisters + g * l.group};
    wsum::build_a<kSums>(w, group_regs(a, l, g), l.pitch, a_s, tid);
}

// The values of group g at tile `tile`'s points into a B stage, one
// 16-byte copy each (cp.async on the card): copy i of the copies() puts
// src at byte dst of the stage, point p's register r at p pitch + 16 r,
// consecutive copies on consecutive points.  Points past n read point n - 1
// (their columns are not stored).
F128_FN int copies(const Args& a, const Layout& l, int g) { return kTile * group_regs(a, l, g); }

F128_FN const uint4* stage_copy(const Args& a, const Layout& l, long long tile, int g, int i,
                                int& dst) {
    const int p = i % kTile, r = i / kTile;
    long long k = tile * kTile + p;
    if (k >= a.n) k = a.n - 1;
    dst = p * l.pitch + 16 * r;
    return a.lde + (long long)(g * l.group + r) * a.reg_stride + k * a.point_stride;
}

// B's two n8 tiles at points p0 and p0 + 8 of a point-major stage, k-step
// kk: matrices (p0, bytes 0-15), (p0, 16-31), (p0 + 8, 0-15), (p0 + 8,
// 16-31), b0 and b1 of each (ldmatrix.x4's rows as wsum::a_offset says);
// the offset in bytes of lane `lane`'s row
struct PointB {
    int pitch;
    F128_FN int operator()(int p0, int kk, int lane) const {
        const int j = lane >> 3;
        return (p0 + (lane & 7) + 8 * (j >> 1)) * pitch + 32 * kk + 16 * (j & 1);
    }
};

// The epilogue: thread tid takes sum s = 2 (tid >> 7) + (tid & 1) at point
// p = (tid >> 1) mod kTile, S_s + c_s from its digits; the pair of threads
// 2 j, 2 j + 1 holds the base and the x^b term of a column (tid >> 7 = 0:
// i, 1: f), and the even one stores base + x^b adj.
F128_FN u128 sum_value(const Args& a, const uint32_t* digits, int tid) {
    const int s = 2 * (tid >> 7) + (tid & 1), p = (tid >> 1) % kTile;
    return f128::add(f128::reduce_digits(digits + Shape::digit_at(s, 0, p), kDigitPitch),
                     f128::from_limbs(a.c[s]));
}

F128_FN void finish(const Args& a, long long tile, int tid, u128 base, u128 adj) {
    const long long k = tile * kTile + (tid >> 1) % kTile;
    if (k >= a.n) return;
    const u128 xb = points::table_power(a.xb_lo, a.xb_hi, a.log_lo, a.first + k);
    a.out[(tid >> 7) * a.n + k] = f128::to_limbs(f128::add(base, f128::mul(xb, adj)));
}

}  // namespace boundary_columns
