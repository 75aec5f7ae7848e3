// K1 ntt_pass: one pass of the four-step NTT, a batch of natural-order
// transforms of size m = 2^log_m <= 2048 over strided columns.
//
// Replaces the TPU kernel distaff_tpu/ops/field_pallas.py::_leaf_ntt_kernel
// (launched by _leaf_ntt_planes, wrapped by leaf_ntt_bm) together with the
// four-step glue around it (the transposes, the twiddle table and its
// multiply of distaff_tpu/ops/tiles.py): ops/tiles.ntt_batched runs an NTT of
// n <= 2048 * 2048 points as two launches of this kernel and nothing else.
//
// Geometry.  Point k of transform (b, t), b < batch and t < 2^log_cols, is
// in[b * in_bs + t * in_cs + k * in_ps] (strides in 16-byte elements, 64-bit);
// a point whose offset in its batch row, t * in_cs + k * in_ps, is n_in or
// more is not read and counts as zero (the zero extension of an LDE).
// Output point j goes to out[b * out_bs + t * out_cs + j * out_ps], times
// lo[e mod 2^log_lo] * hi[e >> log_lo] for e = (first + t) * j where lo is
// given (the four-step twiddle w^(k1 * j2) of pass A from two small power
// tables, with the inverse transform's 1/n folded into lo; `first`, 0 but
// on a slot of a mesh, is the global index of column 0, so that a slot's
// columns take their global twiddles: parallel/ntt_sharded.py), times lo[e]
// alone where hi is not.
//
// Bound on this card: operations.  A transform does (m/2) log2(m)
// butterflies (one add, one sub, one 128-bit modular multiply each) against
// 32 bytes of device traffic a point.  The design:
// - A block holds a tile of 4096 points, C = 4096 / m transforms side by
//   side, in 64 KB of dynamic shared memory at [k][c] (point-major, the C
//   columns of a point adjacent): C >= 2, so a pass that reads columns
//   (pass B, and pass A of a zero-extended input) loads C * 16 contiguous
//   bytes a point, whole 32-byte sectors.  The tile comes in with cp.async
//   (zero-filled where the point is not read), so the loads take no
//   registers and all of a thread's 16 are in flight at once.
// - The stages run as in-place decimation-in-frequency rounds in registers:
//   one radix-2 or radix-4 round first where log2(m) is not a multiple of 3,
//   then radix-8 rounds (three stages, 12 butterflies on 8 points a thread).
//   m = 1024 takes 4 rounds and 5 __syncthreads, not 10 round trips.  The
//   result sits at bit-reversed positions; the store reads it back in
//   natural order.
// - The multiply is most of a butterfly and the card's integer multiply
//   pipe is the limit, so multiplies that are not needed are not done: the
//   last round's butterflies with twiddle 1 (7 of 12) only add and
//   subtract, and where the input is zero extended a butterfly of two
//   zeros is skipped (an LDE's pass A reads 1/32 of its points: its first
//   stages shrink to the nonzero ones).
// - Shared-memory addresses are XOR-swizzled (swz) so that the 8 threads of
//   a quarter warp, which share one 128-byte wavefront of 16-byte accesses,
//   hit 8 different bank groups in every round, the radix-8 round over
//   adjacent points (q = 1) included, and in the loads and the bit-reversed
//   stores, for every C.
// - 256 threads a block, 3 blocks an SM (24 warps): launch bounds that
//   cap the registers at 85 (ptxas: 78, no spills), and 3 x 64 KB of
//   shared memory; 3% faster than 2 blocks at 98 registers (PERF.md).
//   Twiddles are read through the read-only cache (__ldg) from the power
//   series of the root (m/2 entries).
//
// This header compiles as plain C++ too (field128.cuh's qualifiers vanish):
// the tests run the same load, round and store code on the CPU, a block and
// a thread at a time, against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace ntt_pass {

constexpr int kLogTile = 12;
constexpr int kTilePoints = 1 << kLogTile;
constexpr int kThreads = 256;
constexpr int kMaxLogM = 11;

struct Args {
    const uint4* in;
    uint4* out;
    const uint4* tw;     // (m/2) powers of the size-m root
    const uint4* lo;     // store factor table, or null
    const uint4* hi;     // second store factor table, or null
    long long batch;
    long long in_bs, in_cs, in_ps, n_in;
    long long out_bs, out_cs, out_ps;
    int log_cols, log_m, log_lo;
    bool sparse;         // some points of a column are not read (n_in)
    long long first;     // the global index of column 0 in the store factors' exponent
};

F128_FN Args make_args(const void* in, void* out, const void* tw, const void* lo,
                       const void* hi, long long batch, int log_cols, int log_m,
                       long long in_bs, long long in_cs, long long in_ps, long long n_in,
                       long long out_bs, long long out_cs, long long out_ps, int log_lo,
                       long long first = 0) {
    const long long span = ((1LL << log_cols) - 1) * in_cs + ((1LL << log_m) - 1) * in_ps + 1;
    return Args{(const uint4*)in, (uint4*)out, (const uint4*)tw, (const uint4*)lo,
                (const uint4*)hi, batch, in_bs, in_cs, in_ps, n_in, out_bs, out_cs, out_ps,
                log_cols, log_m, log_lo, n_in < span, first};
}

// The 16-byte slot of tile index s: its low 3 bits (the slot in a 128-byte
// row) XOR the three 3-bit groups above them.  Any 8 indices that differ
// only in 3 adjacent bits fall into 8 different slots, which covers every
// access pattern here (a simulation of each round, load and store at every
// m found no conflict).
F128_FN int swz(int s) { return s ^ (((s >> 3) ^ (s >> 6) ^ (s >> 9)) & 7); }

F128_FN uint4 load_ro(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

F128_FN uint4 mul_elems(uint4 a, uint4 b) {
    return f128::to_limbs(f128::mul(f128::from_limbs(a), f128::from_limbs(b)));
}

// (a, b) <- (a + b, a - b)
F128_FN void add_sub(uint4& a, uint4& b) {
    f128::u128 x = f128::from_limbs(a), y = f128::from_limbs(b);
    a = f128::to_limbs(f128::add(x, y));
    b = f128::to_limbs(f128::sub(x, y));
}

// (a, b) <- (a + b, (a - b) w)
F128_FN void butterfly(uint4& a, uint4& b, uint4 w) {
    f128::u128 x = f128::from_limbs(a), y = f128::from_limbs(b);
    a = f128::to_limbs(f128::add(x, y));
    b = f128::to_limbs(f128::mul(f128::sub(x, y), f128::from_limbs(w)));
}

F128_FN int bitrev(int j, int bits) {
#ifdef __CUDA_ARCH__
    return (int)(__brev((unsigned)j) >> (32 - bits));
#else
    int r = 0;
    for (int i = 0; i < bits; ++i) r |= ((j >> i) & 1) << (bits - 1 - i);
    return r;
#endif
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
F128_FN void copy16(uint4* dst, const uint4* src, bool valid) {
#ifdef __CUDA_ARCH__
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
#else
    *dst = valid ? *src : uint4{0, 0, 0, 0};
#endif
}

// Radix of the next round when `rem` stages are left: the odd stages first,
// then rounds of three.
F128_FN int round_stages(int rem) { return rem % 3 ? rem % 3 : 3; }

// Thread `tid`'s share of bringing block `block`'s tile in.
F128_FN void load_tile(const Args& p, uint4* tile, long long block, int tid) {
    const int log_c = kLogTile - p.log_m;
    const long long cols = p.batch << p.log_cols;
    for (int l = tid; l < kTilePoints; l += kThreads) {
        int c, k;
        if (p.in_ps == 1) {                       // rows: a transform's points adjacent
            c = l >> p.log_m;
            k = l & ((1 << p.log_m) - 1);
        } else {                                  // columns: a point's transforms adjacent
            k = l >> log_c;
            c = l & ((1 << log_c) - 1);
        }
        const long long g = (block << log_c) + c;
        const long long t = g & ((1LL << p.log_cols) - 1);
        const long long off = t * p.in_cs + k * p.in_ps;
        const bool valid = g < cols && off < p.n_in;
        const uint4* src = valid ? p.in + (g >> p.log_cols) * p.in_bs + off : p.in;
        copy16(&tile[swz((k << log_c) + c)], src, valid);
    }
}

F128_FN bool is_zero(uint4 v) { return (v.x | v.y | v.z | v.w) == 0; }

// One in-place DIF round of LOGR stages, spans q 2^(LOGR-1) down to q: a
// unit is the R points i0 + j q (j < R) of one column, i0 = g R q + r.
// UNIT (q = 1, so r = 0): the first butterfly of each group has twiddle 1
// and no multiply, 7 of the round's 12 at radix 8.  SPARSE (a zero-extended
// input): a butterfly of two zeros is skipped, which prunes the first
// stages of an LDE's pass A to its nonzero points.
template <int LOGR, bool UNIT, bool SPARSE>
F128_FN void dif_round(const Args& p, uint4* tile, int tid, int log_q) {
    constexpr int R = 1 << LOGR;
    const int log_c = kLogTile - p.log_m;
    for (int u = tid; u < (kTilePoints >> LOGR); u += kThreads) {
        const int c = u & ((1 << log_c) - 1);
        const int rest = u >> log_c;
        const int r = rest & ((1 << log_q) - 1);
        const int i0 = ((rest >> log_q) << (LOGR + log_q)) + r;
        uint4 x[R];
#pragma unroll
        for (int j = 0; j < R; ++j) x[j] = tile[swz(((i0 + (j << log_q)) << log_c) + c)];
#pragma unroll
        for (int s = 0; s < LOGR; ++s) {
            const int d = R >> (s + 1);                      // pair distance in the unit
            const int log_h = log_q + LOGR - 1 - s;          // span of this stage
            // twiddle of point i: W^((i mod h) m / (2h)), i mod h = r + (j mod d) q
            uint4 w[R / 2];
#pragma unroll
            for (int jj = UNIT ? 1 : 0; jj < d; ++jj)
                w[jj] = load_ro(p.tw + ((r + (jj << log_q)) << (p.log_m - 1 - log_h)));
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (j & d) continue;
                if (SPARSE && is_zero(x[j]) && is_zero(x[j + d])) continue;
                if (UNIT && (j & (d - 1)) == 0) add_sub(x[j], x[j + d]);
                else butterfly(x[j], x[j + d], w[j & (d - 1)]);
            }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) tile[swz(((i0 + (j << log_q)) << log_c) + c)] = x[j];
    }
}

template <int LOGR, bool SPARSE>
F128_FN void dif_round_q(const Args& p, uint4* tile, int tid, int log_q) {
    if (log_q == 0) dif_round<LOGR, true, SPARSE>(p, tile, tid, 0);
    else dif_round<LOGR, false, SPARSE>(p, tile, tid, log_q);
}

template <bool SPARSE>
F128_FN void dif_round_r(const Args& p, uint4* tile, int tid, int stages, int log_q) {
    if (stages == 3) dif_round_q<3, SPARSE>(p, tile, tid, log_q);
    else if (stages == 2) dif_round_q<2, SPARSE>(p, tile, tid, log_q);
    else dif_round_q<1, SPARSE>(p, tile, tid, log_q);
}

// The round of `stages` stages whose smallest span is 2^log_q.
F128_FN void round_dispatch(const Args& p, uint4* tile, int tid, int stages, int log_q) {
    if (p.sparse) dif_round_r<true>(p, tile, tid, stages, log_q);
    else dif_round_r<false>(p, tile, tid, stages, log_q);
}

// Thread `tid`'s share of writing block `block`'s transforms out.
F128_FN void store_tile(const Args& p, const uint4* tile, long long block, int tid) {
    const int log_c = kLogTile - p.log_m;
    const long long cols = p.batch << p.log_cols;
    for (int l = tid; l < kTilePoints; l += kThreads) {
        int c, j;
        if (p.out_ps == 1) {
            c = l >> p.log_m;
            j = l & ((1 << p.log_m) - 1);
        } else {
            j = l >> log_c;
            c = l & ((1 << log_c) - 1);
        }
        const long long g = (block << log_c) + c;
        if (g >= cols) continue;
        const long long t = g & ((1LL << p.log_cols) - 1);
        uint4 v = tile[swz((bitrev(j, p.log_m) << log_c) + c)];
        if (p.lo) {
            const long long e = (p.first + t) * j;
            uint4 f = load_ro(p.lo + (e & ((1LL << p.log_lo) - 1)));
            if (p.hi) f = mul_elems(f, load_ro(p.hi + (e >> p.log_lo)));
            v = mul_elems(v, f);
        }
        p.out[(g >> p.log_cols) * p.out_bs + t * p.out_cs + j * p.out_ps] = v;
    }
}

// Blocks of one launch: one tile of C = 4096 / m transforms each.
F128_FN long long blocks(const Args& p) {
    const long long per_block = 1LL << (kLogTile - p.log_m);
    return ((p.batch << p.log_cols) + per_block - 1) / per_block;
}

}  // namespace ntt_pass
