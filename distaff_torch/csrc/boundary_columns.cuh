// K10 boundary_columns: step 3's two boundary columns over the evaluation
// domain in one launch.
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
// Bound on this card: operations (4R + 3 multiplies and 4R + 2 adds a
// point; at (20, 2^19) ~0.10 ms), the stride-4 reads about alike (each
// 16-byte value in its own 32-byte sector).  The design, K7's numerators
// phase (deep_compose.cuh) with four sums instead of two:
// - The slice is read where it lies, a warp's lanes on consecutive points,
//   each register's value once, streaming, for all four sums
//   (points.cuh's weighted_sums, which K7 shares); the (4, R) weights sit
//   in shared memory and are read as broadcasts.
// - x^b comes from the two small power tables of r_ev^b (tiles.
//   _store_factors), one multiply a point, no power series.
// - The four constants are kernel arguments.
// - One point a thread, 256 threads with launch bounds for 4 blocks an SM
//   (K7's 64 registers).  Indices are 64-bit.
//
// This header compiles as plain C++ too: the tests run column() a point at
// a time against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "points.cuh"

namespace boundary_columns {

using f128::u128;

constexpr int kThreads = 256;
constexpr int kMaxRegisters = 128;       // config.MAX_REGISTER_COUNT

struct Args {
    const uint4* lde;        // the point k of register r at r reg_stride + k point_stride
    long long reg_stride;
    long long point_stride;
    int regs;
    long long n;             // points: out[0, n) and out[n, 2n)
    const uint4* weights;    // (4, regs): w1i, w2i, w1f, w2f
    const uint4* xb_lo;      // x^b = xb_lo[k mod 2^log_lo] xb_hi[k >> log_lo]
    const uint4* xb_hi;
    int log_lo;
    uint4 c[4];              // c1i, c2i, c1f, c2f
    uint4* out;              // (2, n): i, then f
};

// The kernel's first phase: thread tid's share of the (4, regs) weights
// into shared memory, sum s at s kMaxRegisters.
F128_FN void stage_weights(const Args& a, uint4* shared, int tid) {
    for (int r = tid; r < 4 * a.regs; r += kThreads)
        shared[(r / a.regs) * kMaxRegisters + r % a.regs] = a.weights[r];
}

// Point k of both columns.  w: the four weight vectors, w[s][r].
F128_FN void column(const Args& a, const uint4* const (&w)[4], long long k) {
    const long long at[1] = {k * a.point_stride};
    const bool valid[1] = {true};
    u128 acc[4][1];
    points::weighted_sums<4, 1>(a.lde, a.reg_stride, a.regs, w, at, valid, acc);
    const u128 xb = points::table_power(a.xb_lo, a.xb_hi, a.log_lo, k);
#pragma unroll
    for (int col = 0; col < 2; ++col) {
        const u128 base = f128::add(acc[2 * col][0], f128::from_limbs(a.c[2 * col]));
        const u128 adj = f128::add(acc[2 * col + 1][0], f128::from_limbs(a.c[2 * col + 1]));
        a.out[col * a.n + k] = f128::to_limbs(f128::add(base, f128::mul(xb, adj)));
    }
}

F128_FN long long blocks(const Args& a) { return (a.n + kThreads - 1) / kThreads; }

}  // namespace boundary_columns
