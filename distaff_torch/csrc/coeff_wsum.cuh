// K15 coeff_wsum: the two weighted register sums of step 6 in coefficient
// space, sum_r w1_r T_r and sum_r w2_r T_r over the (R, N) coefficients of
// the trace's polynomials, in one launch.
//
// Replaces the JAX package's distaff_tpu/ops/tiles.py::weighted_register_sum
// (with its _wsum_tile) on the polynomials, as the streaming prover calls it
// twice (distaff_tpu/stark/prover.py::_build_composition_evaluations): a
// weighted sum commutes with the NTT, so A1 and A2 over the LDE domain are
// the NTTs of these two columns, and the (R, D) LDE that K7 would read is
// never needed.
//
// Bound on this card: bytes and operations about alike (R = 20: 16R + 32
// bytes and 2R multiplies a point).  The design is K7's: a thread's points
// at tile offsets k kThreads + tid, so each register's loads are coalesced
// and streaming; the (R, 4) weights of both sums in shared memory, read as
// broadcasts; both sums from one read of each value (points.cuh's
// weighted_sums).  Offsets are 64-bit.
//
// Compiles as plain C++ too: the CPU tests run `points_of` a block and a
// thread at a time against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "points.cuh"

namespace coeff_wsum {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxRegisters = 128;       // config.MAX_REGISTER_COUNT

struct Args {
    const uint4* polys;     // register r's coefficient i at polys[r * reg_stride + i]
    long long reg_stride;   // in 16-byte units
    int regs;
    long long n;            // coefficients a register
    const uint4* w1;        // (R, 4) weights of each sum
    const uint4* w2;
    uint4* out;             // (2, n): the two sums
};

F128_FN long long blocks(const Args& a) { return (a.n + kTile - 1) / kTile; }

// Thread `thread` of block `block`: its points' two sums, with the weights
// read from w1s and w2s (shared memory on the card).
F128_FN void points_of(const Args& a, long long block, int thread, const uint4* w1s,
                       const uint4* w2s) {
    long long at[kPerThread];
    bool valid[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        at[k] = block * kTile + k * kThreads + thread;
        valid[k] = at[k] < a.n;
    }
    const uint4* const w[2] = {w1s, w2s};
    f128::u128 acc[2][kPerThread];
    points::weighted_sums<2, kPerThread>(a.polys, a.reg_stride, a.regs, w, at, valid, acc);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        if (valid[k]) {
            a.out[at[k]] = f128::to_limbs(acc[0][k]);
            a.out[a.n + at[k]] = f128::to_limbs(acc[1][k]);
        }
    }
}

}  // namespace coeff_wsum
