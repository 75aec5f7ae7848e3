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
// Bound on this card (R = 20): bytes, 16R + 32 a coefficient (0.441 ms at
// (20, 2^22)), over the int8 product (2 x 64 x 16R byte operations a
// coefficient) and the two digit reductions.  On the CUDA cores its 2R
// multiplies a coefficient bound it (1.32 ms).  The design is K7's sums
// alone: wsum_product.cuh's ring of bulk copies, one a (register, tile)
// run, and its byte-limb product on the int8 tensor cores; each thread
// then reduces one (sum, coefficient) of the tile from its digits and
// stores it, a warp's 32 consecutive coefficients of one sum.  Offsets are
// 64-bit; coefficients at N or beyond are read by no copy and not written.
// On the card (tools/air_probe.py k15, PERF.md) it takes 0.51-0.53 ms at
// (20, 2^22), its copies alone 0.44 ms; cp.async copies or one block an SM
// are slower.
//
// Compiles as plain C++ too: the CPU tests run the ring and the product (an
// emulation of ldmatrix and mma) and `store` a block and a thread at a time
// against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "wsum_product.cuh"

namespace coeff_wsum {

constexpr int kThreads = wsum::kThreads;
constexpr int kTile = wsum::Pair::kTile;
constexpr int kMaxRegisters = wsum::kMaxRegisters;

struct Args {
    wsum::Source polys;     // register r's coefficient i at base[r reg_stride + i], n a register
    uint4* out;             // (2, n): the two sums
};

// Thread tid's sum at tile t's coefficient, from the tile's digits
F128_FN void store(const Args& a, long long t, const uint32_t* digits, int tid) {
    const long long i = t * kTile + wsum::point_of(tid);
    if (i < a.polys.n)
        a.out[wsum::sum_of(tid) * a.polys.n + i] = f128::to_limbs(wsum::reduce(digits, tid));
}

}  // namespace coeff_wsum
