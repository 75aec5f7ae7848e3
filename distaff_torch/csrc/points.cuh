// Reads of points and powers shared by K7 (deep_compose), K9 (fri_fold) and
// K10 (boundary_columns): read-only and streaming loads, a power of a root
// from two small tables, and K7's weighted register sums over points of an
// (R, D) LDE.  Compiles as plain C++ too, like field128.cuh.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace points {

using f128::u128;

F128_FN uint4 load_ro(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

F128_FN uint4 load_stream(const uint4* p) {
#ifdef __CUDA_ARCH__
    return __ldcs(p);
#else
    return *p;
#endif
}

// c w^e = lo[e mod 2^log_lo] hi[e >> log_lo] (the tables K1 keeps for the
// NTT, ops/tiles._store_factors); lo alone where hi is null
F128_FN u128 table_power(const uint4* lo, const uint4* hi, int log_lo, long long e) {
    const u128 low = f128::from_limbs(load_ro(lo + (e & ((1LL << log_lo) - 1))));
    return hi ? f128::mul(low, f128::from_limbs(load_ro(hi + (e >> log_lo)))) : low;
}

// acc[s][k] = sum_r w[s][r] lde[r reg_stride + at[k]] for each point k that
// is valid (0 for the others): each register's value is read once, streaming,
// for all kSums sums.  w: the weights of each sum (shared memory on the card,
// read as broadcasts).
template <int kSums, int kPoints>
F128_FN void weighted_sums(const uint4* lde, long long reg_stride, int regs,
                           const uint4* const (&w)[kSums], const long long (&at)[kPoints],
                           const bool (&valid)[kPoints], u128 (&acc)[kSums][kPoints]) {
#pragma unroll
    for (int s = 0; s < kSums; ++s)
#pragma unroll
        for (int k = 0; k < kPoints; ++k) acc[s][k] = 0;
    for (int r = 0; r < regs; ++r) {
        u128 c[kSums];
#pragma unroll
        for (int s = 0; s < kSums; ++s) c[s] = f128::from_limbs(w[s][r]);
        const uint4* row = lde + (long long)r * reg_stride;
#pragma unroll
        for (int k = 0; k < kPoints; ++k) {
            if (valid[k]) {
                const u128 v = f128::from_limbs(load_stream(row + at[k]));
#pragma unroll
                for (int s = 0; s < kSums; ++s) acc[s][k] = f128::add(acc[s][k], f128::mul(c[s], v));
            }
        }
    }
}

}  // namespace points
