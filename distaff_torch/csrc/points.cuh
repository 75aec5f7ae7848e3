// Reads of points and powers shared by K7 (deep_compose), K9 (fri_fold),
// K10 (boundary_columns), K11 (syn_div) and K14 (trace_absorb): read-only
// and streaming loads, and a power of a root from two small tables.
// Compiles as plain C++ too, like field128.cuh.

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

// table_power in two steps, so that the loads can be issued ahead of the
// multiply: the two entries of c w^e, then their product
struct Entries {
    uint4 lo, hi;
};

F128_FN Entries table_entries(const uint4* lo, const uint4* hi, int log_lo, long long e) {
    Entries t;
    t.lo = load_ro(lo + (e & ((1LL << log_lo) - 1)));
    t.hi = hi ? load_ro(hi + (e >> log_lo)) : t.lo;
    return t;
}

F128_FN u128 entries_power(const Entries& t, const uint4* hi) {
    const u128 low = f128::from_limbs(t.lo);
    return hi ? f128::mul(low, f128::from_limbs(t.hi)) : low;
}

}  // namespace points
