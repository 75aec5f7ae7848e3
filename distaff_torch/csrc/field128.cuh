// Arithmetic in the 128-bit field M = 2^128 - 45*2^40 + 1, shared by the
// port's CUDA kernels.
//
// The device counterpart of native/field128.h (same unsigned __int128
// formulation, same folding of the high half through R = 2^128 mod M =
// 45*2^40 - 1), and of the in-kernel limb arithmetic of the TPU kernels in
// distaff_tpu/ops/field_pallas.py (_add_limbs, _sub_limbs, _mul_limbs with
// _reduce256_h and _mul_by_r), which spelled the same function out on 16-bit
// halfwords because the TPU has no 64-bit multiply.  Every result is
// canonical (< M), so the kernels agree bit for bit with the JAX package.
//
// Field elements travel as four little-endian uint32 limbs (uint4), the
// layout of the (..., 4) tensors on both sides of the port.
//
// The header also compiles as plain C++ (the qualifiers below vanish), so
// its functions can be checked on a host without a GPU.

#pragma once
#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
struct uint4 { uint32_t x, y, z, w; };
#endif

#define F128_FN __host__ __device__ __forceinline__

namespace f128 {

typedef unsigned __int128 u128;
typedef uint64_t u64;

// M = 2^128 - 45*2^40 + 1
F128_FN u128 modulus() {
    return ((u128)0xFFFFFFFFFFFFFFFFULL << 64) | 0xFFFFD30000000001ULL;
}

// R = 2^128 mod M = 45*2^40 - 1
F128_FN u64 fold_r() { return (45ULL << 40) - 1; }

F128_FN u128 from_limbs(uint4 v) {
    return ((u128)(((u64)v.w << 32) | v.z) << 64) | (((u64)v.y << 32) | v.x);
}

F128_FN uint4 to_limbs(u128 a) {
    u64 lo = (u64)a, hi = (u64)(a >> 64);
    uint4 v;
    v.x = (uint32_t)lo;
    v.y = (uint32_t)(lo >> 32);
    v.z = (uint32_t)hi;
    v.w = (uint32_t)(hi >> 32);
    return v;
}

// a + b for a, b < M: the complement trick keeps the sum inside 128 bits.
F128_FN u128 add(u128 a, u128 b) {
    u128 z = modulus() - b;
    return (a < z) ? a + b : a - z;
}

F128_FN u128 sub(u128 a, u128 b) { return (a < b) ? modulus() - b + a : a - b; }

// 128x128 -> 256-bit product, then two folds of the high half through R and
// a final conditional subtraction: the step that _reduce256_h ends with,
// for results in [M, 2^128).
F128_FN u128 mul(u128 a, u128 b) {
    u64 a0 = (u64)a, a1 = (u64)(a >> 64);
    u64 b0 = (u64)b, b1 = (u64)(b >> 64);

    u128 ll = (u128)a0 * b0;
    u128 lh = (u128)a0 * b1;
    u128 hl = (u128)a1 * b0;
    u128 hh = (u128)a1 * b1;

    u128 mid = lh + hl;                              // may carry into bit 128
    u128 carry_mid = (mid < lh) ? ((u128)1 << 64) : 0;
    u128 lo = ll + (mid << 64);
    u128 carry_lo = (lo < ll) ? 1 : 0;
    u128 hi = hh + (mid >> 64) + carry_mid + carry_lo;

    // first fold: hi * R + lo, with hi * R < 2^174 held as fold_hi:fold_lo
    u64 r = fold_r();
    u64 h0 = (u64)hi, h1 = (u64)(hi >> 64);
    u128 p_ll = (u128)h0 * r;
    u128 p_hl = (u128)h1 * r;                        // < 2^110
    u128 fold_lo = p_ll + (p_hl << 64);
    u128 carry1 = (fold_lo < p_ll) ? 1 : 0;
    u128 fold_hi = (p_hl >> 64) + carry1;

    u128 acc_lo = fold_lo + lo;
    u128 carry2 = (acc_lo < fold_lo) ? 1 : 0;
    u128 acc_hi = fold_hi + carry2;                  // < 2^47

    // second fold: acc_hi * R + acc_lo < 2^128 + 2^93
    u128 res = acc_lo + acc_hi * r;
    if (res < acc_lo) res += r;                      // wrapped past 2^128
    if (res >= modulus()) res -= modulus();
    return res;
}

// base^e by square-and-multiply from the low exponent bit, as
// field_jax.exp_const does (0^0 == 1; zero to any positive power is zero).
F128_FN u128 pow(u128 base, u128 e) {
    u128 result = 1;
    while (e != 0) {
        if (e & 1) result = mul(result, base);
        e >>= 1;
        if (e != 0) base = mul(base, base);
    }
    return result;
}

}  // namespace f128
