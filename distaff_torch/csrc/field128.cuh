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
// reduce_digits takes a sum of byte-limb products (K10's int8 tensor-core
// product, boundary_columns.cuh) back to the field: 31 digits of weight
// 2^(8d), reassembled and reduced once.
//
// On the card the multiply is PTX on four 32-bit limbs (mul_limbs below), a
// carry chain that the compiled u128 formulation is slower than (K2's
// exp_const and K4 on the card, PERF.md).  The header also compiles as
// plain C++ (the qualifiers below vanish, and mul takes the portable u128
// code), so its functions can be checked on a host without a GPU; the CPU
// tests also run the PTX text of mul_limbs and of sqr_limbs (the squaring
// of K2's exp_const, 10 limb products in place of 16) through an
// interpreter of their instructions.

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

#ifdef __CUDA_ARCH__
// The device multiply on 32-bit limbs, a = a0 + 2^32 a1 + ..., in one carry
// chain: the 256-bit product p one row of b's limbs at a time (the low
// halves of a row's four partial products, then the high halves, each pass
// one mad.cc/madc chain), then the folds of mul's host code with R = 2^128
// mod M = 0x2CFF_FFFFFFFF as two limbs: t = p_lo + p_hi R < 2^175, u =
// t_lo + t_hi R < 2^128 + 2^93, u_lo + R where u carried into bit 128 (u_lo
// < 2^93 then, so this cannot carry), and the subtraction of M unless it
// borrows.  Operands: %0-%3 the result, %4-%7 a, %8-%11 b.
__device__ __forceinline__ uint4 mul_limbs(uint4 a, uint4 b) {
    uint4 r;
    asm("{\n\t"
        ".reg .u32 a0, a1, a2, a3, b0, b1, b2, b3;\n\t"
        ".reg .u32 p0, p1, p2, p3, p4, p5, p6, p7;\n\t"
        ".reg .u32 t0, t1, t2, t3, t4, t5, u0, u1, u2, u3, u4;\n\t"
        ".reg .u32 d0, d1, d2, d3, bw;\n\t"
        ".reg .pred under;\n\t"
        "mov.b32 a0, %4;\n\t"
        "mov.b32 a1, %5;\n\t"
        "mov.b32 a2, %6;\n\t"
        "mov.b32 a3, %7;\n\t"
        "mov.b32 b0, %8;\n\t"
        "mov.b32 b1, %9;\n\t"
        "mov.b32 b2, %10;\n\t"
        "mov.b32 b3, %11;\n\t"
        // row 0: p[0..5) = a * b0
        "mul.lo.u32 p0, a0, b0;\n\t"
        "mul.lo.u32 p1, a1, b0;\n\t"
        "mul.lo.u32 p2, a2, b0;\n\t"
        "mul.lo.u32 p3, a3, b0;\n\t"
        "mad.hi.cc.u32 p1, a0, b0, p1;\n\t"
        "madc.hi.cc.u32 p2, a1, b0, p2;\n\t"
        "madc.hi.cc.u32 p3, a2, b0, p3;\n\t"
        "madc.hi.u32 p4, a3, b0, 0;\n\t"
        // row 1: p[1..6) += a * b1
        "mad.lo.cc.u32 p1, a0, b1, p1;\n\t"
        "madc.lo.cc.u32 p2, a1, b1, p2;\n\t"
        "madc.lo.cc.u32 p3, a2, b1, p3;\n\t"
        "madc.lo.cc.u32 p4, a3, b1, p4;\n\t"
        "addc.u32 p5, 0, 0;\n\t"
        "mad.hi.cc.u32 p2, a0, b1, p2;\n\t"
        "madc.hi.cc.u32 p3, a1, b1, p3;\n\t"
        "madc.hi.cc.u32 p4, a2, b1, p4;\n\t"
        "madc.hi.u32 p5, a3, b1, p5;\n\t"
        // row 2: p[2..7) += a * b2
        "mad.lo.cc.u32 p2, a0, b2, p2;\n\t"
        "madc.lo.cc.u32 p3, a1, b2, p3;\n\t"
        "madc.lo.cc.u32 p4, a2, b2, p4;\n\t"
        "madc.lo.cc.u32 p5, a3, b2, p5;\n\t"
        "addc.u32 p6, 0, 0;\n\t"
        "mad.hi.cc.u32 p3, a0, b2, p3;\n\t"
        "madc.hi.cc.u32 p4, a1, b2, p4;\n\t"
        "madc.hi.cc.u32 p5, a2, b2, p5;\n\t"
        "madc.hi.u32 p6, a3, b2, p6;\n\t"
        // row 3: p[3..8) += a * b3
        "mad.lo.cc.u32 p3, a0, b3, p3;\n\t"
        "madc.lo.cc.u32 p4, a1, b3, p4;\n\t"
        "madc.lo.cc.u32 p5, a2, b3, p5;\n\t"
        "madc.lo.cc.u32 p6, a3, b3, p6;\n\t"
        "addc.u32 p7, 0, 0;\n\t"
        "mad.hi.cc.u32 p4, a0, b3, p4;\n\t"
        "madc.hi.cc.u32 p5, a1, b3, p5;\n\t"
        "madc.hi.cc.u32 p6, a2, b3, p6;\n\t"
        "madc.hi.u32 p7, a3, b3, p7;\n\t"
        // first fold: t = p[0..4) + p[4..8) * R, R's low limb then its high one
        "mad.lo.cc.u32 t0, p4, 0xFFFFFFFFU, p0;\n\t"
        "madc.lo.cc.u32 t1, p5, 0xFFFFFFFFU, p1;\n\t"
        "madc.lo.cc.u32 t2, p6, 0xFFFFFFFFU, p2;\n\t"
        "madc.lo.cc.u32 t3, p7, 0xFFFFFFFFU, p3;\n\t"
        "addc.u32 t4, 0, 0;\n\t"
        "mad.hi.cc.u32 t1, p4, 0xFFFFFFFFU, t1;\n\t"
        "madc.hi.cc.u32 t2, p5, 0xFFFFFFFFU, t2;\n\t"
        "madc.hi.cc.u32 t3, p6, 0xFFFFFFFFU, t3;\n\t"
        "madc.hi.cc.u32 t4, p7, 0xFFFFFFFFU, t4;\n\t"
        "addc.u32 t5, 0, 0;\n\t"
        "mad.lo.cc.u32 t1, p4, 0x2CFFU, t1;\n\t"
        "madc.lo.cc.u32 t2, p5, 0x2CFFU, t2;\n\t"
        "madc.lo.cc.u32 t3, p6, 0x2CFFU, t3;\n\t"
        "madc.lo.cc.u32 t4, p7, 0x2CFFU, t4;\n\t"
        "addc.u32 t5, t5, 0;\n\t"
        "mad.hi.cc.u32 t2, p4, 0x2CFFU, t2;\n\t"
        "madc.hi.cc.u32 t3, p5, 0x2CFFU, t3;\n\t"
        "madc.hi.cc.u32 t4, p6, 0x2CFFU, t4;\n\t"
        "madc.hi.u32 t5, p7, 0x2CFFU, t5;\n\t"
        // second fold: u = t[0..4) + (t4 + 2^32 t5) * R, u4 the carry into bit 128
        "mad.lo.cc.u32 u0, t4, 0xFFFFFFFFU, t0;\n\t"
        "madc.hi.cc.u32 u1, t4, 0xFFFFFFFFU, t1;\n\t"
        "madc.hi.cc.u32 u2, t4, 0x2CFFU, t2;\n\t"
        "addc.cc.u32 u3, t3, 0;\n\t"
        "addc.u32 u4, 0, 0;\n\t"
        "mad.lo.cc.u32 u1, t4, 0x2CFFU, u1;\n\t"
        "madc.hi.cc.u32 u2, t5, 0xFFFFFFFFU, u2;\n\t"
        "addc.cc.u32 u3, u3, 0;\n\t"
        "addc.u32 u4, u4, 0;\n\t"
        "mad.lo.cc.u32 u1, t5, 0xFFFFFFFFU, u1;\n\t"
        "madc.lo.cc.u32 u2, t5, 0x2CFFU, u2;\n\t"
        "addc.cc.u32 u3, u3, 0;\n\t"
        "addc.u32 u4, u4, 0;\n\t"
        // third fold: u += u4 * R
        "mad.lo.cc.u32 u0, u4, 0xFFFFFFFFU, u0;\n\t"
        "madc.lo.cc.u32 u1, u4, 0x2CFFU, u1;\n\t"
        "addc.cc.u32 u2, u2, 0;\n\t"
        "addc.u32 u3, u3, 0;\n\t"
        // u - M unless that borrows; M = 0xFFFFFFFF_FFFFFFFF_FFFFD300_00000001
        "sub.cc.u32 d0, u0, 0x00000001U;\n\t"
        "subc.cc.u32 d1, u1, 0xFFFFD300U;\n\t"
        "subc.cc.u32 d2, u2, 0xFFFFFFFFU;\n\t"
        "subc.cc.u32 d3, u3, 0xFFFFFFFFU;\n\t"
        "subc.u32 bw, 0, 0;\n\t"
        "setp.ne.u32 under, bw, 0;\n\t"
        "selp.b32 %0, u0, d0, under;\n\t"
        "selp.b32 %1, u1, d1, under;\n\t"
        "selp.b32 %2, u2, d2, under;\n\t"
        "selp.b32 %3, u3, d3, under;\n\t"
        "}"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w));
    return r;
}

// The device squaring, a^2 mod M in one carry chain: 10 limb products in
// place of mul_limbs' 16.  The 6 cross products a_i a_j (i < j) are summed
// once (p1-p6: a0 a_j, then a1 a_j, then a2 a3; the sum is below 2^224, so
// no row carries out of its last limb), the sum is doubled by carried adds,
// and the 4 squares a_i^2 are added on the diagonal; then the folds of
// mul_limbs, unchanged.  Operands: %0-%3 the result, %4-%7 a.
__device__ __forceinline__ uint4 sqr_limbs(uint4 a) {
    uint4 r;
    asm("{\n\t"
        ".reg .u32 a0, a1, a2, a3;\n\t"
        ".reg .u32 p0, p1, p2, p3, p4, p5, p6, p7;\n\t"
        ".reg .u32 t0, t1, t2, t3, t4, t5, u0, u1, u2, u3, u4;\n\t"
        ".reg .u32 d0, d1, d2, d3, bw;\n\t"
        ".reg .pred under;\n\t"
        "mov.b32 a0, %4;\n\t"
        "mov.b32 a1, %5;\n\t"
        "mov.b32 a2, %6;\n\t"
        "mov.b32 a3, %7;\n\t"
        // cross products, row a0: p[1..5) = a0 (a1, a2, a3)
        "mul.lo.u32 p1, a0, a1;\n\t"
        "mul.lo.u32 p2, a0, a2;\n\t"
        "mul.lo.u32 p3, a0, a3;\n\t"
        "mad.hi.cc.u32 p2, a0, a1, p2;\n\t"
        "madc.hi.cc.u32 p3, a0, a2, p3;\n\t"
        "madc.hi.u32 p4, a0, a3, 0;\n\t"
        // row a1: p[3..6) += a1 (a2, a3)
        "mad.lo.cc.u32 p3, a1, a2, p3;\n\t"
        "madc.lo.cc.u32 p4, a1, a3, p4;\n\t"
        "addc.u32 p5, 0, 0;\n\t"
        "mad.hi.cc.u32 p4, a1, a2, p4;\n\t"
        "madc.hi.u32 p5, a1, a3, p5;\n\t"
        // row a2: p[5..7) += a2 a3
        "mad.lo.cc.u32 p5, a2, a3, p5;\n\t"
        "madc.hi.u32 p6, a2, a3, 0;\n\t"
        // twice the cross products
        "add.cc.u32 p1, p1, p1;\n\t"
        "addc.cc.u32 p2, p2, p2;\n\t"
        "addc.cc.u32 p3, p3, p3;\n\t"
        "addc.cc.u32 p4, p4, p4;\n\t"
        "addc.cc.u32 p5, p5, p5;\n\t"
        "addc.cc.u32 p6, p6, p6;\n\t"
        "addc.u32 p7, 0, 0;\n\t"
        // the squares on the diagonal
        "mul.lo.u32 p0, a0, a0;\n\t"
        "mad.hi.cc.u32 p1, a0, a0, p1;\n\t"
        "madc.lo.cc.u32 p2, a1, a1, p2;\n\t"
        "madc.hi.cc.u32 p3, a1, a1, p3;\n\t"
        "madc.lo.cc.u32 p4, a2, a2, p4;\n\t"
        "madc.hi.cc.u32 p5, a2, a2, p5;\n\t"
        "madc.lo.cc.u32 p6, a3, a3, p6;\n\t"
        "madc.hi.u32 p7, a3, a3, p7;\n\t"
        // first fold: t = p[0..4) + p[4..8) * R, R's low limb then its high one
        "mad.lo.cc.u32 t0, p4, 0xFFFFFFFFU, p0;\n\t"
        "madc.lo.cc.u32 t1, p5, 0xFFFFFFFFU, p1;\n\t"
        "madc.lo.cc.u32 t2, p6, 0xFFFFFFFFU, p2;\n\t"
        "madc.lo.cc.u32 t3, p7, 0xFFFFFFFFU, p3;\n\t"
        "addc.u32 t4, 0, 0;\n\t"
        "mad.hi.cc.u32 t1, p4, 0xFFFFFFFFU, t1;\n\t"
        "madc.hi.cc.u32 t2, p5, 0xFFFFFFFFU, t2;\n\t"
        "madc.hi.cc.u32 t3, p6, 0xFFFFFFFFU, t3;\n\t"
        "madc.hi.cc.u32 t4, p7, 0xFFFFFFFFU, t4;\n\t"
        "addc.u32 t5, 0, 0;\n\t"
        "mad.lo.cc.u32 t1, p4, 0x2CFFU, t1;\n\t"
        "madc.lo.cc.u32 t2, p5, 0x2CFFU, t2;\n\t"
        "madc.lo.cc.u32 t3, p6, 0x2CFFU, t3;\n\t"
        "madc.lo.cc.u32 t4, p7, 0x2CFFU, t4;\n\t"
        "addc.u32 t5, t5, 0;\n\t"
        "mad.hi.cc.u32 t2, p4, 0x2CFFU, t2;\n\t"
        "madc.hi.cc.u32 t3, p5, 0x2CFFU, t3;\n\t"
        "madc.hi.cc.u32 t4, p6, 0x2CFFU, t4;\n\t"
        "madc.hi.u32 t5, p7, 0x2CFFU, t5;\n\t"
        // second fold: u = t[0..4) + (t4 + 2^32 t5) * R, u4 the carry into bit 128
        "mad.lo.cc.u32 u0, t4, 0xFFFFFFFFU, t0;\n\t"
        "madc.hi.cc.u32 u1, t4, 0xFFFFFFFFU, t1;\n\t"
        "madc.hi.cc.u32 u2, t4, 0x2CFFU, t2;\n\t"
        "addc.cc.u32 u3, t3, 0;\n\t"
        "addc.u32 u4, 0, 0;\n\t"
        "mad.lo.cc.u32 u1, t4, 0x2CFFU, u1;\n\t"
        "madc.hi.cc.u32 u2, t5, 0xFFFFFFFFU, u2;\n\t"
        "addc.cc.u32 u3, u3, 0;\n\t"
        "addc.u32 u4, u4, 0;\n\t"
        "mad.lo.cc.u32 u1, t5, 0xFFFFFFFFU, u1;\n\t"
        "madc.lo.cc.u32 u2, t5, 0x2CFFU, u2;\n\t"
        "addc.cc.u32 u3, u3, 0;\n\t"
        "addc.u32 u4, u4, 0;\n\t"
        // third fold: u += u4 * R
        "mad.lo.cc.u32 u0, u4, 0xFFFFFFFFU, u0;\n\t"
        "madc.lo.cc.u32 u1, u4, 0x2CFFU, u1;\n\t"
        "addc.cc.u32 u2, u2, 0;\n\t"
        "addc.u32 u3, u3, 0;\n\t"
        // u - M unless that borrows; M = 0xFFFFFFFF_FFFFFFFF_FFFFD300_00000001
        "sub.cc.u32 d0, u0, 0x00000001U;\n\t"
        "subc.cc.u32 d1, u1, 0xFFFFD300U;\n\t"
        "subc.cc.u32 d2, u2, 0xFFFFFFFFU;\n\t"
        "subc.cc.u32 d3, u3, 0xFFFFFFFFU;\n\t"
        "subc.u32 bw, 0, 0;\n\t"
        "setp.ne.u32 under, bw, 0;\n\t"
        "selp.b32 %0, u0, d0, under;\n\t"
        "selp.b32 %1, u1, d1, under;\n\t"
        "selp.b32 %2, u2, d2, under;\n\t"
        "selp.b32 %3, u3, d3, under;\n\t"
        "}"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w));
    return r;
}
#endif

// hi 2^128 + lo mod M for any 256-bit value: two folds of the high half
// through R and a final conditional subtraction, the step that
// _reduce256_h ends with, for results in [M, 2^128).
F128_FN u128 reduce_wide(u128 lo, u128 hi) {
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

// 128x128 -> 256-bit product, then reduce_wide.
F128_FN u128 mul(u128 a, u128 b) {
#ifdef __CUDA_ARCH__
    return from_limbs(mul_limbs(to_limbs(a), to_limbs(b)));
#else
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
    return reduce_wide(lo, hi);
#endif
}

// a^2 mod M: sqr_limbs on the card, the multiply's host code elsewhere.
F128_FN u128 sqr(u128 a) {
#ifdef __CUDA_ARCH__
    return from_limbs(sqr_limbs(to_limbs(a)));
#else
    return mul(a, a);
#endif
}

// The digits of a sum of byte-limb products: a product of two elements
// split into 16 bytes each has 31 digits, digit d the sum of the byte
// products of weight 2^(8d).
constexpr int kDigits = 31;

// sum_d digits[d stride] 2^(8d) mod M over the kDigits digits, each any
// 32-bit value (K10's are below 2^27): the digits re-accumulated into eight
// 32-bit limbs, four digits a limb at shifts 0, 8, 16 and 24 (each limb's
// sum < 2^58 in 64 bits), in one carry sweep; the carry out of limb 7, the
// bits from 2^256 up (< 2^16), folded in as carry R^2 (2^256 = R^2 mod M,
// < 2^107); then the 256-bit value's reduce_wide.  Plain integer code, the
// same on the card and in the host tests.
F128_FN u128 reduce_digits(const uint32_t* digits, int stride) {
    uint32_t limb[8];
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        u64 acc = carry;
#pragma unroll
        for (int b = 0; b < 4; ++b)
            if (4 * j + b < kDigits) acc += (u64)digits[(4 * j + b) * stride] << (8 * b);
        limb[j] = (uint32_t)acc;
        carry = acc >> 32;
    }
    u128 lo = ((u128)(((u64)limb[3] << 32) | limb[2]) << 64) | (((u64)limb[1] << 32) | limb[0]);
    u128 hi = ((u128)(((u64)limb[7] << 32) | limb[6]) << 64) | (((u64)limb[5] << 32) | limb[4]);
    const u128 r2 = (u128)fold_r() * fold_r();
    const u128 top = (u128)carry * r2;
    lo += top;
    if (lo < top && ++hi == 0) lo += r2;   // past 2^256 once more: lo < 2^107 now
    return reduce_wide(lo, hi);
}

// the trailing zero bits of x != 0
F128_FN int trailing_zeros(u128 x) {
    const u64 lo = (u64)x, hi = (u64)(x >> 64);
#ifdef __CUDA_ARCH__
    return lo ? __ffsll((long long)lo) - 1 : 63 + __ffsll((long long)hi);
#else
    return lo ? __builtin_ctzll(lo) : 64 + __builtin_ctzll(hi);
#endif
}

// a^(-1) mod M (0 for 0) by Kaliski's almost Montgomery inverse, for the
// one thread that inverts a block's product (K6, K7).  The loop keeps M =
// u s + v r (so r, s < M) and a r = -u 2^k, a s = v 2^k (mod M), with u
// and v odd: each step subtracts the smaller of the two from the larger
// and shifts out the difference's trailing zeros (Kaliski's halvings of
// one bit a step, merged), doubling r or s as often: no modular halving,
// 73-105 steps, until u = v = 1.  Then M - r = a^(-1) 2^k, and the 2^k
// comes out 32 bits at a time: x <- (x + m M) / 2^j with m = -x mod 2^j,
// exact since M = 1 mod 2^40, and below M since x < M and m < 2^j.  For
// one thread alone this chain of shifts and adds is shorter than the binary
// extended Euclid's up to 256 modular halvings and than the ~140 dependent
// multiplies of a^(M-2) (tools/air_probe.py k6, PERF.md).
F128_FN u128 inv(u128 a) {
    if (a == 0) return 0;
    const u128 m_ = modulus();
    int k = trailing_zeros(a);
    u128 u = m_, v = a >> k, r = 0, s = 1;
    while (u != v) {
        int t;
        if (u > v) {
            u -= v;
            t = trailing_zeros(u);
            u >>= t;
            r += s;
            s <<= t;
        } else {
            v -= u;
            t = trailing_zeros(v);
            v >>= t;
            s += r;
            r <<= t;
        }
        k += t;
    }
    u128 x = m_ - r;
    while (k > 0) {
        const int j = k < 32 ? k : 32;
        const u128 m = (0 - x) & (((u128)1 << j) - 1);
        // x + m M = x + m + m 2^128 - 45 m 2^40, as top 2^128 + lo
        const u128 t = x + m;
        const u128 d = (m * 45) << 40;
        const u128 lo = t - d;
        const u128 top = m + (t < x) - (lo > t);
        x = (top << (128 - j)) | (lo >> j);
        k -= j;
    }
    return x;
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
