// K9 fri_fold: one radix-4 FRI layer folded in one launch.
//
// Replaces the JAX package's distaff_tpu/ops/fri_jax.py::_fold_rows_impl
// (jitted as fold_rows, tiled as distaff_tpu/ops/tiles.py::_fold_tile and
// fold_rows) with the x0 and x0^-3 power series that distaff_tpu/stark/
// fri.py::reduce builds for it.  For each row i < q of a layer of 4q points
// (the column of the previous fold, or the composition at the first layer):
//
//   y_j = column[i + j q]                    (quartic::transpose, in place)
//   x_j = x0 I^j, x0 = w_L^i                 (I the primitive 4th root)
//   out[i] = sum_k y_k N_k / K_k x0^-3       N_k = prod_{j != k} (sx - x_j)
//
// the row's cubic through (x_j, y_j) evaluated at special_x sx in Lagrange
// form, whose denominators are x0^3 K_k with K_k = prod_{j != k} (I^k - I^j)
// global constants (fri_jax's module docstring).  The value at sx is unique,
// so the output is the JAX package's bit for bit.  The kernel evaluates the
// sum in a shorter form.  K_k is f'(I^k) for f = x^4 - 1, so 1/K_k = I^k / 4;
// and I^2 = -1 pairs the nodes, x_2 = -x0 and x_3 = -I x0, so with
// A = (sx - x0)(sx - x2) = sx^2 - x0^2 and B = (sx - x1)(sx - x3) = sx^2 + x0^2:
//
//   out[i] = x0^-3 / 4 (B (sx (y0 - y2) + x0 (y0 + y2))
//                       + A ((I sx) (y1 - y3) - x0 (y1 + y3)))
//
// Bound on this card: operations (11 multiplies with the two table
// lookups', 5 adds and 4 subtractions a row, against 80 bytes moved); at
// 2^19 rows ~0.012 ms.  The design:
// - No power series: x0 = w^(s i) and x0^-3 = w^(s ((4q - 3i) mod 4q)),
//   w_L = w^s of order 4q, from the small power tables of w that K1 keeps
//   for the LDE domain (tiles._store_factors; points.cuh's table_power), one
//   multiply each.  No inversion, no cube.
// - special_x, sx^2, I sx and 1/4 are kernel arguments, not device tensors.
// - One thread a row, a warp's lanes on consecutive i, so each of the four
//   reads is one coalesced 512-byte row a warp (streaming: the fold reads
//   the column once) and the store is coalesced.  Indices are 64-bit (the
//   first layer at 2^20 steps has 2^23 rows).
//
// This header compiles as plain C++ too: the tests run fold() a row at a
// time against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"
#include "points.cuh"

namespace fri_fold {

using f128::u128;

constexpr int kThreads = 256;

// special_x, its square, I special_x and 1/4: the host's 16 words
struct Constants {
    uint4 special_x, special_x2, i_special_x, quarter;
};

struct Args {
    const uint4* column;     // (4q,) the layer's evaluations
    long long q;             // rows: out[0, q)
    const uint4* lo;         // w^e = lo[e mod 2^log_lo] hi[e >> log_lo], e < 4q stride
    const uint4* hi;
    int log_lo;
    long long stride;        // w_L = w^stride
    Constants k;
    uint4* out;              // (q,)
};

// The exponent of w in x0^-3 = w_L^(-3i): stride ((4q - 3i) mod 4q)
F128_FN long long inverse_cube_exponent(const Args& a, long long i) {
    return i ? a.stride * (4 * a.q - 3 * i) : 0;
}

F128_FN void fold(const Args& a, long long i) {
    u128 y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
        y[j] = f128::from_limbs(points::load_stream(a.column + i + j * a.q));
    const u128 x0 = points::table_power(a.lo, a.hi, a.log_lo, a.stride * i);
    const u128 inv3 = points::table_power(a.lo, a.hi, a.log_lo, inverse_cube_exponent(a, i));
    const u128 x0_2 = f128::mul(x0, x0);
    const u128 sx2 = f128::from_limbs(a.k.special_x2);
    const u128 even = f128::add(
        f128::mul(f128::from_limbs(a.k.special_x), f128::sub(y[0], y[2])),
        f128::mul(x0, f128::add(y[0], y[2])));
    const u128 odd = f128::sub(
        f128::mul(f128::from_limbs(a.k.i_special_x), f128::sub(y[1], y[3])),
        f128::mul(x0, f128::add(y[1], y[3])));
    const u128 sum = f128::add(f128::mul(f128::add(sx2, x0_2), even),
                               f128::mul(f128::sub(sx2, x0_2), odd));
    a.out[i] = f128::to_limbs(f128::mul(f128::mul(sum, inv3), f128::from_limbs(a.k.quarter)));
}

F128_FN long long blocks(const Args& a) { return (a.q + kThreads - 1) / kThreads; }

}  // namespace fri_fold
