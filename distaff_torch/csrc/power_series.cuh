// K12 power_series: [c x^0 .. c x^(n-1)] in one launch, for host ints x
// and c.
//
// Replaces the JAX package's distaff_tpu/ops/tiles.py::_ps_tile,
// _ps_tiles_batched and power_series (one tile of x's powers times each
// tile's prefix x^(t TILE)), on distaff_tpu/math/field_jax.py::
// power_series_dev and _ps_scan (doubling scans).  Powers in the field are
// unique, so the output is the JAX package's bit for bit.
//
// Bound on this card: bytes (16 written an element against about two
// multiplies).  The design, _ps_tiles_batched with its prefixes made on the
// card:
// - The host uploads c and the squarings x^(2^k) (k < bits of n - 1) as one
//   tensor: no launch multiplies one element by another.
// - Each block of kTile rows builds B = [x^0 .. x^(kTile-1)] in shared
//   memory in log2(kTile) doubling steps, B[i + 2^k] = B[i] x^(2^k): one
//   multiply an element.
// - Thread 0 multiplies the block's prefix c x^(b kTile) out of the
//   squarings of k >= log2(kTile), the bits of b kTile.
// - Row b kTile + i stores prefix B[i]: one more multiply an element.
// - Indices are 64-bit.
//
// This header compiles as plain C++ too: the tests run the kernel's phases
// a block at a time (every thread of a phase before the next phase)
// against the plain version.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace power_series {

using f128::u128;

constexpr int kLogTile = 10;
constexpr int kTile = 1 << kLogTile;      // rows a block
constexpr int kThreads = 256;
constexpr int kMaxFactors = 65;           // c and x^(2^k) for k < 64

struct Args {
    const uint4* factors;    // c, then x^(2^k) for k < count - 1
    int count;
    long long n;             // rows: out[0, n)
    uint4* out;
};

// The rows of B that a block builds: kTile, or n where that is fewer.
F128_FN int table_rows(const Args& a) { return a.n < kTile ? (int)a.n : kTile; }

// Phase 0: B[0] = 1, and thread 0 the block's prefix c x^(block kTile).
F128_FN void start(const Args& a, uint4* table, uint4* prefix, long long block, int tid) {
    if (tid != 0) return;
    table[0] = f128::to_limbs(1);
    u128 p = f128::from_limbs(a.factors[0]);
    const long long first = block << kLogTile;
    for (int k = kLogTile; k < a.count - 1; ++k)
        if ((first >> k) & 1) p = f128::mul(p, f128::from_limbs(a.factors[1 + k]));
    *prefix = f128::to_limbs(p);
}

// Doubling step k (2^k < table_rows): B[i] = B[i - 2^k] x^(2^k) for
// 2^k <= i < 2^(k+1).
F128_FN void double_step(const Args& a, uint4* table, int k, int tid) {
    const int half = 1 << k, stop = table_rows(a) < 2 * half ? table_rows(a) : 2 * half;
    const u128 x = f128::from_limbs(a.factors[1 + k]);
    for (int i = half + tid; i < stop; i += kThreads)
        table[i] = f128::to_limbs(f128::mul(f128::from_limbs(table[i - half]), x));
}

// The last phase: rows block kTile + i = prefix B[i].
F128_FN void store(const Args& a, const uint4* table, const uint4* prefix, long long block,
                   int tid) {
    const u128 p = f128::from_limbs(*prefix);
    const long long first = block << kLogTile;
    for (int i = tid; i < kTile && first + i < a.n; i += kThreads)
        a.out[first + i] = f128::to_limbs(f128::mul(p, f128::from_limbs(table[i])));
}

// The doubling steps a block runs: ceil(log2(table_rows)).
F128_FN int steps(const Args& a) {
    int k = 0;
    while ((1 << k) < table_rows(a)) ++k;
    return k;
}

F128_FN long long blocks(const Args& a) { return (a.n + kTile - 1) >> kLogTile; }

}  // namespace power_series
