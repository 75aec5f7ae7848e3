// K12 power_series: tables [c x^0 .. c x^(n-1)] for host ints x and c,
// any number of them in one launch.
//
// Replaces the JAX package's distaff_tpu/ops/tiles.py::_ps_tile,
// _ps_tiles_batched and power_series (one tile of x's powers times each
// tile's prefix x^(t TILE)), on distaff_tpu/math/field_jax.py::
// power_series_dev and _ps_scan (doubling scans).  Powers in the field are
// unique, so the output is the JAX package's bit for bit.
//
// Bound on this card: bytes (16 written an element against about one
// multiply); a proof's tables are a few hundred KB, so a launch is latency:
// the chain of dependent 128-bit multiplies from its start to its stores.
// The design:
// - One launch builds every table of a list: the kernel parameter holds a
//   descriptor a table (its factors' offset and count, its rows and the
//   offset of its first row), and the host uploads all the tables' factors,
//   c and the squarings x^(2^k) (k < bits of n - 1), in one copy.  A table
//   has a block for every kTile rows; a block finds its table from the
//   tables' first blocks.
// - Row i = b kTile + r of block b is c x^(b kTile) x^(32 (r >> 5))
//   x^(r & 31).  Warp 0 makes the 32 powers x^l and warp 1 the 32 powers
//   x^(32 l), each lane a product of the at most five squarings at l's
//   bits (a tree: three dependent multiplies).  Warp 1 also makes the
//   block's prefix c x^(b kTile): lane l holds the squaring x^(2^(10 + l))
//   where bit l of b is set (c in lane 31), and five shuffle steps multiply
//   the lanes together.  Each lane of warp 1 then keeps the prefix times
//   its x^(32 l), and a row is one multiply of that by x^(r & 31): seven
//   dependent multiplies from launch to store, in place of a thread's
//   prefix chain (up to ten) and ten doubling steps behind a barrier each.
// - Indices are 64-bit.
//
// This header compiles as plain C++ too: the tests run the kernel's phases
// a block at a time (warp 1's shuffle steps as the same products over an
// array of lanes) against the plain version and the JAX package's series.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace power_series {

using f128::u128;

constexpr int kLogTile = 10;
constexpr int kTile = 1 << kLogTile;      // rows a block
constexpr int kThreads = 256;
constexpr int kLanes = 32;                // x^l and x^(32 l) for l < 32
constexpr int kMaxFactors = 65;           // c and x^(2^k) for k < 64
constexpr int kMaxTables = 64;            // tables a launch

struct Table {
    long long factors;        // c, then x^(2^k) for k < count - 1, from this element on
    long long out;            // the table's first row
    long long n;              // rows: out[0, n)
    long long first_block;    // the launch's first block of this table
    int count;
};

struct Args {
    const uint4* factors;
    uint4* out;
    int tables;
    Table table[kMaxTables];
};

// the blocks of a table of n rows
F128_FN long long table_blocks(long long n) { return (n + kTile - 1) >> kLogTile; }

// a's tables k < tables (see distaff_power_series); returns the launch's
// blocks, or -1 for a list the kernel does not take
inline long long set_tables(Args& a, int tables, const long long* factor_offsets,
                            const int* counts, const long long* rows,
                            const long long* out_offsets) {
    if (tables < 1 || tables > kMaxTables) return -1;
    a.tables = tables;
    long long blocks = 0;
    for (int k = 0; k < tables; ++k) {
        if (rows[k] < 1 || counts[k] < 1 || counts[k] > kMaxFactors ||
            (counts[k] - 1 < 63 && rows[k] > (1LL << (counts[k] - 1))))
            return -1;
        a.table[k] = {factor_offsets[k], out_offsets[k], rows[k], blocks, counts[k]};
        blocks += table_blocks(rows[k]);
    }
    return blocks;
}

// The table of block `block`: the last whose first block is at most it.
F128_FN int table_of(const Args& a, long long block) {
    int t = 0;
    while (t + 1 < a.tables && a.table[t + 1].first_block <= block) ++t;
    return t;
}

// The squaring x^(2^k) of table t, or 1 where the table has none (its rows
// never need it).
F128_FN u128 squaring(const Args& a, const Table& t, int k) {
    return k + 1 < t.count ? f128::from_limbs(a.factors[t.factors + 1 + k]) : (u128)1;
}

// x^(e 2^shift) for e < 32: the squarings x^(2^(shift + k)) at e's set bits
// multiplied as a tree, three dependent multiplies deep.
F128_FN u128 power(const Args& a, const Table& t, int shift, int e) {
    u128 f[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) f[k] = (e >> k) & 1 ? squaring(a, t, shift + k) : (u128)1;
    return f128::mul(f128::mul(f128::mul(f[0], f[1]), f128::mul(f[2], f[3])), f[4]);
}

// Warp 1's lane l: its factor of the prefix c x^(b kTile) of block b of
// table t, the squaring x^(2^(kLogTile + l)) where bit l of b is set (b <
// 2^31) and c in lane 31.
F128_FN u128 prefix_factor(const Args& a, const Table& t, long long b, int lane) {
    if (lane == kLanes - 1) return f128::from_limbs(a.factors[t.factors]);
    return (b >> lane) & 1 ? squaring(a, t, kLogTile + lane) : (u128)1;
}

// The last phase, after warp 0 wrote low[l] = x^l and warp 1 high[l] = c
// x^(b kTile + 32 l): rows b kTile + r = high[r >> 5] low[r & 31].
F128_FN void store(const Args& a, const Table& t, long long b, const uint4* low,
                   const uint4* high, int tid) {
    const long long first = b << kLogTile;
    for (int r = tid; r < kTile && first + r < t.n; r += kThreads)
        a.out[t.out + first + r] = f128::to_limbs(
            f128::mul(f128::from_limbs(high[r >> 5]), f128::from_limbs(low[r & (kLanes - 1)])));
}

}  // namespace power_series
