// K4's per-row evaluator (air_row.cuh) built for the host with g++, with a
// plain C interface: the CPU tests hold it against K4's plain version
// before any chip call, and its operation count gives K4's bound
// (ops/air_kernels.py: air_rows_host, air_ops_per_row, air_degrees_host).
// The evaluator is a template over the trace's depths; this library
// instantiates the geometries of AIR_TRIPLES, and its entry points return
// -1 for any other.

#define AIR_COUNT_OPS
#include "air_row.cuh"

#include <cstring>
#include <vector>

namespace air {
long long op_counts[3];
}

// (ctx, loop, stack) depths: those of the CPU tests' random domains, the
// bench program's (1, 0, 4), the golden program's (0, 0, 2) and the
// examples' (collatz (2, 1, 8), comparison (1, 0, 12), conditional
// (1, 0, 3), merkle (0, 0, 11), rangecheck (0, 0, 6))
#define AIR_TRIPLES(X) \
    X(0, 0, 1) X(0, 0, 2) X(1, 0, 4) X(1, 0, 8) X(1, 1, 8) X(16, 8, 32) \
    X(2, 1, 8) X(1, 0, 12) X(1, 0, 3) X(0, 0, 11) X(0, 0, 6)

namespace {

air::Inputs make_inputs(const void* trace, long long n, long long reg_stride,
                        long long row_stride, const void* dec_ark, const void* masks,
                        const void* stk_ark, int cycle, const void* mds, const void* cc,
                        const long long* incr, int groups, const void* x_lo, const void* x_hi,
                        int log_lo) {
    air::Inputs in;
    in.trace = (const uint4*)trace;
    in.n = n;
    in.reg_stride = reg_stride;
    in.row_stride = row_stride;
    in.dec_ark = (const uint4*)dec_ark;
    in.masks = (const uint4*)masks;
    in.stk_ark = (const uint4*)stk_ark;
    in.cycle = cycle;
    in.mds = (const uint4*)mds;
    in.cc = (const uint4*)cc;
    for (int g = 0; g < air::kMaxGroups; g++) in.incr[g] = g < groups ? incr[g] : 0;
    in.x_lo = (const uint4*)x_lo;
    in.x_hi = (const uint4*)x_hi;
    in.log_lo = log_lo;
    return in;
}

// the combined constraint at row j, both states read from the slice in place
template <int CTX, int LOOP, int STACK>
f128::u128 row(const air::Inputs& in, long long j) {
    const uint4* cur = in.trace + j * in.row_stride;
    const uint4* nxt = in.trace + (j + air::kStepRows) % in.n * in.row_stride;
    return air::eval_row<CTX, LOOP, STACK>(in, cur, nxt, in.reg_stride, j);
}

// the combined column at every row
template <int CTX, int LOOP, int STACK>
void rows(const air::Inputs& in, uint4* out) {
    for (long long j = 0; j < in.n; j++) out[j] = f128::to_limbs(row<CTX, LOOP, STACK>(in, j));
}

// field multiplies, adds and subtractions of one row: the count depends on
// the depths only, so one row of zeros gives it, counted with an x_hi table
// (each group's x^incr one multiply), as over a domain of more than 2^log_lo
// points
template <int CTX, int LOOP, int STACK>
void ops(long long* counts) {
    using L = air::Layout<CTX, LOOP, STACK>;
    const int regs = 15 + CTX + LOOP + STACK;
    std::vector<uint4> trace(regs * air::kStepRows), tables(8 + 3 + 12 + 104 + 2);
    std::vector<uint4> cc(2 * L::kCount);
    std::vector<long long> incr(L::kGroups, 1);
    std::memset(trace.data(), 0, trace.size() * sizeof(uint4));
    std::memset(tables.data(), 0, tables.size() * sizeof(uint4));
    std::memset(cc.data(), 0, cc.size() * sizeof(uint4));
    const air::Inputs in = make_inputs(trace.data(), air::kStepRows, air::kStepRows, 1,
                                       tables.data(), tables.data() + 8, tables.data() + 11, 1,
                                       tables.data() + 23, cc.data(), incr.data(), L::kGroups,
                                       tables.data() + 127, tables.data() + 128, 0);
    air::op_counts[0] = air::op_counts[1] = air::op_counts[2] = 0;
    row<CTX, LOOP, STACK>(in, 0);
    for (int k = 0; k < 3; k++) counts[k] = air::op_counts[k];
}

template <int CTX, int LOOP, int STACK>
int layout(int* degrees) {
    using L = air::Layout<CTX, LOOP, STACK>;
    for (int c = 0; c < L::kCount; c++) degrees[c] = L::degree(c);
    return L::kCount;
}

bool is(int ctx, int loop, int stack, int c, int l, int s) {
    return ctx == c && loop == l && stack == s;
}

}  // namespace

extern "C" {

// the geometries built in: triples[3 k .. 3 k + 3) for k < the count returned
int distaff_air_host_triples(int* triples) {
    int k = 0;
#define AIR_LIST(c, l, s) triples[k++] = c, triples[k++] = l, triples[k++] = s;
    AIR_TRIPLES(AIR_LIST)
#undef AIR_LIST
    return k / 3;
}

// the combined column at every row, arguments as distaff_air_transition's
int distaff_air_rows_host(int ctx, int loop, int stack, const void* trace, long long n,
                          long long reg_stride, long long row_stride, const void* dec_ark,
                          const void* masks, const void* stk_ark, int cycle, const void* mds,
                          const void* cc, const long long* incr, int groups, const void* x_lo,
                          const void* x_hi, int log_lo, void* out) {
    const air::Inputs in = make_inputs(trace, n, reg_stride, row_stride, dec_ark, masks, stk_ark,
                                       cycle, mds, cc, incr, groups, x_lo, x_hi, log_lo);
#define AIR_ROWS(c, l, s) \
    if (is(ctx, loop, stack, c, l, s)) return rows<c, l, s>(in, (uint4*)out), 0;
    AIR_TRIPLES(AIR_ROWS)
#undef AIR_ROWS
    return -1;
}

// counts[0..3): field multiplies, adds and subtractions of one row
int distaff_air_ops_host(int ctx, int loop, int stack, long long* counts) {
#define AIR_OPS(c, l, s) \
    if (is(ctx, loop, stack, c, l, s)) return ops<c, l, s>(counts), 0;
    AIR_TRIPLES(AIR_OPS)
#undef AIR_OPS
    return -1;
}

// the constraint count, with each constraint's degree in degrees[]
int distaff_air_layout_host(int ctx, int loop, int stack, int* degrees) {
#define AIR_LAYOUT(c, l, s) \
    if (is(ctx, loop, stack, c, l, s)) return layout<c, l, s>(degrees);
    AIR_TRIPLES(AIR_LAYOUT)
#undef AIR_LAYOUT
    return -1;
}

}  // extern "C"
