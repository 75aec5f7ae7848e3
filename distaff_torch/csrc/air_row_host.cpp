// K4's per-row evaluator (air_row.cuh) built for the host with g++, with a
// plain C interface: the CPU tests hold it against K4's plain version
// before any chip call, and its operation count gives K4's bound
// (ops/air_kernels.py: air_rows_host, air_ops_per_row).

#define AIR_COUNT_OPS
#include "air_row.cuh"

#include <cstring>
#include <vector>

namespace air {
long long op_counts[3];
}

namespace {

air::Inputs make_inputs(const void* trace, long long n, long long reg_stride,
                        long long row_stride, int ctx_depth, int loop_depth, int stack_depth,
                        const void* dec_ark, const void* masks, const void* stk_ark, int cycle,
                        const void* mds, const void* cc, const void* group_idx,
                        const void* group_size, int n_groups, const void* xp) {
    air::Inputs in;
    in.trace = (const uint4*)trace;
    in.n = n;
    in.reg_stride = reg_stride;
    in.row_stride = row_stride;
    in.ctx_depth = ctx_depth;
    in.loop_depth = loop_depth;
    in.stack_depth = stack_depth;
    in.dec_ark = (const uint4*)dec_ark;
    in.masks = (const uint4*)masks;
    in.stk_ark = (const uint4*)stk_ark;
    in.cycle = cycle;
    in.mds = (const uint4*)mds;
    in.cc = (const uint4*)cc;
    in.group_idx = (const int32_t*)group_idx;
    in.group_size = (const int32_t*)group_size;
    in.n_groups = n_groups;
    in.xp = (const uint4*)xp;
    return in;
}

}  // namespace

extern "C" {

// the combined column at every row, arguments as distaff_air_transition's
void distaff_air_rows_host(const void* trace, long long n, long long reg_stride,
                           long long row_stride, int ctx_depth, int loop_depth,
                           int stack_depth, const void* dec_ark, const void* masks,
                           const void* stk_ark, int cycle, const void* mds, const void* cc,
                           const void* group_idx, const void* group_size, int n_groups,
                           const void* xp, void* out) {
    const air::Inputs in = make_inputs(trace, n, reg_stride, row_stride, ctx_depth, loop_depth,
                                       stack_depth, dec_ark, masks, stk_ark, cycle, mds, cc,
                                       group_idx, group_size, n_groups, xp);
    uint4* o = (uint4*)out;
    for (long long j = 0; j < n; j++) o[j] = f128::to_limbs(air::eval_row(in, j));
}

// field multiplies, adds and subtractions of one row (counts[0..3)); the
// count depends on the depths and the groups only, so one row of zeros
// gives it
void distaff_air_ops_host(int ctx_depth, int loop_depth, int stack_depth, int n_groups,
                          const void* group_idx, const void* group_size, long long* counts) {
    const int regs = 15 + ctx_depth + loop_depth + stack_depth;
    const int cycle = 1;
    std::vector<uint4> trace(regs * air::kStepRows), tables(8 + 3 + 12 + 104);
    std::vector<uint4> cc(2 * air::kMaxConstraints), xp(n_groups * air::kStepRows);
    std::memset(trace.data(), 0, trace.size() * sizeof(uint4));
    std::memset(tables.data(), 0, tables.size() * sizeof(uint4));
    std::memset(cc.data(), 0, cc.size() * sizeof(uint4));
    std::memset(xp.data(), 0, xp.size() * sizeof(uint4));
    const air::Inputs in = make_inputs(
        trace.data(), air::kStepRows, air::kStepRows, 1, ctx_depth, loop_depth, stack_depth,
        tables.data(), tables.data() + 8, tables.data() + 11, cycle, tables.data() + 23,
        cc.data(), group_idx, group_size, n_groups, xp.data());
    air::op_counts[0] = air::op_counts[1] = air::op_counts[2] = 0;
    air::eval_row(in, 0);
    for (int k = 0; k < 3; k++) counts[k] = air::op_counts[k];
}

}  // extern "C"
