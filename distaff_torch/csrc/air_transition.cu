// K4 air_transition: the combined transition constraint over the whole
// evaluation domain, one thread per row.
//
// Replaces the fused XLA kernel of the JAX package,
// distaff_tpu/stark/constraints/device_eval.py::_transition_kernel, which
// traced the polymorphic AIR over device columns.  Here each thread runs the
// scalar evaluator of air_row.cuh (a port of native/air.cpp) at its row j:
// it reads registers j and (j + 8) mod n of the stride-(ext/8) LDE slice in
// place through the slice's strides, evaluates the decoder and stack
// constraints, folds them with the transcript's coefficient pairs and the
// degree-adjustment series, and writes one element.  The trace-step rows
// (j % 8 == 0) other than the last step's, whose wrap-around transition is
// legitimately nonzero, add one to `bad` where the result is nonzero.
//
// Bound on this card: operations.  A row does a few hundred 128-bit field
// multiplies (air_kernels.air_ops_per_row counts them from this code)
// against 16 bytes per register and per degree group read and 16 written.
// The two trace states, the op flags and the ~60 constraint values of a row
// exceed the register file and spill to local memory; the stack arrays are
// sized by the maximum depths (ctx 16, loop 8, stack 32) and indexed at run
// time.  Transcript-dependent inputs (coefficients, groups, series) and the
// periodic ARK/mask tables arrive as device tensors with each launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "air_row.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
air_transition_kernel(air::Inputs in, uint4* __restrict__ out, int* __restrict__ bad) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= in.n) return;
    const f128::u128 v = air::eval_row(in, j);
    out[j] = f128::to_limbs(v);
    if (v != 0 && j % air::kStepRows == 0 && j != in.n - air::kStepRows) atomicAdd(bad, 1);
}

}  // namespace

// trace: the (R, n) slice, element strides reg_stride and row_stride; the
// tables as described in air_row.cuh::Inputs; out: (n, 4) limbs; bad: one
// int32 counter, added to.
extern "C" int distaff_air_transition(
    const void* trace, long long n, long long reg_stride, long long row_stride,
    int ctx_depth, int loop_depth, int stack_depth,
    const void* dec_ark, const void* masks, const void* stk_ark, int cycle, const void* mds,
    const void* cc, const void* group_idx, const void* group_size, int n_groups,
    const void* xp, void* out, void* bad, void* stream) {
    if (n < air::kStepRows || cycle < 1 || n_groups < 1 || ctx_depth < 0 ||
        ctx_depth > air::kMaxCtx || loop_depth < 0 || loop_depth > air::kMaxLoop ||
        stack_depth < 0 || stack_depth > air::kMaxStack)
        return (int)cudaErrorInvalidValue;
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
    const long long blocks = (n + kThreads - 1) / kThreads;
    air_transition_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        in, (uint4*)out, (int*)bad);
    return (int)cudaGetLastError();
}
